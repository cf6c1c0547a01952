"""Data parallelism of the port against the JAX package's mesh paths.

Two gloo ranks on the CPU (``tests/torch_dp_ranks.py``, started once per
test session with ``spawn``, so they import this module's JAX nowhere) take:
  * one flagship train step (N=192, global B=4, 2 per rank; K=12, P=24,
    instance grid 8) with the instance head in fp32 and in bf16, against
    ``make_train_step(..., mesh)`` over a 2-device mesh of the conftest's
    virtual CPU devices, from the same numpy weights, batch and grid shift
    (``uniform(fold_in(key, 0), (2, 3))``, the key every JAX shard gets);
  * one scene train step (``tests/test_torch_scene_train.py``'s size and
    weights, global B=2) against ``make_scene_train_step(..., mesh)``;
  * the data-parallel ``Trainer`` and ``SceneTrainer``: their per-rank
    synthetic streams against the JAX trainers' ``_train_batches`` as rank
    r of 2, the rank-strided evaluation merged against one process's, and a
    2-step epoch;
  * ``collect_results``, ``AverageMeter`` and the bench under
    ``GCA_BENCH_MESH=2``.
The JAX step's optimizer keeps the gradient it was handed
(``tests/test_torch_scene_train.py::_keep_grads``), so one compiled mesh
step gives the losses, the averaged gradient, the new parameters and the
new batch statistics.

Tolerances, those of ``tests/test_torch_train_step.py`` and
``tests/test_torch_scene_train.py``: losses rtol 1e-5, atol 1e-6; the bf16
instance head's ``inst_loss`` (and the scene's instance losses) and its
statistics 3e-2; with the fp32 head the new statistics rtol 1e-5, atol
1e-6.  The group's gradient is the mean of what each rank's chunk gives on
one device, bit for bit, and is held against JAX's entry by entry at rtol
1e-4, atol 1e-5 of the largest entry: every tensor with the fp32 head; with
a bf16 instance head (the flagship's bf16 case, the scene model) the tensors
it does not reach (those whose gradient the port's fp32 and bf16 heads give
alike, bit for bit), and the whole by cosine >= 0.9 and by a gap to JAX's
no wider than 1.5 times the port's own bf16-against-fp32 gap, as the
single-device test holds the gradient of ``inst_loss``.  New parameters:
Adam's first step moves a weight by ``lr * g / (|g| + 1e-8)``; where the
JAX gradient exceeds 1e-5 in a tensor held entry by entry, a 10% difference
of ``g`` moves that by under 1e-7 and only a sign decides, so those weights
are held at rtol 1e-5, atol 1e-6 (over 90% of the entries with the fp32
head); every weight within 2 lr (1e-6 beside for rounding).  The ranks'
parameters, gradients and metrics are bit for bit equal.  The flagship
weights are filled from numpy seed 4: with seeds 0, 3 and 7 the input holds
a decision within the frameworks' rounding (a ReLU's input near 0 or a max
over neighbours near a tie; seeds 3, 5 and 7 also move the port's own fp32
gradient against float64 past the tolerance) that moves a few hundred
encoder gradient entries out of it.  The merged evaluation equals one
process's (sums in another order: rtol 1e-9).

Data-parallel serving on ``["cpu", "cpu"]`` (threads in this process)
equals the single-device port exactly, with a proposal cap that binds
across the chunks (and, for the scene family, a ``min_npoint`` that one
chunk alone would judge otherwise), and the flagship equals the JAX
``Predictor`` over a 2-device mesh at ``tests/test_torch_predictor.py``'s
tolerances.
"""

import csv
import dataclasses
import functools
import io
import itertools
import json
import multiprocessing
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gcanet_tpu.models.primitive_net as jpn
import gcanet_tpu.models.softgroup_scene as jsg
import gcanet_tpu.parallel.dist as jdist
import gcanet_tpu_torch.models.softgroup_scene as tsg
from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.data.synthetic import synth_batch as jsynth_batch
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.serve import Predictor as JPredictor
from gcanet_tpu.train import scene_step as jscene_step
from gcanet_tpu.train import step as jstep
from gcanet_tpu.train.scene_trainer import SceneTrainer as JSceneTrainer
from gcanet_tpu.train.trainer import Trainer as JTrainer
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     scene_grouping_defaults)
from gcanet_tpu_torch.data.synthetic import synth_clouds, synth_scene_batch
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.ops import grouping as tgrouping
from gcanet_tpu_torch.parallel import dist as pdist
from gcanet_tpu_torch import serve as serve_mod
from gcanet_tpu_torch.serve import Predictor, ScenePredictor
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.train.scene_trainer import SceneTrainer
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests import test_torch_scene_train as scene_tt
from tests import torch_dp_ranks
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

WORLD = 2
N, B = 192, 4
TINY = dict(num_points=N, batch_size=B, nn_nb=12, offset_knn=6, offset_keypoints=24,
            max_instances=16, knn_impl="xla")
GROUP = dict(radius=0.1, min_npoint=5, cc_max_iters=32, class_numpoint_mean=(-1.0,) * 7,
             similarity_threshold_inst=0.9)
HEAD = dict(grid_size=8, max_proposals=24)
LOSS = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
STATS = dict(rtol=1e-5, atol=1e-6)
MERGED = dict(rtol=1e-9, atol=1e-12)
PARAMS_ATOL = 1e-6
FIRM_GRAD = 1e-5            # 1000 Adam eps: a weight's step is lr within 0.1%
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-5
STEP_WEIGHTS_SEED = 4
SCENE_GRID, SCENE_CH = scene_tt.GRID, scene_tt.CH
FP32 = dict(rtol=1e-4, atol=1e-5)          # tests/test_torch_predictor.py
# the JAX mesh Predictor's clouds: seeds 0, 1 and 3 each hold a cloud with a
# feature-space kNN near-tie, where the type scores differ by up to 3e-4
# between the frameworks (neighbour-set flips; every integer output equal)
SERVE_SEED = 2


# tests/test_torch_predictor.py's serving size: a kept instance needs 150 points
SERVE = dict(num_points=1024, nn_nb=12, nn_nb_inner=8, offset_knn=6, offset_keypoints=24,
             knn_impl="xla")
SERVE_GROUP = dict(radius=0.05, similarity_threshold_inst=0.9,
                   class_numpoint_mean=(-1.0,) * 7, min_npoint=20)


def _serving_cfg(p, **kw):
    return Config(**SERVE, **kw, grouping=GroupingConfig(**SERVE_GROUP),
                  instance_head=InstanceHeadConfig(grid_size=8, max_proposals=p))


def _jcfg(**kw):
    return JConfig(**dict(TINY, **kw), grouping=JGroupingConfig(**GROUP),
                   instance_head=JIHConfig(**HEAD))


def _tcfg(**kw):
    return Config(**dict(TINY, **kw), grouping=GroupingConfig(**GROUP),
                  instance_head=InstanceHeadConfig(**HEAD))


def _flagship_weights(seed, serving):
    """Flax trees of the tiny flagship (shapes by ``eval_shape``, nothing
    compiled) filled from a numpy seed, the offset head's kernel x0.05 (small,
    live offsets); for serving also +10 on the instance head's class-0 and
    mask biases, so instances pass its thresholds
    (``tests/test_torch_predictor.py``'s pushes)."""
    z = jnp.zeros((1, N, 3))
    shapes = jax.eval_shape(lambda r: jpn.PrimitiveNet(_jcfg()).init(
        {"params": r}, z, z, train=True, rng=r), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    params["OffsetPredModule_0"]["Dense_0"]["kernel"] *= 0.05
    if serving:
        params["InstanceHead_0"]["Dense_0"]["bias"][0] += 10.0
        params["InstanceHead_0"]["MLP_0"]["Dense_1"]["bias"] += 10.0
    return params, stats


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _lower_mesh_step(make_step, params, stats, batch, key):
    """A JAX mesh step traced here (the flagship's head dtype is a module
    global while it traces), returned as a function that compiles and runs
    it: ``(new params, new statistics, the averaged gradient, metrics)``."""
    tx = scene_tt._keep_grads(jstep.make_optimizer(_jcfg()))
    state = jstep.TrainState(params, stats, tx.init(params), jnp.zeros((), jnp.int32))
    lowered = make_step(tx, _mesh()).lower(state, batch, key)

    def run():
        new, metrics = lowered.compile()(state, batch, key)
        return jax.tree.map(np.asarray, (new.params, new.batch_stats, new.opt_state[1],
                                         metrics))
    return run


def _scene_trainer_cfg(log_dir, **kw):
    _, cfg = scene_tt._cfgs()
    return cfg.replace(model_dict="softgroup.model.softgroup", max_instances=8,
                       log_dir=str(log_dir), data_path=str(log_dir / "none"), **kw)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    key = jax.random.PRNGKey(3)
    r1 = np.array(jax.random.uniform(jax.random.fold_in(key, 0), (2, 3)))
    params, stats = _flagship_weights(seed=STEP_WEIGHTS_SEED, serving=False)
    serve_params, serve_stats = _flagship_weights(seed=0, serving=True)
    batch = {k: v for k, v in jsynth_batch(_jcfg(), B, seed=0).items() if k != "index"}
    s_params, s_stats = scene_tt._weights(seed=0, zero_offsets=True)
    s_batch = scene_tt._batch(seed=1)
    return types.SimpleNamespace(
        clouds=synth_clouds(_serving_cfg(24), B, seed=SERVE_SEED), root=root, key=key, r1=r1, params=params, stats=stats, batch=batch,
        state=state_dict_from_jax(params, stats), serve_params=serve_params,
        serve_stats=serve_stats, serve_state=state_dict_from_jax(serve_params, serve_stats),
        s_params=s_params, s_stats=s_stats, s_batch=s_batch,
        s_state=state_dict_from_jax(s_params, s_stats, family="scene"))


PARTS = [[{"scan": "a", "miou": 0.5}], [("b", 1, 2), ("c", 3, 4)]]
METER = [[(1.0, 2), (3.0, 1)], [(5.0, 4)]]
BENCH_ENV = {"GCA_BENCH_BATCH": "2", "GCA_BENCH_POINTS": "128", "GCA_BENCH_PROPOSALS": "8",
             "GCA_BENCH_NN": "16", "GCA_BENCH_ITERS": "1", "GCA_BENCH_MESH": "2"}


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """The two ranks' results, one dict per rank: started, run and collected
    once per session (``tests/torch_once.py``)."""
    return once(tmp_path_factory, "parallel_ranks",
                lambda: _run_ranks(request.getfixturevalue("inputs")))


def _run_ranks(x):
    cfg = _tcfg(mesh_shape="2")
    _, s_cfg = scene_tt._cfgs()
    jobs = [
        ("gathers", "gathers", dict(parts=PARTS, meter_values=METER)),
        ("fp32", "flagship_step", dict(cfg=cfg, state=x.state, batch=x.batch, r1=x.r1,
                                       head_bf16=False)),
        ("bf16", "flagship_step", dict(cfg=cfg, state=x.state, batch=x.batch, r1=x.r1,
                                       head_bf16=True)),
        ("scene", "scene_step", dict(cfg=s_cfg.replace(mesh_shape="2"), state=x.s_state,
                                     batch=x.s_batch, r1=x.r1, grid=SCENE_GRID,
                                     channels=SCENE_CH)),
        ("trainer", "trainer", dict(cfg=cfg.replace(log_dir=str(x.root / "dp"),
                                                    data_path=str(x.root / "none")),
                                    state=x.state)),
        ("scene_trainer", "trainer", dict(
            cfg=_scene_trainer_cfg(x.root / "scene_dp", mesh_shape="2"), state=x.s_state,
            scene=True, grid=SCENE_GRID, channels=SCENE_CH)),
        ("cli", "cli", dict(argv=["--log_dir", str(x.root / "cli"), "--mesh_shape", "2",
                                  "--num_points", "192", "--batch_size", "2", "--nn_nb", "12",
                                  "--max_instances", "8", "--max_proposals", "8",
                                  "--max_epoch", "1"])),
        ("bench", "bench", dict(env=BENCH_ENV)),
    ]
    jobs_path = x.root / "jobs.pt"
    torch.save(jobs, jobs_path)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=torch_dp_ranks.main,
                         args=(r, WORLD, port, str(jobs_path), queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for r in range(WORLD):
        assert isinstance(got[r], dict), f"rank {r} failed:\n{got[r]}"
    return [got[r] for r in range(WORLD)]


def _mesh_step_ref(x, head_fp32):
    """``make_train_step`` over the 2-device mesh, the head in fp32 or bf16."""
    with pytest.MonkeyPatch.context() as head:
        if head_fp32:
            head.setattr(jpn, "InstanceHead", functools.partial(
                JInstanceHead, compute_bf16=False, name="InstanceHead_0"))
        run = _lower_mesh_step(
            lambda tx, mesh: jstep.make_train_step(_jcfg(), jpn.PrimitiveNet(_jcfg()), tx, mesh),
            x.params, x.stats, x.batch, x.key)
    return run()


def _scene_mesh_step_ref(x):
    jcfg = scene_tt._cfgs()[0]
    return _lower_mesh_step(
        lambda tx, mesh: jscene_step.make_scene_train_step(
            jcfg, jsg.SoftGroupNet(jcfg, scene_grid=SCENE_GRID, channels=SCENE_CH), tx, mesh),
        x.s_params, x.s_stats, x.s_batch, x.key)()


def _eval_ref(x, family):
    """One process's evaluation, for the merged one's."""
    if family == "abc":
        return _eval_one_process(
            _tcfg(log_dir=str(x.root / "one"), data_path=str(x.root / "none")), x.state, Trainer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsg, "SoftGroupNet", functools.partial(
            tsg.SoftGroupNet, scene_grid=SCENE_GRID, channels=SCENE_CH))
        return _eval_one_process(_scene_trainer_cfg(x.root / "scene_one"), x.s_state,
                                 SceneTrainer)


def _predictor_ref(x):
    """The JAX ``Predictor`` over a 2-device mesh, its state the serving
    weights, on the serving clouds."""
    with pytest.MonkeyPatch.context() as init:
        init.setattr(jstep, "init_state", lambda cfg, model, tx, rng: jstep.TrainState(
            x.serve_params, x.serve_stats, tx.init(x.serve_params), jnp.asarray(0)))
        jpred = JPredictor(JConfig(**SERVE, mesh_shape="2",
                                   grouping=JGroupingConfig(**SERVE_GROUP),
                                   instance_head=JIHConfig(grid_size=8, max_proposals=24)))
    assert jpred.mesh is not None and jpred.mesh.devices.size == WORLD
    return jpred.predict_batch(*x.clouds)


REFS = {"fp32": functools.partial(_mesh_step_ref, head_fp32=True),
        "bf16": functools.partial(_mesh_step_ref, head_fp32=False),
        "scene": _scene_mesh_step_ref,
        "eval_abc": functools.partial(_eval_ref, family="abc"),
        "eval_scene": functools.partial(_eval_ref, family="scene"),
        "predictor": _predictor_ref}


@pytest.fixture(scope="module")
def refs(inputs, tmp_path_factory):
    """``refs(name)``: a reference of ``REFS`` (the JAX mesh steps, one
    process's evaluations, the JAX mesh ``Predictor``), each built once per
    session on first use: one worker builds each, and two workers may
    build two different ones at the same time."""
    return lambda name: once(tmp_path_factory, f"parallel_{name}",
                             lambda: REFS[name](inputs))


def test_ranks_import_no_jax(ranks):
    for r in ranks:
        assert r["modules"] == []


def test_dist_helpers_match_jax(ranks):
    got = [r["gathers"] for r in ranks]
    rows = [jdist._encode_part(p) for p in PARTS]
    want = jdist._decode_rows([np.pad(e, (0, max(map(len, rows)) - len(e))) for e in rows],
                              [len(e) for e in rows])
    assert want == PARTS[0] + PARTS[1]
    total = sum(v * n for part in METER for v, n in part) / sum(n for part in METER
                                                                for _, n in part)
    for rank, g in enumerate(got):
        assert g["collected"] == want
        assert g["info"] == (rank, WORLD) and g["main"] == (rank == 0)
        reduced, local = g["meters"][True], g["meters"][False]
        assert reduced == (pytest.approx(np.mean([p[-1][0] for p in METER])),
                           pytest.approx(total))
        mine = METER[rank]
        assert local == (mine[-1][0], sum(v * n for v, n in mine) / sum(n for _, n in mine))
    for b, r, w in ((8, 1, 4), (6, 0, 3), (4, 1, 2)):
        assert pdist.shard_bounds(b, r, w) == jdist.shard_bounds(b, r, w)
    with pytest.raises(ValueError):
        pdist.shard_bounds(6, 0, 4)


def test_rebase_local_batch_matches_jax():
    """Both families: a rank's own collated chunk rebased equals JAX's
    rebase; ``local_shard`` cuts a rank's chunk from a global batch with the
    ids of its own instance table, as a rank's own collation has them, and
    ``rebase_local_batch`` takes it back to the global batch's rows."""
    scene_cfg = scene_tt._cfgs()[1]
    for cfg, make in ((_tcfg(), jsynth_batch), (scene_cfg, synth_scene_batch)):
        local = {k: v for k, v in make(cfg, 2, seed=5).items() if k != "index"}
        for rank in range(WORLD):
            got = tstep.rebase_local_batch(local, rank, WORLD, cfg.max_instances)
            want = jstep.rebase_local_batch(local, rank, WORLD, cfg.max_instances)
            np.testing.assert_array_equal(got["I_gt_global"], want["I_gt_global"])
        ig = local["I_gt_global"]
        assert (ig >= 0).any() and ig.max() < 2 * cfg.max_instances
        shifted = tstep.rebase_local_batch(local, 1, WORLD, cfg.max_instances)["I_gt_global"]
        np.testing.assert_array_equal(shifted[ig >= 0], ig[ig >= 0] + 2 * cfg.max_instances)

        glob = {k: v for k, v in make(cfg, 2 * WORLD, seed=7).items() if k != "index"}
        assert glob["I_gt_global"].max() >= 2 * cfg.max_instances
        for rank in range(WORLD):
            part = pdist.local_shard(glob, rank, WORLD)
            lo, hi = pdist.shard_bounds(len(glob["I_gt_global"]), rank, WORLD)
            assert part["I_gt_global"].dtype == glob["I_gt_global"].dtype
            assert part["I_gt_global"].max() < 2 * cfg.max_instances
            back = tstep.rebase_local_batch(part, rank, WORLD, cfg.max_instances)
            np.testing.assert_array_equal(back["I_gt_global"], glob["I_gt_global"][lo:hi])
            for k in glob:
                if k != "I_gt_global":
                    np.testing.assert_array_equal(part[k], glob[k][slice(*pdist.shard_bounds(
                        len(glob[k]), rank, WORLD))], err_msg=k)


def _grads_dict(tree, family="flagship"):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, None, family=family).items()}


def _cosine(got, want):
    g = np.concatenate([got[k].ravel() for k in want])
    w = np.concatenate([want[k].ravel() for k in want])
    return float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))


def _mean(results, key):
    """The mean over the ranks of each rank's ``key`` gradients, as the
    group takes it (float32, summed in rank order)."""
    return {k: ((torch.from_numpy(results[0][key][k]) + torch.from_numpy(results[1][key][k]))
                / WORLD).numpy() for k in results[0][key]}


def _is_mean_of_own_gradients(results):
    """JAX's ``pmean``: the group's gradient is the mean of the gradient
    each rank's chunk gives on one device, bit for bit."""
    own = _mean(results, "own_grads")
    for k, g in results[0]["grads"].items():
        np.testing.assert_array_equal(g, own[k], err_msg=k)


def _ranks_agree(results):
    a, b = results
    assert a["digest"] == b["digest"], "the ranks' parameters differ"
    for k in a["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k], err_msg=k)
    for k in a["metrics"]:
        np.testing.assert_array_equal(a["metrics"][k], b["metrics"][k], err_msg=k)


def _check_gradient(got, want, port_fp32_head=None):
    """The group's gradient against JAX's (module docstring): every tensor
    entry by entry, or with a bf16 head (``port_fp32_head``: the port's
    gradient of the same step with the head in fp32) the tensors the head
    does not reach, and the whole by cosine and by its gap.  Returns the
    names held entry by entry."""
    assert set(got) == set(want)
    floor = GRAD_ATOL_SHARE * max(np.abs(w).max() for w in want.values())
    held = [k for k in want
            if port_fp32_head is None or np.array_equal(got[k], port_fp32_head[k])]
    for k in held:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=floor, err_msg=k)
    if port_fp32_head is not None:
        assert 0 < len(held) < len(want)
        assert _cosine(got, want) >= scene_tt.MIN_COSINE
        flat = lambda d: np.concatenate([d[k].ravel() for k in want])   # noqa: E731
        g, w, own = flat(got), flat(want), flat(port_fp32_head)
        assert np.linalg.norm(g - w) <= 1.5 * np.linalg.norm(g - own)
    return held


def _check_new_params(got, want, want_grads, held, lr, bf16_stats):
    """New statistics at ``STATS`` (``BF16`` for ``bf16_stats(name)``); new
    weights within 2 lr, and in the ``held`` tensors at rtol 1e-5, atol
    1e-6 where JAX's gradient exceeds ``FIRM_GRAD``.  Returns the share of
    the held tensors' entries held so."""
    firm_count = held_total = 0
    for k, w in want.items():
        g, w = got[k], w.numpy()
        if "running" in k:
            np.testing.assert_allclose(g, w, err_msg=k,
                                       **(BF16 if bf16_stats(k) else STATS))
            continue
        assert np.abs(g - w).max() <= 2 * lr + PARAMS_ATOL, k
        if k in held:
            firm = np.abs(want_grads[k]) > FIRM_GRAD
            np.testing.assert_allclose(g[firm], w[firm], err_msg=k, rtol=1e-5,
                                       atol=PARAMS_ATOL)
            firm_count, held_total = firm_count + firm.sum(), held_total + firm.size
    return firm_count / held_total


@pytest.mark.parametrize("head", ["fp32", "bf16"])
def test_flagship_step_matches_jax_mesh(ranks, refs, head):
    results = [r[head] for r in ranks]
    j_params, j_stats, j_grads, j_metrics = refs(head)
    _ranks_agree(results)
    _is_mean_of_own_gradients(results)
    got = results[0]
    assert j_metrics["num_pos"] > 0 and j_metrics["inst_loss"] > 0, "no positive proposal"
    assert set(got["metrics"]) == set(j_metrics)
    for k, w in j_metrics.items():
        tol = BF16 if head == "bf16" and k in ("inst_loss", "total_loss") else LOSS
        np.testing.assert_allclose(got["metrics"][k], w, err_msg=k, **tol)

    want_grads = _grads_dict(j_grads)
    held = _check_gradient(got["grads"], want_grads,
                           ranks[0]["fp32"]["grads"] if head == "bf16" else None)
    share = _check_new_params(got["state"], state_dict_from_jax(j_params, j_stats), want_grads,
                              held, _tcfg().learning_rate, lambda k: head == "bf16")
    assert share > (0.9 if head == "fp32" else 0.5), share


def test_scene_step_matches_jax_mesh(ranks, refs):
    results = [r["scene"] for r in ranks]
    j_params, j_stats, j_grads, j_metrics = refs("scene")
    _ranks_agree(results)
    _is_mean_of_own_gradients(results)
    got = results[0]
    assert j_metrics["num_pos"] > 0, "no positive proposal"
    assert set(got["metrics"]) == set(j_metrics)
    for k, w in j_metrics.items():
        tol = LOSS if k in scene_tt.POINTWISE else BF16
        np.testing.assert_allclose(got["metrics"][k], w, err_msg=k, **tol)
    np.testing.assert_allclose(got["metrics"]["num_pos"], j_metrics["num_pos"], rtol=1e-6)
    want_grads = _grads_dict(j_grads, "scene")
    held = _check_gradient(got["grads"], want_grads, _mean(results, "own_grads_fp32_head"))
    assert {"semantic_linear.2.weight", "offset_linear.2.weight"} <= set(held)
    want = state_dict_from_jax(j_params, j_stats, family="scene")
    share = _check_new_params(got["state"], want, want_grads, held,
                              scene_tt._cfgs()[1].learning_rate,
                              lambda k: k.startswith("instance_head."))
    assert share > 0.5, share


def _jax_stream(cls, jcfg, rank, n):
    stub = types.SimpleNamespace(cfg=jcfg, train_data=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdist, "get_dist_info", lambda: (rank, WORLD))
        return [{k: np.asarray(v) for k, v in b.items() if k != "index"}
                for b in itertools.islice(cls._train_batches(stub, 1), n)]


@pytest.mark.parametrize("family", ["abc", "scene"])
def test_trainer_streams_match_jax(ranks, family):
    if family == "abc":
        jcfg, key, cls = _jcfg(), "trainer", JTrainer
    else:
        jcfg, key, cls = scene_tt._cfgs()[0].replace(max_instances=8), "scene_trainer", \
            JSceneTrainer
    for rank, res in enumerate(ranks):
        got = res[key]["stream"]
        want = _jax_stream(cls, jcfg, rank, len(got))
        assert len(got) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            # the port's ids index the rank's own instance table; JAX's the
            # global batch's, which its step takes back
            assert g["I_gt_global"].max() < len(g["instance_pointnum"])
            g = tstep.rebase_local_batch(g, rank, WORLD, jcfg.max_instances)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _eval_one_process(cfg, state, cls):
    """One process's ``test_one_epoch``: what it returns, the scalars it
    wrote, its result rows."""
    tr = cls(cfg, device="cpu")
    try:
        tr.model.load_state_dict(state)
        returned = tr.test_one_epoch(0)
        with open(tr.test_viz.path) as f:
            scalars = json.loads(f.readlines()[-1])
        rows = list(tr._results_rows)
    finally:
        tr.close()
    return returned, scalars, rows


def _csv_rows(text):
    return list(csv.DictReader(io.StringIO(text)))


@pytest.mark.parametrize("family", ["abc", "scene"])
def test_merged_eval_equals_one_process(ranks, refs, family):
    res = [r["trainer" if family == "abc" else "scene_trainer"] for r in ranks]
    returned, scalars, rows = refs(f"eval_{family}")
    assert [r["eval_objects"] for r in res] == [4, 4]         # rank-strided: 8 objects
    assert [r["main"] for r in res] == [True, False] and res[0]["world"] == WORLD
    # the rows' IDs are each rank's own count where a batch has no index, as in JAX
    plain = sorted(str({k: v for k, v in row.items() if k != "ID"}) for row in rows)
    for r in res:
        np.testing.assert_allclose(r["returned"], returned, **MERGED)
        assert sorted(str({k: v for k, v in row.items() if k != "ID"})
                      for row in r["rows"]) == plain
    written = res[0]["written"]["scalars"]
    assert set(written) == set(scalars)
    for k in scalars:
        if k not in ("time", "step"):
            np.testing.assert_allclose(written[k], scalars[k], err_msg=k, **MERGED)
    csv_rows = _csv_rows(res[0]["written"]["csv"])
    assert len(csv_rows) == 9 and csv_rows[-1]["ID"] == "Epoch0"
    # the data-parallel epoch: finite losses, one state on both ranks
    assert all(np.isfinite(r["losses"]).all() and len(r["losses"]) == 2 for r in res)
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["losses"] == res[1]["losses"]


def test_train_new_in_a_group(ranks):
    """``train_new.main`` under a group of 2 (as ``torchrun`` starts it):
    one epoch, its merged evaluation, ``--eval``; rank 0 writes."""
    res = [r["cli"] for r in ranks]
    assert [r["codes"] for r in res] == [[0, 0], [0, 0]]
    assert {"latest.tar", "max_miou.tar"} <= set(res[0]["checkpoints"])
    first, again = res[0]["records"]
    assert first["miou"] == again["miou"] and first["type_miou"] == again["type_miou"]
    assert "records" not in res[1]


def test_backend_and_launch_rules(monkeypatch):
    """``default_backend``: NCCL where every local rank has a card, else
    gloo; ``check_devices`` refuses two ranks on one card under NCCL, and
    ``pick_device`` runs it in a group; ``maybe_init_from_env`` joins
    nothing for one process and wants a coordinator for several;
    ``rank_device``'s default is ``cuda:LOCAL_RANK``, which must exist;
    ``pick_device``'s default on one device is ``cuda``, which must too."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pdist.default_backend() == "cpu:gloo,cuda:nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pdist.default_backend() == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        pdist.rank_device(None)
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        pdist.pick_device(None, 2, "the bench")
    assert pdist.rank_device("cpu") == torch.device("cpu")
    assert pdist.pick_device(None, 1, "the bench") == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="the bench runs on cuda by default"):
        pdist.pick_device(None, 1, "the bench")
    assert pdist.pick_device("cpu", 1, "the bench") == torch.device("cpu")

    monkeypatch.setattr(pdist, "get_dist_info", lambda: (0, 2))
    monkeypatch.setattr(pdist.dist, "get_backend", lambda *a: "cpu:gloo,cuda:nccl")
    monkeypatch.setattr(pdist, "collect_results", lambda part: part * 2)   # both ranks: one card
    with pytest.raises(ValueError, match="share cuda:0 under NCCL"):
        pdist.check_devices(torch.device("cuda:0"))
    with pytest.raises(ValueError, match="share cuda:0 under NCCL"):
        pdist.pick_device("cuda:0", 2, "the bench")
    monkeypatch.setattr(pdist.dist, "get_backend", lambda *a: "gloo")
    pdist.check_devices(torch.device("cuda:0"))
    assert pdist.pick_device("cuda:0", 2, "the bench") == torch.device("cuda:0")

    for k in ("WORLD_SIZE", "GCA_NUM_PROCESSES", "GCA_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.maybe_init_from_env() is False
    monkeypatch.setenv("GCA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="GCA_COORDINATOR"):
        pdist.maybe_init_from_env()


def test_bench_mesh_line(ranks):
    rows = [r["bench"] for r in ranks]
    for row in rows:
        assert row["metric"] == "train_clouds_per_sec_per_chip_8k_pts"
        assert row["devices"] == WORLD and row["value"] > 0
        # both rounded to 3 decimals from one rate
        assert abs(row["total_clouds_per_sec"] - WORLD * row["value"]) <= WORLD * 5e-4 + 1e-9


# ------------------------------------------------------------------ serving

def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k == "instances":
                assert g[k] == v
            elif v is None:
                assert g[k] is None
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)


def test_predictor_device_list_equals_one_device(inputs):
    """A cap between what items 0-1 and what items 0-3 propose: chunk 1
    keeps part of its proposals, as one device keeps them; each chunk alone
    would keep them all."""
    xyz, nrm = synth_clouds(_serving_cfg(24), B, seed=1)
    with torch.inference_mode():
        props = Predictor(_serving_cfg(200), inputs.serve_state, device="cpu").model(
            torch.from_numpy(xyz), torch.from_numpy(nrm)).proposals
    per_item = np.bincount(props.batch[props.valid].numpy(), minlength=B)
    assert 1 < per_item.min() and per_item.sum() < 200, per_item
    p = sum(per_item[:2]) + per_item[2] // 2
    one = Predictor(_serving_cfg(p), inputs.serve_state, device="cpu")
    two = Predictor(_serving_cfg(p, mesh_shape="2"), inputs.serve_state,
                    device=["cpu", "cpu"])
    want = one.predict_batch(xyz, nrm)
    assert sum(len(r["instances"]) for r in want[2:]) > 0
    _same_results(two.predict_batch(xyz, nrm), want)
    _same_results(list(two.predict_stream([(xyz, nrm)])), want)
    # without the shared cap, chunk 1 would keep more
    alone = one.predict_batch(xyz[2:], nrm[2:])
    assert [len(r["instances"]) for r in alone] != [len(r["instances"]) for r in want[2:]]
    with pytest.raises(ValueError, match="cannot shard over a mesh"):
        two.predict(xyz[0], nrm[0])
    with pytest.raises(ValueError, match="does not split"):
        two.predict_batch(xyz[:3], nrm[:3])
    with pytest.raises(ValueError, match="device=\\[...\\] with 2 devices"):
        Predictor(_serving_cfg(p, mesh_shape="2"), device="cpu")


def test_predictor_mesh_matches_jax_mesh_predictor(inputs, refs):
    """The port on ``["cpu", "cpu"]`` against the JAX ``Predictor`` over a
    2-device mesh (its state filled with the same weights)."""
    want = refs("predictor")
    got = Predictor(_serving_cfg(24, mesh_shape="2"), inputs.serve_state,
                    device=["cpu", "cpu"]).predict_batch(*inputs.clouds)
    assert sum(len(r["instances"]) for r in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["instance_labels"], w["instance_labels"])
        assert [(i["label_id"], i["npoint"], i["pred_mask"]) for i in g["instances"]] == \
               [(i["label_id"], i["npoint"], i["pred_mask"]) for i in w["instances"]]
        np.testing.assert_allclose([i["conf"] for i in g["instances"]],
                                   [i["conf"] for i in w["instances"]], **BF16)
        for key in ("type_per_point", "param_per_point", "pt_offsets"):
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **FP32)


def test_scene_predictor_device_list_equals_one_device(inputs, monkeypatch):
    """Class-major proposals under a cap one short of the batch's: the last
    class's last proposal, chunk 1's, is dropped; ``min_npoint`` set so that
    chunk 0 alone falls short of it for a class the batch reaches."""
    monkeypatch.setattr(serve_mod, "SoftGroupNet", functools.partial(
        SoftGroupNet, channels=SCENE_CH))
    n = SERVE["num_points"]                 # a kept instance needs 150 points
    cfg = Config(num_points=n, batch_size=B, max_instances=16, scene_bf16=False,
                 grouping=scene_grouping_defaults(GroupingConfig(min_npoint=5),
                                                  (n / 5.0,) * scene_tt.C))
    batch = synth_scene_batch(cfg, B, seed=2)
    xyz = (np.round(batch["xyz"] * 1024) / 1024).astype(np.float32)
    feats = batch["feats"]
    grouped = [c for c in range(cfg.num_primitives) if c not in cfg.grouping.ignore_classes]

    def make(p, mesh="1", device="cpu", **group):
        c = cfg.replace(mesh_shape=mesh, grouping=dataclasses.replace(cfg.grouping, **group),
                        instance_head=InstanceHeadConfig(grid_size=8, max_proposals=p))
        return ScenePredictor(c, inputs.s_state, device=device, scene_grid=SCENE_GRID)

    probe = make(200).model
    with torch.inference_mode():
        soft = torch.softmax(probe(torch.from_numpy(xyz), torch.from_numpy(feats))
                             .semantic_scores, -1).reshape(B, n, -1)[..., grouped]
    members = (soft > cfg.grouping.score_thr).sum(1).numpy()       # [B, classes]
    half, whole = members[:2].sum(0), members.sum(0)
    pick = int(np.argmax(np.where(whole > half, half, -1)))
    min_npoint = int(half[pick]) + 1
    assert whole[pick] >= min_npoint > half[pick] > 0
    with torch.inference_mode():
        total = int(make(200, min_npoint=min_npoint).model(
            torch.from_numpy(xyz), torch.from_numpy(feats)).proposals.num)
    assert 2 < total < 200, total
    one = make(total - 1, min_npoint=min_npoint)
    two = make(total - 1, "2", ["cpu", "cpu"], min_npoint=min_npoint)
    want = one.predict_batch(xyz, feats)
    assert sum(len(r["instances"]) for r in want) > 0
    _same_results(two.predict_batch(xyz, feats), want)
    # either chunk alone would be grouped otherwise
    for i in range(2):
        alone = one.predict_batch(xyz[2 * i:2 * i + 2], feats[2 * i:2 * i + 2])
        assert [len(r["instances"]) for r in alone] != \
            [len(r["instances"]) for r in want[2 * i:2 * i + 2]]
    with pytest.raises(ValueError, match="cannot shard over a mesh"):
        two.predict(xyz[0], feats[0])


def test_chunked_grouping_keeps_the_batch_cap():
    """``build_proposals`` / ``build_soft_proposals`` on two chunks (one
    thread each) keep what one call on the whole batch keeps."""
    from gcanet_tpu_torch.parallel.chunks import BatchChunks, run_chunks

    rng = np.random.default_rng(0)
    b, n, c = 4, 96, 7
    shifted = torch.from_numpy((np.round(rng.random((b, n, 3)) * 64) / 64 * 0.4)
                               .astype(np.float32))
    cls = torch.from_numpy(rng.integers(0, 3, (b, n)).astype(np.int32))
    emb = torch.zeros((b, n, 4))
    param = torch.zeros((b, n, 22))
    gcfg = GroupingConfig(radius=0.08, min_npoint=5, class_numpoint_mean=(-1.0,) * c,
                          similarity_threshold_inst=0.0)
    logits = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32) * 3)
    scfg = GroupingConfig(radius=0.08, min_npoint=40, score_thr=0.3,
                          class_numpoint_mean=(-1.0,) * c, ignore_classes=(0,))
    for build, args, cfg_g in ((tgrouping.build_proposals, (shifted, cls, emb, param), gcfg),
                               (tgrouping.build_soft_proposals, (shifted, logits), scfg)):
        full = build(*args, c, cfg_g, max_proposals=10 ** 4)
        p = int(full.num) - 3
        want = build(*args, c, cfg_g, max_proposals=p)
        chunks = BatchChunks([2, 2])
        parts = run_chunks([lambda i=i: build(*(a[2 * i:2 * i + 2] for a in args), c, cfg_g,
                                              max_proposals=p, chunk=chunks.chunk(i))
                            for i in range(2)], chunks)
        assert int(parts[0].num) + int(parts[1].num) == p
        for i, part in enumerate(parts):
            own = want.batch[want.valid] // 2 == i
            k = int(part.num)
            for f in ("cls", "size"):
                np.testing.assert_array_equal(getattr(part, f)[:k],
                                              getattr(want, f)[want.valid][own], err_msg=f)
            np.testing.assert_array_equal(part.batch[:k] + 2 * i,
                                          want.batch[want.valid][own])
            ids = np.nonzero((want.valid & (want.batch // 2 == i)).numpy())[0]
            pid = want.point_pid[:, 2 * i * n:(2 * i + 2) * n].numpy()
            local = np.where(pid >= 0, np.searchsorted(ids, pid), -1)
            np.testing.assert_array_equal(part.point_pid.numpy(), local)


def test_serve_http_batches_over_a_device_list(inputs):
    """``serve_http`` over a data-parallel predictor: its micro-batches
    (padded to ``batch_size``) and ``/v1/predict_batch`` split over the
    devices and answer what one device answers; a ``batch_size`` the devices
    do not divide fails each batch, as the JAX server's does."""
    from gcanet_tpu_torch.serve_http import PredictionServer

    xyz, nrm = (a[:2] for a in inputs.clouds)
    want = Predictor(_serving_cfg(24, batch_size=2), inputs.serve_state,
                     device="cpu").predict_batch(xyz, nrm)
    srv = PredictionServer(_serving_cfg(24, batch_size=2, mesh_shape="2"), inputs.serve_state,
                           device=["cpu", "cpu"])
    try:
        status, _, body = srv.handle("/v1/predict_batch", json.dumps(
            {"xyz": xyz.tolist(), "normals": nrm.tolist()}).encode(), "application/json", "")
        assert status == 200
        assert json.loads(body) == [srv._result_json(r) for r in want]
        _same_results([srv.batcher.submit(xyz[0], nrm[0])], want[:1])
    finally:
        srv.shutdown()
    odd = PredictionServer(_serving_cfg(24, batch_size=3, mesh_shape="2"), inputs.serve_state,
                           device=["cpu", "cpu"])
    try:
        with pytest.raises(ValueError, match="does not split"):
            odd.batcher.submit(xyz[0], nrm[0])
    finally:
        odd.shutdown()
