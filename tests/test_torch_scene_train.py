"""The scene family's training step in the PyTorch port against the JAX
package's ``make_scene_train_step``, at N=256, B=2, scene grid 8, 8
channels, ``max_proposals`` 8, instance grid 8, from the same numpy weights
on the same synthetic batch, the grid shift ``r1`` the JAX step's own draw
(``uniform(fold_in(key, 0), (2, 3))``) injected.

The JAX step runs with an optimizer wrapped so that its state keeps the
gradient it was handed (after the freeze), so one compiled
``make_scene_train_step`` gives the losses, the gradient, the new parameters
and the new batch statistics.  Two compiles per module: the whole model and
the ``semantic_only`` model (the second serves two weight sets); the freeze
case compiles once more, ``semantic_only`` too.

Grouping is compared exactly: the offset head's last layer is zeroed (the
shifted coordinates are the inputs), the coordinates lie on a 2**-10 grid
and no class softmax is within 1e-5 of ``score_thr`` (checked), as in
``tests/test_torch_scene.py``.  The U-Net runs in fp32; the instance head is
bf16 in both packages,
as the JAX scene model always has it.

Tolerances: ``semantic_loss`` and ``offset_loss`` rtol 1e-5, atol 1e-6;
their gradient (the trunk's gradient from the point-wise losses, against the
JAX ``semantic_only`` step on the same trunk) rtol 1e-4, atol 1e-5 of the
largest entry; new trunk statistics rtol 1e-5, atol 1e-6; the instance
branch out of the bf16 head: its losses and head statistics at 3e-2 and its
gradient (and the whole model's) by cosine >= 0.9; ``num_pos`` exactly.  The
``semantic_only`` step is held whole: losses, every gradient, every new
statistic, and every new parameter at rtol 1e-5, atol 1e-6 where the
gradient entry exceeds 100 Adam eps or is 0.  The first Adam step moves a
weight by ``lr * g / (|g| + 1e-8)``, so where ``|g|`` is within a few eps
of 0 the gradient's last bits decide what share of ``lr`` it moves; those
entries, under 1%, are held within ``2 lr``.  The freeze case
(``fixed_modules="input_conv,unet"`` under AdamW) holds the frozen
parameters and statistics bit for bit and the rest as the whole step.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.config import scene_grouping_defaults as jscene_grouping_defaults
from gcanet_tpu.models.softgroup_scene import SoftGroupNet as JSoftGroupNet
from gcanet_tpu.train import scene_step as jscene_step
from gcanet_tpu.train import step as jstep
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig, check_trainable,
                                     scene_grouping_defaults)
from gcanet_tpu_torch.data.synthetic import synth_scene_batch
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)

N, B, C, GRID, CH = 256, 2, 7, 8, 8
LOSS = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
STATS = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=1e-5, atol=1e-6)
ADAM_EPS = 1e-8
MIN_COSINE = 0.9
POINTWISE = ("semantic_loss", "offset_loss")


def _cfgs(**kw):
    def make(config, gcfg, ihcfg, defaults):
        return config(num_points=N, batch_size=B, max_instances=16, scene_bf16=False, **kw,
                      grouping=defaults(gcfg(min_npoint=5), (N / 5.0,) * C),
                      instance_head=ihcfg(grid_size=GRID, max_proposals=8))

    return (make(JConfig, JGroupingConfig, JIHConfig, jscene_grouping_defaults),
            make(Config, GroupingConfig, InstanceHeadConfig, scene_grouping_defaults))


def _weights(seed, zero_offsets):
    """Flax trees of the whole model (shapes by ``eval_shape``, no compile)
    from a numpy seed, pushed so that grouping and the instance losses work:
    ``semantic_linear``'s last kernel x3 and +2.0 / +1.5 on classes 2 and 3
    (overlapping soft subsets), +10 on class 0's ``cls_linear`` bias and on
    the mask MLP's last bias."""
    z = jnp.zeros((B, N, 3))
    jmodel = JSoftGroupNet(_cfgs()[0], scene_grid=GRID, channels=CH)
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, z, z, train=False, rng=r),
                            jax.random.PRNGKey(0))
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
    sem = params["semantic_linear"]["Dense_1"]
    sem["kernel"] *= 3.0
    sem["bias"][2] += 2.0
    sem["bias"][3] += 1.5
    if zero_offsets:
        for leaf in params["offset_linear"]["Dense_1"].values():
            leaf[...] = 0.0
    params["instance_head"]["Dense_0"]["bias"][0] += 10.0
    params["instance_head"]["MLP_0"]["Dense_1"]["bias"] += 10.0
    return params, stats


def _trunk(tree):
    return {k: v for k, v in tree.items() if k != "instance_head"}


def _batch(seed):
    batch = synth_scene_batch(_cfgs()[1], B, seed=seed)
    batch["xyz"] = (np.round(batch["xyz"] * 1024) / 1024).astype(np.float32)
    return {k: v for k, v in batch.items() if k != "index"}


def _keep_grads(inner):
    """``inner``, with the gradient it was last handed kept in its state."""
    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


def _jax_step_fn(jcfg, semantic_only):
    model = JSoftGroupNet(jcfg, scene_grid=GRID, channels=CH, semantic_only=semantic_only)
    tx = _keep_grads(jstep.make_optimizer(jcfg))
    step = jscene_step.make_scene_train_step(jcfg, model, tx)

    def run(params, stats, batch, key):
        state = jstep.TrainState(params, stats, tx.init(params), jnp.zeros((), jnp.int32))
        new, metrics = step(state, batch, key)
        return jax.tree.map(np.asarray, (new.params, new.batch_stats, new.opt_state[1],
                                         metrics))
    return run


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(3)
    r1 = np.array(jax.random.uniform(jax.random.fold_in(key, 0), (2, 3)))
    return key, r1, _batch(seed=1)


@pytest.fixture(scope="module")
def jax_sem_step():
    return _jax_step_fn(_cfgs(semantic_only=True)[0], semantic_only=True)


@pytest.fixture(scope="module")
def full_step(setup):
    """The whole step in both packages from the same pushed weights."""
    key, r1, batch = setup
    jcfg, cfg = _cfgs()
    params, stats = _weights(seed=0, zero_offsets=True)
    want = _jax_step_fn(jcfg, semantic_only=False)(params, stats, batch, key)

    model = SoftGroupNet(cfg, scene_grid=GRID, channels=CH)
    model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    opt = tstep.make_optimizer(cfg, model.parameters())
    tb = tstep.batch_to_device(batch, "cpu")
    got = scene_step.scene_train_step(model, opt, tb, r1=torch.from_numpy(r1))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}

    # the gradient of the point-wise losses alone, and the forward's outputs
    fresh = SoftGroupNet(cfg, scene_grid=GRID, channels=CH).train()
    fresh.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    out = fresh(tb["xyz"], tb["feats"], r1=torch.from_numpy(r1))
    _, ld = scene_step.compute_scene_losses(cfg, out, tb)
    names, ps = zip(*[(n, p) for n, p in fresh.named_parameters()
                      if not n.startswith("instance_head.")])
    pw = torch.autograd.grad(ld["semantic_loss"] + ld["offset_loss"], ps)
    pointwise = {n: g.numpy() for n, g in zip(names, pw)}
    return params, want, (model, got, grads, out, pointwise)


def _flat(d, keys):
    return np.concatenate([np.asarray(d[k]).ravel() for k in keys])


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check_grads(got: dict, want_tree) -> None:
    want = {k: v.numpy() for k, v in state_dict_from_jax(want_tree, None, family="scene").items()}
    assert set(got) == set(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=floor, err_msg=name)


def test_scene_step_matches_jax(setup, full_step, jax_sem_step):
    key, r1, batch = setup
    params, (j_params, j_stats, j_grads, j_metrics), (model, got, grads, out, pointwise) = \
        full_step
    e = torch.softmax(out.semantic_scores.detach(), -1).numpy()
    assert np.abs(e - model.cfg.grouping.score_thr).min() > 1e-5
    assert int(out.proposals.num) > 0 and j_metrics["num_pos"] > 0, "no positive proposal"

    assert set(got) == set(j_metrics)
    for k, w in j_metrics.items():
        tol = LOSS if k in POINTWISE else BF16
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)
    assert float(got["num_pos"]) == j_metrics["num_pos"]

    # the trunk's gradient of the point-wise losses: the JAX semantic_only
    # step on the same trunk weights, batch and statistics
    _, sem_stats, sem_grads, sem_metrics = jax_sem_step(
        _trunk(params), _trunk(_weights(seed=0, zero_offsets=True)[1]), batch, key)
    for k in POINTWISE:
        np.testing.assert_allclose(sem_metrics[k], j_metrics[k], rtol=1e-6, atol=0)
    _check_grads(pointwise, sem_grads)

    # the instance branch out of the bf16 head: by cosine
    want = {k: v.numpy() for k, v in state_dict_from_jax(j_grads, None, family="scene").items()}
    head = [k for k in want if k.startswith("instance_head.")]
    assert _cosine(_flat(grads, head), _flat(want, head)) >= MIN_COSINE
    assert _cosine(_flat(grads, want), _flat(want, want)) >= MIN_COSINE

    new_stats = state_dict_from_jax(params, j_stats, family="scene")
    sd = model.state_dict()
    keys = [k for k in new_stats if "running" in k]
    assert len(keys) == 2 * (1 + 2 + 5 * 2 + 15)
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), new_stats[k].numpy(), err_msg=k,
                                   **(BF16 if k.startswith("instance_head.") else STATS))


def test_semantic_only_step_whole(setup, jax_sem_step):
    key, r1, batch = setup
    params, stats = (_trunk(t) for t in _weights(seed=4, zero_offsets=False))
    j_params, j_stats, j_grads, j_metrics = jax_sem_step(params, stats, batch, key)

    _, cfg = _cfgs(semantic_only=True)
    model = SoftGroupNet(cfg, scene_grid=GRID, channels=CH, semantic_only=True)
    model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    opt = tstep.make_optimizer(cfg, model.parameters())
    got = scene_step.scene_train_step(model, opt, tstep.batch_to_device(batch, "cpu"))
    assert set(got) == set(j_metrics) == {*POINTWISE, "total_loss"}
    for k, w in j_metrics.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **LOSS)
    assert float(got["offset_loss"]) > 0
    _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, j_grads)
    want = state_dict_from_jax(j_params, j_stats, family="scene")
    sd = model.state_dict()
    assert set(sd) == set(want)
    _check_new_params(sd, want, state_dict_from_jax(j_grads, None, family="scene"),
                      cfg.learning_rate)


def _check_new_params(sd, want, want_grads, lr):
    held = total = 0
    for k, w in want.items():
        g, w = sd[k].numpy(), w.numpy()
        if "running" in k:
            np.testing.assert_allclose(g, w, err_msg=k, **STATS)
            continue
        wg = want_grads[k].numpy()
        firm = (np.abs(wg) > 100 * ADAM_EPS) | (wg == 0)
        np.testing.assert_allclose(g[firm], w[firm], err_msg=k, **PARAMS)
        assert np.abs(g - w).max() <= 2 * lr, k
        held, total = held + firm.sum(), total + firm.size
    assert held > 0.99 * total, (held, total)


def test_fixed_modules_freeze_under_adamw(setup):
    key, r1, batch = setup
    kw = dict(semantic_only=True, fixed_modules="input_conv, unet,", weight_decay=0.05)
    jcfg, cfg = _cfgs(**kw)
    assert scene_step.fixed_module_names(cfg) == jscene_step.fixed_module_names(jcfg) == \
        ("input_conv", "unet")
    params, stats = (_trunk(t) for t in _weights(seed=5, zero_offsets=False))
    j_params, j_stats, j_grads, j_metrics = _jax_step_fn(jcfg, True)(params, stats, batch, key)

    model = SoftGroupNet(cfg, scene_grid=GRID, channels=CH, semantic_only=True)
    model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tstep.make_optimizer(cfg, model.parameters())
    assert isinstance(opt, torch.optim.AdamW)
    got = scene_step.scene_train_step(model, opt, tstep.batch_to_device(batch, "cpu"))
    for k, w in j_metrics.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **LOSS)

    want = state_dict_from_jax(j_params, j_stats, family="scene")
    moved = 0
    for k, v in model.state_dict().items():
        if k.split(".")[0] in ("input_conv", "unet"):
            assert torch.equal(v, before[k]), f"frozen {k} moved"
            assert torch.equal(want[k], before[k]), f"the JAX step moved frozen {k}"
        else:
            moved += not torch.equal(v, before[k])
    assert moved == len(want) - sum(k.split(".")[0] in ("input_conv", "unet") for k in want)
    rest = [k for k in want if k.split(".")[0] not in ("input_conv", "unet")]
    want_g = state_dict_from_jax(j_grads, None, family="scene")
    _check_new_params({k: model.state_dict()[k] for k in rest}, {k: want[k] for k in rest},
                      want_g, cfg.learning_rate)
    frozen_grads = [p.grad for n, p in model.named_parameters()
                    if n.split(".")[0] in ("input_conv", "unet")]
    assert frozen_grads and all(g is None for g in frozen_grads)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_g[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


def _as_jax_out(out):
    j = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    return types.SimpleNamespace(
        semantic_scores=j(out.semantic_scores), pt_offsets=j(out.pt_offsets),
        proposals=types.SimpleNamespace(point_pid=j(out.proposals.point_pid),
                                        valid=j(out.proposals.valid)),
        instance=types.SimpleNamespace(cls_scores=j(out.instance.cls_scores),
                                       mask_scores=j(out.instance.mask_scores),
                                       iou_scores=j(out.instance.iou_scores)))


@pytest.mark.parametrize("ignored", [False, True])
def test_scene_losses_on_the_same_outputs_and_ignore(setup, full_step, ignored):
    """``compute_scene_losses`` against the JAX function on the port's own
    forward outputs (no framework difference left: rtol 1e-6); with every
    label -100 / instance -1 the semantic, offset and class losses are 0."""
    _, _, batch = setup
    out = full_step[2][3]
    if ignored:
        batch = dict(batch, semantic=np.full_like(batch["semantic"], -100),
                     I_gt_global=np.full_like(batch["I_gt_global"], -1),
                     inst_valid=np.zeros_like(batch["inst_valid"]))
    jcfg, cfg = _cfgs()
    _, j_ld = jscene_step.compute_scene_losses(jcfg, _as_jax_out(out),
                                               jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        _, ld = scene_step.compute_scene_losses(cfg, out, tstep.batch_to_device(batch, "cpu"))
    assert set(ld) == set(j_ld)
    for k, w in j_ld.items():
        np.testing.assert_allclose(ld[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    if ignored:
        for k in ("semantic_loss", "offset_loss", "cls_loss"):
            assert float(ld[k]) == 0.0, k
    else:
        assert all(float(ld[k]) > 0 for k in ("semantic_loss", "offset_loss", "cls_loss"))


def _tiny_model(remat=False, semantic_only=False):
    _, cfg = _cfgs(semantic_only=semantic_only)
    model = SoftGroupNet(cfg, scene_grid=GRID, channels=CH, remat=remat,
                         semantic_only=semantic_only)
    params, stats = _weights(seed=6, zero_offsets=True)
    if semantic_only:
        params, stats = _trunk(params), _trunk(stats)
    model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    return model


def test_remat_gives_the_same_step():
    """``remat=True`` recomputes the U-Net blocks in the backward: the same
    losses, gradients and new statistics (each updated once), bit for bit."""
    batch = tstep.batch_to_device(_batch(seed=7), "cpu")
    res = []
    for remat in (False, True):
        model = _tiny_model(remat=remat, semantic_only=True)
        opt = tstep.make_optimizer(model.cfg, model.parameters())
        losses = scene_step.scene_train_step(model, opt, batch)
        res.append((losses, {n: p.grad for n, p in model.named_parameters()},
                    model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = res
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_grid_shift_takes_r1_or_generator_never_the_global_rng():
    model = _tiny_model().train()
    batch = tstep.batch_to_device(_batch(seed=8), "cpu")
    xyz, feats = batch["xyz"], batch["feats"]
    state = torch.get_rng_state()
    outs = [model(xyz, feats, generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    other = model(xyz, feats, generator=torch.Generator().manual_seed(10))
    assert torch.equal(torch.get_rng_state(), state), "the global RNG moved"
    assert int(outs[0].proposals.num) > 0
    for a, b in zip(outs[0].instance, outs[1].instance):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(outs[0].instance, other.instance))
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(9))
    injected = model(xyz, feats, r1=r1)
    for a, b in zip(outs[0].instance, injected.instance):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="global RNG"):
        model(xyz, feats)
    model.eval()(xyz, feats)                 # eval mode draws nothing


def test_check_trainable_scene():
    _, cfg = _cfgs()
    for kw in (dict(remat=True), dict(precision="bf16"), dict(edge_backward="revgather:4"),
               dict(encoder_bf16=True)):
        check_trainable(cfg.replace(**kw), scene=True)
        with pytest.raises(NotImplementedError):
            check_trainable(cfg.replace(**kw))
    with pytest.raises(NotImplementedError, match="mesh_shape.*ROADMAP"):
        check_trainable(cfg.replace(mesh_shape="2"), scene=True)
    with pytest.raises(ValueError, match="semantic_only"):
        check_trainable(cfg.replace(semantic_only=2), scene=True)
