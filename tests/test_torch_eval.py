"""The eval path of the PyTorch port against the JAX package, at the
``test_torch_predictor.py`` size (N=1024, K=12, grid 8, P=24), where the
merged-label rule's 150-point minimum keeps several instances per cloud.

A JAX ``Trainer(cfg)`` is built (its parameter init jitted, the same
function compiled) and its initial weights get the predictor test's pushes
(offset head x0.05, +10 on class 0's instance-class bias and on the mask
MLP's last bias) so that instances are kept; those weights are carried into
the port by ``utils/from_jax.py``.  Tolerances:
  * ``eval_step`` with the instance head in fp32 on both sides: losses
    rtol 1e-5, atol 1e-6; proposals and merged labels exact;
  * as shipped (bf16 head): ``inst_loss`` and the total at 3e-2, the other
    losses as above; merged labels exact at every point whose mask scores
    all lie farther than 3e-2 * (1 + 3) from the -3.0 threshold;
  * ``get_instances`` + ``merge_masks`` against the JAX host pair and
    against ``merged_labels_device``: exact;
  * ``Trainer.test_one_epoch`` (head fp32): miou and type_miou exact, the
    averaged losses rtol 1e-5; the per-object rows of
    ``output_results.csv`` equal, the epoch row's losses (rounded to 4
    places) within rtol 1e-5 plus half a unit of the 4th place; the
    ``resultsSave`` ``.xyz`` files byte-identical;
  * checkpoint pruning and the train loop's checkpoint rule: the same
    calls as the JAX trainer's.
"""

import csv
import functools
import json
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcanet_tpu.models.primitive_net as jpn
from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.data.synthetic import synth_batch as jsynth_batch
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.train import instances as jinst
from gcanet_tpu.train import step as jstep
from gcanet_tpu.train.trainer import Trainer as JTrainer
from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.train import instances as tinst
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 1024
SMALL = dict(num_points=N, batch_size=1, nn_nb=12, nn_nb_inner=8, offset_knn=6,
             offset_keypoints=24, max_instances=16, knn_impl="xla", not_load_model=True,
             resultsSave=True)
GROUP = dict(radius=0.05, similarity_threshold_inst=0.9,
             class_numpoint_mean=(-1.0,) * 7, min_npoint=20)
HEAD = dict(grid_size=8, max_proposals=24)
LOSS = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
MASK_THR = -3.0
# the eval cloud (seed 90000 + i) held alone: it keeps three instances, and
# float order flips none of its neighbour sets (in clouds 2, 3 and 6 one
# near-tie at a kNN boundary moves the embeddings by ~2e-3 between the
# frameworks, and the losses by up to 3e-5)
ONE_CLOUD = 5


def _jcfg(root):
    return JConfig(**SMALL, log_dir=str(root / "log"), data_path=str(root / "none"),
                   grouping=JGroupingConfig(**GROUP), instance_head=JIHConfig(**HEAD))


def _tcfg(root):
    return Config(**SMALL, log_dir=str(root / "log"), data_path=str(root / "none"),
                  grouping=GroupingConfig(**GROUP), instance_head=InstanceHeadConfig(**HEAD))


def _fp32_head(mp):
    mp.setattr(jpn, "InstanceHead", functools.partial(
        JInstanceHead, compute_bf16=False, name="InstanceHead_0"))


def _jax_run(root):
    """A JAX Trainer with its instance head in fp32 and its initial weights
    pushed: its eval step on eval cloud ``ONE_CLOUD``, then its
    ``test_one_epoch(0)`` (written under ``root``)."""
    cfg = _jcfg(root)
    with pytest.MonkeyPatch.context() as mp:
        real_init = jstep.init_state
        mp.setattr(jstep, "init_state", lambda c, m, tx, rng: jax.jit(
            lambda r: real_init(c, m, tx, r))(rng))
        _fp32_head(mp)
        trainer = JTrainer(cfg)
        params = jax.tree.map(np.array, trainer.state.params)
        stats = jax.tree.map(np.array, trainer.state.batch_stats)
        params["OffsetPredModule_0"]["Dense_0"]["kernel"] *= 0.05
        params["InstanceHead_0"]["Dense_0"]["bias"][0] += 10.0
        params["InstanceHead_0"]["MLP_0"]["Dense_1"]["bias"] += 10.0
        trainer.state = trainer.state._replace(params=params, batch_stats=stats)
        trainer.build_dataloaders()
        batch = jsynth_batch(cfg, 1, seed=90000 + ONE_CLOUD)
        want = jax.tree.map(np.asarray, trainer.eval_step(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()}))
        trainer.test_one_epoch(0)
    log = logging.getLogger("Train")
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    return SimpleNamespace(cfg=cfg, params=params, stats=stats, batch=batch, want=want)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """``_jax_run``, once per session (``tests/torch_once.py``)."""
    return once(tmp_path_factory, "eval_jax_run",
                lambda: _jax_run(tmp_path_factory.mktemp("jax")))


def _port_trainer(root, params=None, stats=None):
    trainer = Trainer(_tcfg(root), device="cpu")
    if params is not None:
        trainer.model.load_state_dict(state_dict_from_jax(params, stats))
    trainer.model.instance_head.compute_bf16 = False
    return trainer


@pytest.fixture(scope="module")
def port_trainer(jax_run, tmp_path_factory):
    trainer = _port_trainer(tmp_path_factory.mktemp("port"), jax_run.params, jax_run.stats)
    yield trainer
    trainer.close()


@pytest.fixture
def bare_trainer(tmp_path):
    """The port's trainer with its own initial weights: for checks of its
    error handling, which compare nothing with JAX."""
    trainer = _port_trainer(tmp_path)
    yield trainer
    trainer.close()


def _port_eval(model, batch):
    out, merged, total, ld = tstep.eval_step(model, tstep.batch_to_device(batch, "cpu"))
    return out, merged.numpy(), total.numpy(), {k: v.numpy() for k, v in ld.items()}


def _check_losses(ld, total, j_ld, j_total, inst_tol):
    assert set(ld) == set(j_ld)
    for k, w in j_ld.items():
        np.testing.assert_allclose(ld[k], w, err_msg=k, **(inst_tol if k == "inst_loss" else LOSS))
    np.testing.assert_allclose(total, j_total, **inst_tol)


@pytest.fixture(scope="module")
def port_one_cloud(jax_run, port_trainer):
    return _port_eval(port_trainer.model, jax_run.batch)


def test_eval_step_fp32_head_matches_jax(jax_run, port_trainer, port_one_cloud):
    j_out, j_merged, j_total, j_ld = jax_run.want
    out, merged, total, ld = port_one_cloud
    assert not port_trainer.model.training
    assert j_ld["num_pos"] > 0 and len(np.unique(j_merged)) > 2, "too few kept instances"
    for f, g, w in zip(out.proposals._fields, out.proposals, j_out.proposals):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{f}")
    np.testing.assert_array_equal(merged, j_merged)
    _check_losses(ld, total, j_ld, j_total, LOSS)


def test_eval_step_bf16_head_matches_jax(jax_run):
    """As shipped: the instance head in bf16 in both packages."""
    cfg, batch = jax_run.cfg, jax_run.batch
    step = jstep.make_eval_step(cfg, jpn.PrimitiveNet(cfg))
    j_out, j_merged, j_total, j_ld = jax.tree.map(np.asarray, step(
        jax_run.params, jax_run.stats, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = PrimitiveNet(Config(**SMALL, grouping=GroupingConfig(**GROUP),
                                instance_head=InstanceHeadConfig(**HEAD)))
    model.load_state_dict(state_dict_from_jax(jax_run.params, jax_run.stats))
    assert model.instance_head.compute_bf16
    out, merged, total, ld = _port_eval(model, batch)
    _check_losses(ld, total, j_ld, j_total, BF16)
    pid, scores = j_out.proposals.point_pid, j_out.instance.mask_scores[..., :7]
    near = ((pid >= 0)[..., None] & (np.abs(scores - MASK_THR) <= BF16["atol"]
                                     + BF16["rtol"] * abs(MASK_THR))).any(axis=(0, 2))
    assert near.mean() < 0.1 and len(np.unique(j_merged)) > 2
    np.testing.assert_array_equal(merged[~near], j_merged[~near])


def _host_pair_case(seed):
    """Random extraction inputs: two overlapping assignment channels."""
    rng = np.random.default_rng(seed)
    ch, n, p, c = 2, 600, 12, 7
    pid = rng.integers(-1, p, (ch, n)).astype(np.int32)
    pid[1, rng.random(n) < 0.5] = -1
    cls = (rng.standard_normal((p, c)) * 3).astype(np.float32)
    return dict(point_pid=pid, semantic_scores=rng.standard_normal((n, c)).astype(np.float32),
                cls_scores=cls, iou_scores=rng.random((p, c)).astype(np.float32),
                mask_scores=(rng.standard_normal((ch, n, c)) * 3 - 1).astype(np.float32),
                prop_valid=rng.random(p) < 0.8)


def _check_host_pair(kw, min_npoint):
    got = tinst.get_instances(**kw, instance_classes=7, min_npoint=min_npoint)
    want = jinst.get_instances(**kw, instance_classes=7, min_npoint=min_npoint)
    assert got == want
    dev = tinst.merged_labels_device(*(torch.as_tensor(kw[k]) for k in (
        "point_pid", "cls_scores", "iou_scores", "mask_scores", "prop_valid")), 7,
        min_npoint=min_npoint)[0].numpy()
    if not got:
        assert not dev.any()
        return 0
    labels = tinst.merge_masks(got)
    np.testing.assert_array_equal(labels, jinst.merge_masks(want))
    np.testing.assert_array_equal(labels, dev)
    return len(got)


def test_host_instances_match_jax_and_device(port_one_cloud):
    kept = [_check_host_pair(_host_pair_case(seed), min_npoint=5) for seed in range(3)]
    out = port_one_cloud[0]
    kw = dict(point_pid=out.proposals.point_pid, semantic_scores=out.semantic_scores,
              cls_scores=out.instance.cls_scores, iou_scores=out.instance.iou_scores,
              mask_scores=out.instance.mask_scores, prop_valid=out.proposals.valid)
    kept.append(_check_host_pair({k: v.numpy() for k, v in kw.items()}, min_npoint=150))
    assert min(kept) > 2, kept


def _last_record(log_dir):
    with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    del rec["time"]
    return rec


def _csv_rows(log_dir):
    with open(os.path.join(log_dir, "output_results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_trainer_test_one_epoch_matches_jax(jax_run, port_trainer):
    got = port_trainer.test_one_epoch(0)
    j_dir, t_dir = jax_run.cfg.log_dir, port_trainer.cfg.log_dir
    assert port_trainer.eval_errors == 0
    rec, want = _last_record(t_dir), _last_record(j_dir)
    assert set(rec) == set(want) and rec["step"] == 0
    assert (rec["miou"], rec["type_miou"]) == (want["miou"], want["type_miou"]) == got
    assert 0 < rec["miou"] < 1
    for k, w in want.items():
        np.testing.assert_allclose(rec[k], w, err_msg=k, **LOSS)

    rows, j_rows = _csv_rows(t_dir), _csv_rows(j_dir)
    assert rows[:-1] == j_rows[:-1] and len(rows) == 9
    assert rows[-1].keys() == j_rows[-1].keys() and rows[-1]["ID"] == "Epoch0"
    for k in ("miou", "type_miou"):
        assert rows[-1][k] == j_rows[-1][k]
    for k in rows[-1].keys() - {"ID"}:
        np.testing.assert_allclose(float(rows[-1][k]), float(j_rows[-1][k]),
                                   rtol=1e-5, atol=5e-5, err_msg=k)

    names = sorted(os.listdir(os.path.join(j_dir, "results")))
    assert len(names) >= 4 and sorted(os.listdir(os.path.join(t_dir, "results"))) == names
    for name in names:
        with open(os.path.join(t_dir, "results", name), "rb") as g, \
                open(os.path.join(j_dir, "results", name), "rb") as w:
            assert g.read() == w.read(), name


def test_eval_errors_counted_and_cuda_errors_raised(bare_trainer, monkeypatch):
    def bad_object(model, batch):
        raise ValueError("a bad object")

    before = bare_trainer.eval_errors
    monkeypatch.setattr(tstep, "eval_step", bad_object)
    assert bare_trainer.test_one_epoch(3) == (0.0, 0.0)
    assert bare_trainer.eval_errors == before + 8

    def lost_device(model, batch):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tstep, "eval_step", lost_device)
    with pytest.raises(RuntimeError, match="CUDA"):
        bare_trainer.test_one_epoch(4)
    assert bare_trainer.eval_errors == before + 8


def test_prune_checkpoints_keeps_the_jax_epochs(tmp_path):
    kept = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        fake = SimpleNamespace(cfg=SimpleNamespace(save_interval=2), ckpt_dir=str(d))
        for epoch in range(21):
            if epoch % 2 == 1:
                if side == "jax":
                    (d / f"eval{epoch}").mkdir()
                    JTrainer._prune_checkpoints(fake, epoch)
                else:
                    (d / f"eval{epoch}.tar").write_bytes(b"")
                    Trainer._prune_checkpoints(fake, epoch)
        kept[side] = sorted(int(p.name[4:].split(".")[0]) for p in d.iterdir())
    assert kept["port"] == kept["jax"] == [1, 3, 7, 15, 17, 19]


@pytest.mark.parametrize("eval_mode", [False, True])
def test_train_loop_calls_match_jax(eval_mode):
    """``train()``'s schedule against the JAX trainer's on the same scripted
    metrics: periodic saves and prunes, ``latest``, and the best-metric
    rule with its ``elif``."""
    scripted = [(0.5, 0.2), (0.4, 0.9), (0.6, 0.1), (0.6, 0.5), (0.3, 0.95), (0.2, 0.1)]
    calls = {}
    for side, cls, cfg_cls in (("jax", JTrainer, JConfig), ("port", Trainer, Config)):
        log = calls[side] = []
        fake = SimpleNamespace(
            cfg=cfg_cls(max_epoch=6, eval_interval=1, save_interval=2, eval=eval_mode),
            start_epoch=1, build_dataloaders=lambda: None,
            train_one_epoch=lambda e, log=log: log.append(("train", e)),
            _prune_checkpoints=lambda e, log=log: log.append(("prune", e)),
            save_checkpoint=lambda epoch, tag="latest", metrics=None, log=log:
                log.append(("save", epoch, tag, metrics)),
            test_one_epoch=lambda e, log=log: log.append(("test", e)) or scripted[e])
        cls.train(fake)
    assert calls["port"] == calls["jax"]
    tags = [c[2] for c in calls["port"] if c[0] == "save"]
    assert eval_mode or ("max_miou" in tags and "max_type_miou" in tags)
