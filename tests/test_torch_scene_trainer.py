"""The port's ``SceneTrainer`` on the CPU at a tiny size (N=256, B=2, scene
grid 8, 8 channels, ``max_proposals`` 8, instance grid 8): an epoch of two
synthetic batches with the JAX trainer's seeds, an evaluation with the AP
and PQ keys, checkpoints and resume, the ``--dataset`` variants; and the
evaluation epoch's metrics against the JAX ``SceneTrainer.test_one_epoch``
on bridged weights.

The scene model is built at grid 8 and 8 channels in both packages (the
registry's ``SoftGroupNet`` wrapped for the module).  For the metric
comparison (N=1024) the 8 eval scenes are the trainers' own synthetic ones (seeds
``90000 + i``) with coordinates on a 2**-10 grid, the offset head zeroed and
the weights pushed as in ``tests/test_torch_scene.py``, so grouping agrees
exactly; no class softmax lies within 1e-5 of ``score_thr`` (checked).
Metrics exact: mIoU, accuracy, AP, PQ (the confidences come out of the bf16
head in both packages and order the same way here).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcanet_tpu.models.softgroup_scene as jsg
from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.config import scene_grouping_defaults as jscene_grouping_defaults
from gcanet_tpu.data.synthetic import synth_scene_batch as jsynth_scene_batch
from gcanet_tpu.train import scene_step as jscene_step
from gcanet_tpu.train import step as jstep
from gcanet_tpu.train.scene_trainer import SceneTrainer as JSceneTrainer
import gcanet_tpu_torch.models.softgroup_scene as tsg
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     scene_grouping_defaults)
from gcanet_tpu_torch.data import scene_dataset as sd
from gcanet_tpu_torch.data.synthetic import synth_scene_batch
from gcanet_tpu_torch.train import scene_step as tscene_step
from gcanet_tpu_torch.train.scene_trainer import SceneTrainer
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests import torch_init_law as law
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, B, C, GRID, CH = 256, 2, 7, 8, 8
AP_KEYS = {"miou", "acc", "pq", "all_ap", "all_ap_50%", "all_ap_25%"} | \
    {f"class_{c}_ap" for c in range(2, C + 1)}


@pytest.fixture(autouse=True)
def tiny_scene_models(monkeypatch):
    monkeypatch.setattr(tsg, "SoftGroupNet", functools.partial(tsg.SoftGroupNet,
                                                               scene_grid=GRID, channels=CH))
    monkeypatch.setattr(jsg, "SoftGroupNet", functools.partial(jsg.SoftGroupNet,
                                                               scene_grid=GRID, channels=CH))


def _cfgs(tmp_path, n=N, **kw):
    def make(config, gcfg, ihcfg, defaults, tag):
        return config(num_points=n, batch_size=B, max_instances=8,
                      model_dict="softgroup.model.softgroup", scene_bf16=False,
                      log_dir=str(tmp_path / f"log_{tag}"), data_path=str(tmp_path / "none"),
                      max_epoch=1, eval_interval=1, save_interval=1, **kw,
                      grouping=defaults(gcfg(min_npoint=5), (n / 5.0,) * C),
                      instance_head=ihcfg(grid_size=GRID, max_proposals=8))

    return (make(JConfig, JGroupingConfig, JIHConfig, jscene_grouping_defaults, "jax"),
            make(Config, GroupingConfig, InstanceHeadConfig, scene_grouping_defaults, "port"))


def test_epoch_eval_checkpoint_and_resume(tmp_path):
    """An epoch, an evaluation, a checkpoint and its resume.  The seeded
    start is the JAX ``SceneTrainer``'s (``init_scene_state`` with
    ``PRNGKey(cfg.seed)``) within 4 float32 units in the last place, and
    each step's grid shift the JAX trainer's, exactly."""
    jcfg, cfg = _cfgs(tmp_path, seed=2)
    trainer = SceneTrainer(cfg, device="cpu")
    try:
        assert trainer.train_data is None and trainer.cls_offset == 2
        z = jnp.zeros((1, N, 3))
        law.check_values(trainer.model, *law.jax_init(lambda r: jsg.SoftGroupNet(jcfg).init(
            {"params": r}, z, z, train=False, rng=r), cfg.seed), family="scene")
        for i, b in enumerate(trainer._train_batches(3, 2)):
            want = jsynth_scene_batch(jcfg, B, seed=3000 + i)
            for k in want:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(want[k]), err_msg=k)
        shifts = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tscene_step, "scene_train_step", lambda *a, r1, _f=tscene_step.
                       scene_train_step: (shifts.append(r1.numpy().copy()), _f(*a, r1=r1))[1])
            history = trainer.train_one_epoch(0, num_batches=2)
        for step, r1 in enumerate(shifts):
            np.testing.assert_array_equal(r1, np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(cfg.seed * 7919), step), (2, 3))))
        assert len(shifts) == 2
        assert len(history) == 2
        assert all(np.isfinite(float(m["total_loss"])) for m in history)
        assert set(history[0]) == {"semantic_loss", "offset_loss", "cls_loss", "mask_loss",
                                   "iou_score_loss", "num_pos", "total_loss"}
        miou, ap50 = trainer.test_one_epoch(0)
        assert 0.0 <= miou <= 1.0 and 0.0 <= ap50 <= 1.0 and trainer.eval_errors == 0
        with open(trainer.test_viz.path) as f:
            rec = json.loads(f.readline())
        assert AP_KEYS <= set(rec) and rec["miou"] == miou and rec["all_ap_50%"] == ap50
        assert [r["ID"] for r in trainer._results_rows] == ["synthetic"] * 8
        assert os.path.exists(os.path.join(cfg.log_dir, "output_results.csv"))
        trainer.save_checkpoint(1, tag="latest", metrics={"miou": miou})
    finally:
        trainer.close()
    resumed = SceneTrainer(cfg, device="cpu")
    try:
        assert resumed.start_epoch == 1
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(resumed.model.state_dict()[k], v), k
    finally:
        resumed.close()


def _weights(jcfg, seed):
    """Pushed numpy weights (see the module docstring)."""
    z = jnp.zeros((B, jcfg.num_points, 3))
    jmodel = jsg.SoftGroupNet(jcfg, semantic_only=bool(jcfg.semantic_only))
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
    for leaf in params["offset_linear"]["Dense_1"].values():
        leaf[...] = 0.0
    if "instance_head" in params:
        params["instance_head"]["Dense_0"]["bias"][0] += 10.0
        params["instance_head"]["MLP_0"]["Dense_1"]["bias"] += 10.0
    return params, stats


def _rounded_eval_scenes(cfg):
    for i in range(8):
        batch = synth_scene_batch(cfg, 1, seed=90000 + i)
        batch["xyz"] = (np.round(batch["xyz"] * 1024) / 1024).astype(np.float32)
        yield batch


@pytest.mark.parametrize("semantic_only", [False, True])
def test_eval_epoch_matches_jax(tmp_path, monkeypatch, semantic_only):
    # N=1024: a blob of N/5 points passes the extraction's 150-point floor
    jcfg, cfg = _cfgs(tmp_path, n=1024, semantic_only=semantic_only, not_load_model=True)
    params, stats = _weights(jcfg, seed=11)
    monkeypatch.setattr(jscene_step, "init_scene_state", lambda c, m, tx, rng: jstep.TrainState(
        params, stats, tx.init(params), jnp.zeros((), jnp.int32)))
    jtrainer = JSceneTrainer(jcfg)
    jtrainer.build_dataloaders()                   # the JAX trainer's train() does this
    jtrainer._test_batches = lambda: _rounded_eval_scenes(cfg)
    want = jtrainer.test_one_epoch(0)

    trainer = SceneTrainer(cfg, device="cpu")
    try:
        trainer.model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
        trainer._test_batches = lambda: _rounded_eval_scenes(cfg)
        for batch in trainer._test_batches():
            with torch.no_grad():
                out = trainer.model.eval()(torch.as_tensor(batch["xyz"]),
                                           torch.as_tensor(batch["feats"]))
            e = torch.softmax(out.semantic_scores, -1)
            assert float((e - cfg.grouping.score_thr).abs().min()) > 1e-5
        got = trainer.test_one_epoch(0)
        rows = trainer._results_rows
    finally:
        trainer.close()
    assert got == want
    recs = []
    for c in (jcfg, cfg):
        with open(os.path.join(c.log_dir, "scalars_test.jsonl")) as f:
            rec = json.loads(f.readline())
        del rec["time"]
        recs.append(rec)
    assert recs[1] == recs[0]
    assert rows == jtrainer._results_rows
    assert recs[1]["miou"] > 0
    if semantic_only:
        assert recs[1]["all_ap"] == 0.0 and recs[1]["pq"] == 0.0
    else:
        assert AP_KEYS <= set(recs[1]) and recs[1]["all_ap_25%"] > 0, recs[1]


def _write_npz(d, n=300):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    np.savez(d / "s.npz", xyz=rng.rand(n, 3).astype(np.float32),
             rgb=rng.rand(n, 3).astype(np.float32), semantic=np.full(n, 5.0, np.float32),
             instance=np.zeros(n, np.float32))


def test_dataset_flag_selects_the_variant(tmp_path):
    _, base = _cfgs(tmp_path)
    rng = np.random.RandomState(0)
    s3 = tmp_path / "s3dis"
    s3.mkdir()
    for area in ("Area_1", "Area_2", "Area_3", "Area_4", "Area_5", "Area_6"):
        torch.save((rng.rand(500, 3).astype(np.float32), rng.rand(500, 3).astype(np.float32),
                    np.full(500, 7.0, np.float32), np.zeros(500, np.float32), 0, 0),
                   s3 / f"{area}_office.pth")
    _write_npz(tmp_path / "scannet" / "train")
    _write_npz(tmp_path / "stpls" / "train")
    _write_npz(tmp_path / "stpls" / "val")
    cases = [("s3dis", "s3dis", sd.S3DISSceneDataset, 0, (5, 1), ".pth"),
             ("ABC", "scannet", sd.ScanNetSceneDataset, 2, (1, 1), ".npz"),
             ("stpls3d", "stpls", sd.STPLS3DSceneDataset, 1, (1, 1), ".npz")]
    for dataset, root, cls, offset, sizes, suffix in cases:
        trainer = SceneTrainer(base.replace(dataset=dataset, data_path=str(tmp_path / root)),
                               device="cpu")
        try:
            assert type(trainer.train_data) is cls and trainer.cls_offset == offset
            assert (len(trainer.train_data), len(trainer.test_data)) == sizes
            assert trainer.train_data.suffix == suffix and not trainer.test_data.training
        finally:
            trainer.close()
    assert SceneTrainer._detect_suffix(sd.KITTISceneDataset, str(tmp_path)) == ".bin"
    (tmp_path / "pth").mkdir()
    (tmp_path / "pth" / "a_inst_nostuff.pth").write_bytes(b"")
    assert SceneTrainer._detect_suffix(sd.ScanNetSceneDataset, str(tmp_path / "pth")) == \
        "_inst_nostuff.pth"
