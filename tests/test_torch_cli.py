"""The port's CLI (``config.build_option``, ``models/registry.py``,
``train_new.main``) against the JAX package's, and the entry point driven
end to end on the CPU at a tiny size: train two epochs on synthetic data,
then ``--eval`` the saved ``latest.tar``, for the flagship and the scene
family (``--model_dict softgroup.model.softgroup``); a trainer on an h5
dataset list; resuming at the epoch of ``latest``.
"""

import dataclasses
import functools
import json
import os

import h5py
import numpy as np
import pytest
import torch

from gcanet_tpu.config import build_option as jbuild_option
from gcanet_tpu.models import registry as jregistry
from gcanet_tpu_torch import train_new
from gcanet_tpu_torch.config import Config, build_option
from gcanet_tpu_torch.data.abc_dataset import ABCDataset
from gcanet_tpu_torch.models import registry, softgroup_scene
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.train.trainer import Trainer, prefetch_to_device

torch.set_num_threads(1)

TINY_FLAGS = ["--num_points", "128", "--batch_size", "1", "--nn_nb", "8", "--nn_nb_inner", "6",
              "--max_instances", "8", "--knn_impl", "xla", "--max_proposals", "4"]
TINY = dict(num_points=128, batch_size=2, nn_nb=8, nn_nb_inner=6, max_instances=8,
            knn_impl="xla")

ARGVS = {
    "defaults": [],
    "verify_drive": ["--log_dir", "vlog", "--num_points", "128", "--batch_size", "2",
                     "--max_instances", "8", "--max_epoch", "1", "--eval_interval", "999",
                     "--save_interval", "1", "--nn_nb", "16"],
    "max_proposals": ["--max_proposals", "200"],
    "strict_caps": ["--strict_caps", "1"],
    "eval": ["--eval", "--not_load_model", "--debug", "--resultsSave", "1"],
    "exact_knn": ["--nn_nb", "80", "--knn_impl", "xla"],
    "ignored_flags": ["--vis", "--vis_dir", "v", "--optimize", "1", "--gpu", "1",
                      "--bn_decay_step", "3", "--bn_decay_rate", "0.9"],
    "scene": ["--model_dict", "softgroup.model.softgroup", "--ignore_classes", "0,2",
              "--scene_soft_grouping", "0", "--encoder_bf16", "1"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_build_option_matches_jax(name):
    got = dataclasses.asdict(build_option(ARGVS[name]))
    want = dataclasses.asdict(jbuild_option(ARGVS[name]))
    assert got.keys() == want.keys()
    assert got == want


def test_config_defaults_match_jax():
    assert dataclasses.asdict(Config()) == dataclasses.asdict(jbuild_option([]))


def test_registry_names_as_jax():
    for name in list(jregistry._REGISTRY) + ["models.unknown"]:
        assert registry.is_scene_model(name) == jregistry.is_scene_model(name), name
    assert set(registry._REGISTRY) == set(jregistry._REGISTRY)
    tiny = Config(num_points=64, nn_nb=8, offset_knn=4, offset_keypoints=8)
    built = {"models.dgcnn-hais-concat-direct-4": PrimitiveNet,
             "gcanet_tpu.models.primitive_net": PrimitiveNet,
             "softgroup.model.softgroup": SoftGroupNet,
             "gcanet_tpu.models.softgroup_scene": SoftGroupNet}
    for name, cls in built.items():
        assert isinstance(registry.build_model(tiny.replace(model_dict=name)), cls)
    for name in set(registry._REGISTRY) - set(built):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            registry.build_model(tiny.replace(model_dict=name))
    with pytest.raises(KeyError):
        registry.build_model(tiny.replace(model_dict="models.unknown"))


def _test_records(log_dir):
    with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        del r["time"]
    return recs


def test_main_trains_evaluates_and_reevaluates_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("GCA_SYNTH_BATCHES", "1")
    log_dir = tmp_path / "log"
    argv = ["--log_dir", str(log_dir), "--data_path", str(tmp_path / "none"), *TINY_FLAGS,
            "--max_epoch", "2", "--eval_interval", "1", "--save_interval", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_new.main(argv)
    assert train_new.main(argv + ["--not_load_model"], device="cpu") == 0
    ckpts = set(os.listdir(log_dir / "checkpoint"))
    assert {"eval0.tar", "eval1.tar", "latest.tar"} <= ckpts
    assert ckpts & {"max_miou.tar", "max_type_miou.tar"}
    assert (log_dir / "output_results.csv").exists()
    recs = _test_records(log_dir)
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    latest = torch.load(log_dir / "checkpoint" / "latest.tar", weights_only=True)
    assert latest["epoch"] == 2 and latest["metrics"]["miou"] == recs[1]["miou"]

    assert train_new.main(argv + ["--eval"], device="cpu") == 0
    again = _test_records(log_dir)[-1]
    assert again.pop("step") == 2                 # the epoch saved with latest
    recs[1].pop("step")
    assert again == recs[1]

    # the scene family through the same entry point (SceneTrainer), its
    # model at scene grid 8 and 8 channels
    monkeypatch.setattr(softgroup_scene, "SoftGroupNet", functools.partial(
        softgroup_scene.SoftGroupNet, scene_grid=8, channels=8))
    scene_dir = tmp_path / "scene_log"
    scene = ["--log_dir", str(scene_dir), "--data_path", str(tmp_path / "none"),
             "--model_dict", "softgroup.model.softgroup", "--num_points", "256",
             "--batch_size", "2", "--max_instances", "8", "--max_proposals", "8",
             "--max_epoch", "2", "--eval_interval", "1", "--save_interval", "1"]
    assert train_new.main(scene + ["--not_load_model"], device="cpu") == 0
    assert {"eval0.tar", "eval1.tar", "latest.tar"} <= set(os.listdir(scene_dir / "checkpoint"))
    recs = _test_records(scene_dir)
    assert [r["step"] for r in recs] == [0, 1]
    assert {"miou", "acc", "pq", "all_ap", "all_ap_50%"} <= set(recs[1])
    latest = torch.load(scene_dir / "checkpoint" / "latest.tar", weights_only=True)
    assert "instance_head.cls_linear.weight" in latest["model_state_dict"]
    assert latest["metrics"] == {"miou": recs[1]["miou"], "type_miou": recs[1]["all_ap_50%"]}
    assert train_new.main(scene + ["--eval"], device="cpu") == 0
    again = _test_records(scene_dir)[-1]
    assert again.pop("step") == 2
    recs[1].pop("step")
    assert again == recs[1]


def test_resume_reads_the_epoch_of_latest(tmp_path):
    """Each checkpoint keeps its own epoch: a later save of another tag does
    not move where ``latest`` resumes (the JAX package shares one meta.json
    among its tags)."""
    cfg = Config(**TINY, log_dir=str(tmp_path / "log"), data_path=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.save_checkpoint(2, tag="latest", metrics={"miou": 0.5})
        trainer.save_checkpoint(6, tag="eval5")
    finally:
        trainer.close()
    for not_load_model, epoch in ((False, 2), (True, 0)):
        resumed = Trainer(cfg.replace(not_load_model=not_load_model), device="cpu")
        resumed.close()
        assert resumed.start_epoch == epoch


def _write_abc(root, names, seed=0):
    rng = np.random.default_rng(seed)
    for name in names:
        n = 400
        labels = np.repeat(rng.permutation(4), [160, 120, 110, 10])
        with h5py.File(root / f"{name}.h5", "w") as hf:
            hf.create_dataset("points", data=rng.random((n, 3)).astype(np.float32))
            hf.create_dataset("labels", data=labels[rng.permutation(n)].astype(np.int64))
            hf.create_dataset("normals", data=rng.standard_normal((n, 3)).astype(np.float32))
            hf.create_dataset("prim", data=rng.choice([1, 4, 5, 9], n).astype(np.int64))
            hf.create_dataset("T_param", data=rng.standard_normal((n, 22)).astype(np.float32))


def test_trainer_on_an_h5_list_trains_and_evaluates(tmp_path):
    names = ["00000001", "00000002", "00000003"]
    _write_abc(tmp_path, names)
    (tmp_path / "train_data.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "test_data.txt").write_text("\n".join(names[:2]) + "\n")
    cfg = Config(**TINY, log_dir=str(tmp_path / "log"), data_path=str(tmp_path), val_skip=1,
                 augment=1, if_normal_noise=1)
    cfg = cfg.replace(instance_head=dataclasses.replace(cfg.instance_head, max_proposals=4))
    trainer = Trainer(cfg, device="cpu")
    try:
        assert isinstance(trainer.train_data, ABCDataset) and len(trainer.test_data) == 2
        history = trainer.train_one_epoch(0)
        assert len(history) == 1 and np.isfinite(float(history[0]["total_loss"]))
        miou, type_miou = trainer.test_one_epoch(0)
        assert trainer.eval_errors == 0 and 0 <= miou <= 1 and 0 <= type_miou <= 1
        assert [r["ID"] for r in trainer._results_rows] == names[:2]
    finally:
        trainer.close()


def test_prefetch_to_device_passes_index_and_raises_producer_errors():
    def batches(fail_at):
        for i in range(4):
            if i == fail_at:
                raise ValueError(f"bad batch {i}")
            yield {"x": np.full((2, 3), i, np.float32), "index": [f"obj{i}"]}

    got = list(prefetch_to_device(batches(fail_at=None), "cpu"))
    assert [b["index"] for b in got] == [["obj0"], ["obj1"], ["obj2"], ["obj3"]]
    assert all(isinstance(b["x"], torch.Tensor) and float(b["x"][0, 0]) == i
               for i, b in enumerate(got))
    seen = []
    with pytest.raises(ValueError, match="bad batch 2"):
        for b in prefetch_to_device(batches(fail_at=2), "cpu"):
            seen.append(b["index"])
    assert seen == [["obj0"], ["obj1"]]
