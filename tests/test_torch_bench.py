"""The port's bench (``gcanet_tpu_torch/bench.py``) and ``bench_config``.

``bench_config`` equals the JAX package's field for field under the same
``GCA_BENCH_*`` environment; ``bench.main`` runs in-process on the CPU at
``tests/test_bench_smoke.py``'s toy sizes (one timed step; scene grid 8) and
prints exactly one JSON line with the JAX bench's metric names.
"""

import dataclasses
import json

import pytest
import torch

from gcanet_tpu.config import bench_config as jbench_config
from gcanet_tpu_torch import bench
from gcanet_tpu_torch.config import bench_config
from gcanet_tpu_torch.parallel import dist as pdist
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOY = {"GCA_BENCH_BATCH": "2", "GCA_BENCH_POINTS": "128", "GCA_BENCH_PROPOSALS": "8",
       "GCA_BENCH_NN": "16", "GCA_BENCH_ITERS": "1"}
KNOBS = ("GCA_BENCH_BATCH", "GCA_BENCH_POINTS", "GCA_BENCH_PROPOSALS", "GCA_BENCH_ENC_BF16",
         "GCA_BENCH_NN", "GCA_BENCH_MESH", "GCA_BENCH_GROUP_VMAP", "GCA_BENCH_EDGE_BWD",
         "GCA_BENCH_SHARED_GRAPH", "GCA_BENCH_NN_INNER", "GCA_BENCH_CC_PALLAS", "GCA_BENCH_KNN",
         "GCA_BENCH_SCENE_SOFT", "GCA_BENCH_FAMILY", "GCA_BENCH_ITERS",
         "GCA_BENCH_SCENE_GRID", "GCA_BENCH_SCENE_BF16", "GCA_BENCH_SCENE_REMAT")

ENVS = {
    "defaults": {},
    # the strict-parity line of tests/test_bench_smoke.py
    "strict_parity": {"GCA_BENCH_NN": "80", "GCA_BENCH_NN_INNER": "0",
                      "GCA_BENCH_PROPOSALS": "200", "GCA_BENCH_KNN": "xla"},
    "knobs": {"GCA_BENCH_ENC_BF16": "1", "GCA_BENCH_EDGE_BWD": "revgather:64",
              "GCA_BENCH_SHARED_GRAPH": "1", "GCA_BENCH_BATCH": "4", "GCA_BENCH_POINTS": "2048",
              "GCA_BENCH_GROUP_VMAP": "1", "GCA_BENCH_CC_PALLAS": "0", "GCA_BENCH_MESH": "2",
              "GCA_BENCH_SCENE_SOFT": "0"},
    "cc_pallas": {"GCA_BENCH_CC_PALLAS": "1"},
}


@pytest.fixture
def env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("name", sorted(ENVS))
def test_bench_config_matches_jax(env, name):
    for k, v in ENVS[name].items():
        env.setenv(k, v)
    got = bench_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(jbench_config())
    if name == "strict_parity":
        assert (got.nn_nb, got.nn_nb_inner, got.knn_impl) == (80, 0, "xla")
        assert got.instance_head.max_proposals == 200
        assert not got.encoder_bf16 and got.precision == "fp32"


@pytest.mark.parametrize("family,metric", [
    ("abc", "train_clouds_per_sec_per_chip_8k_pts"),
    ("scene", "scene_train_clouds_per_sec_per_chip_8k_pts")])
def test_bench_main_prints_one_json_line(env, capsys, family, metric):
    for k, v in dict(TOY, GCA_BENCH_FAMILY=family, GCA_BENCH_SCENE_GRID="8").items():
        env.setenv(k, v)
    row = bench.main([], device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    assert json.loads(lines[0]) == row
    assert row["metric"] == metric and row["unit"] == "clouds/s"
    assert row["value"] > 0 and row["vs_baseline"] == round(row["value"] / 5.0, 3)
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}


def test_bench_refuses_mesh_and_a_missing_card(env):
    """``GCA_BENCH_MESH=2`` needs a group of 2 processes: refused, naming
    torchrun, without one; accepted in a group of 2 (here the group's size
    as ``get_dist_info`` reports it; the bench runs over 2 real gloo ranks
    in ``tests/test_torch_parallel.py``)."""
    for k, v in dict(TOY, GCA_BENCH_MESH="2").items():
        env.setenv(k, v)
    with pytest.raises(ValueError, match="mesh_shape=2.*torchrun --nproc_per_node 2"):
        bench.main(["--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdist, "get_dist_info", lambda: (0, 2))
        assert pdist.data_parallel_world(bench_config()) == 2
    if not torch.cuda.is_available():
        env.setenv("GCA_BENCH_MESH", "1")
        with pytest.raises(RuntimeError, match="cuda"):
            bench.main([])
