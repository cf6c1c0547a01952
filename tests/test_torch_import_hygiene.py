"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package,
nor sklearn, which the port does not depend on (its mean shift is its own);
nor does the rank side of the data-parallel tests (``tests/torch_dp_ranks.py``,
whose spawned ranks also report their modules:
``tests/test_torch_parallel.py::test_ranks_import_no_jax``).

Runs in a fresh interpreter (the test process itself has JAX loaded).
``gcanet_tpu_torch`` shares its prefix with ``gcanet_tpu``, so module names
are matched exactly, not by prefix."""

import subprocess
import sys
from pathlib import Path

from tests.torch_once import release_memory  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import gcanet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gcanet_tpu_torch.__path__, "gcanet_tpu_torch.")]
assert "gcanet_tpu_torch.train_new" in names     # its import must not run the CLI
assert {"gcanet_tpu_torch.train." + m for m in
        ("scene_step", "scene_trainer", "instance_eval")} <= set(names)
assert {"gcanet_tpu_torch.bench", "gcanet_tpu_torch.serve_http",
        "gcanet_tpu_torch.utils.precision"} <= set(names)
assert {"gcanet_tpu_torch.ops.pointnet2", "gcanet_tpu_torch.losses.mask2former"} | {
    "gcanet_tpu_torch.models." + m for m in
    ("offset_dual", "sppnet", "splinenet", "pointnet2", "soft_projection", "transformer",
     "query_decoder")} <= set(names)
assert {"gcanet_tpu_torch.geometry." + m for m in
        ("primitive_dis", "fit_circle", "fitting", "affinity", "spline")} | {
    "gcanet_tpu_torch.data.process_abc", "gcanet_tpu_torch.utils.io",
    "gcanet_tpu_torch.utils.timing", "gcanet_tpu_torch.utils.profiling"} <= set(names)
assert {"gcanet_tpu_torch.parallel", "gcanet_tpu_torch.parallel.dist",
        "gcanet_tpu_torch.parallel.chunks", "gcanet_tpu_torch.parallel.sharded_knn",
        "gcanet_tpu_torch.parallel.sharded_encoder",
        "gcanet_tpu_torch.utils.reference_ckpt"} <= set(names)
assert {"gcanet_tpu_torch.serve_bench", "gcanet_tpu_torch.ops.voxelize",
        "gcanet_tpu_torch.data.native"} <= set(names)
assert {"gcanet_tpu_torch.micro_bench", "gcanet_tpu_torch.convergence_run",
        "gcanet_tpu_torch.scene_convergence_run"} <= set(names)
for name in names:
    importlib.import_module(name)
from gcanet_tpu_torch.data.native import voxelize_idx
from gcanet_tpu_torch.ops.voxelize import voxelization_idx, voxelize_mean
import chip_smoke
import tests.torch_dp_ranks
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gcanet_tpu", "sklearn"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    count = int(res.stdout.split()[0])
    assert count >= 18, res.stdout          # every module of the slice was imported
