"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package.

Runs in a fresh interpreter (the test process itself has JAX loaded).
``gcanet_tpu_torch`` shares its prefix with ``gcanet_tpu``, so module names
are matched exactly, not by prefix."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import gcanet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gcanet_tpu_torch.__path__, "gcanet_tpu_torch.")]
assert "gcanet_tpu_torch.train_new" in names     # its import must not run the CLI
assert {"gcanet_tpu_torch.train." + m for m in
        ("scene_step", "scene_trainer", "instance_eval")} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gcanet_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    count = int(res.stdout.split()[0])
    assert count >= 18, res.stdout          # every module of the slice was imported
