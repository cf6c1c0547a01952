"""Build and load the port's hand-written CUDA kernels.

Each ``gcanet_tpu_torch/csrc/*.cu`` file has a plain C interface and is
compiled by ``nvcc`` into its own shared library under
``build/torch_kernels/`` at the repository root, at first use.  The library
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to, for its current contents."""
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path and nvcc's ``-Xptxas -v`` report ("" when already built)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never sees half a file
    return out, res.stderr


def load(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built first if needed.  Callers
    keep the handle (the dynamic loader maps a library once per process)."""
    return ctypes.CDLL(str(build(source)[0]))
