"""The port's copy of ``jax.random`` (``gcanet_tpu_torch/utils/threefry.py``)
against JAX on the CPU: the largest gap, in float32 units in the last
place, of its normals and truncated normals over several keys, beside the
gap of the same draws taken through the exact inverse error function
(float64, rounded) instead of XLA's float32 code.

    JAX_PLATFORMS=cpu python docs/stream_gap.py [--values 2000000]

Prints one line per draw and key, then the largest gaps.  Runs on the CPU
with the JAX package's environment (it imports JAX).
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gcanet_tpu_torch.utils import threefry  # noqa: E402


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max())


def exact_erfinv(u: np.ndarray) -> np.ndarray:
    """``sqrt(2) * erf_inv(u)`` through float64 ``erfinv``, rounded."""
    e = torch.special.erfinv(torch.from_numpy(u.astype(np.float64))).numpy()
    return (np.sqrt(2.0) * e).astype(np.float32)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--values", type=int, default=2_000_000, help="values a draw")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    shape = (args.values,)
    lo_n = np.nextafter(np.float32(-1.0), np.float32(0.0))
    lo_t, hi_t = np.float32(-2.0), np.float32(2.0)
    worst = {"port": 0, "exact_erfinv": 0}
    for seed in (0, 1, 2):
        k, jk = threefry.key(seed), jax.random.PRNGKey(seed)
        draws = {
            "normal": (threefry.normal(k, shape), np.asarray(jax.random.normal(jk, shape)),
                       exact_erfinv(threefry.uniform(k, shape, lo_n, 1.0))),
            "truncated_normal": (
                threefry.truncated_normal(k, -2.0, 2.0, shape),
                np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape)),
                np.clip(exact_erfinv(threefry.uniform(k, shape, threefry._erf_f32(lo_t),
                                                      threefry._erf_f32(hi_t))),
                        np.nextafter(lo_t, np.float32(0)), np.nextafter(hi_t, np.float32(0))))}
        for name, (port, want, exact) in draws.items():
            gaps = {"port": ulps(port, want), "exact_erfinv": ulps(exact, want)}
            for key, gap in gaps.items():
                worst[key] = max(worst[key], gap)
            print(f"{name} seed {seed}: port {gaps['port']} ulps, through the exact "
                  f"erfinv {gaps['exact_erfinv']} ulps ({args.values} values)")
    print(f"largest: port {worst['port']} ulps, exact erfinv {worst['exact_erfinv']} ulps")
    return worst


if __name__ == "__main__":
    main()
