"""The port's convergence logs against a JAX log at every eval.

    python docs/torch_conv/eval_spread.py --jax docs/conv_r5/scene_conv_soft_s0.jsonl \
        --key sem_miou docs/torch_conv/scene_conv_torch_tn_grid32_s*.jsonl

For each eval after step 0: the port's min-max (mean) over the given logs
(one a seed), then the JAX value.  Then the count of (seed, eval) pairs
where the port is below JAX, and the evals where JAX is above the port's
best seed.  Lines that are not JSON rows (the ``#`` header, ``done``) are
skipped.  numpy only; no JAX, no torch.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def rows(path: str) -> dict[int, dict]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                row = json.loads(line)
                out[row["step"]] = row
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jax", required=True, help="the JAX log (JSONL rows)")
    p.add_argument("--key", required=True, help="the metric, e.g. sem_miou, miou, type_miou")
    p.add_argument("logs", nargs="+", help="the port's logs, one a seed")
    args = p.parse_args(argv)
    jax_rows = rows(args.jax)
    port = [rows(path) for path in args.logs]
    steps = sorted(s for s in jax_rows if s > 0 and all(s in r for r in port))
    below, above_best = 0, []
    for s in steps:
        vals = np.array([r[s][args.key] for r in port])
        want = jax_rows[s][args.key]
        below += int((vals < want).sum())
        if want > vals.max():
            above_best.append(s)
        print(f"{s:5d}  {vals.min():.3f}-{vals.max():.3f} ({vals.mean():.3f}); JAX {want:.3f}")
    print(f"below JAX: {below} of {len(steps) * len(port)} pairs; "
          f"JAX above the best seed at {len(above_best)} evals {above_best}")
    return {"below": below, "pairs": len(steps) * len(port), "above_best": above_best}


if __name__ == "__main__":
    main()
