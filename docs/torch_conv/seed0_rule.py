"""The seed-0 rule of ``PERF.md`` §6: port seed 0 against the JAX log it
shares its start, data and grid shifts with, measured by the port's spread
over seeds.

    python docs/torch_conv/seed0_rule.py --jax docs/conv_r5/scene_conv_soft_s0.jsonl \
        --key sem_miou docs/torch_conv/scene_conv_torch_jaxkey_grid32_s*.jsonl

The first log is seed 0.  For each eval after step 0: seed 0's value, the
JAX value, the spread over all the given logs (max - min) and whether seed
0 is below JAX by more than that spread.  Then the count of such evals out
of all, and the first of them.  numpy only; no JAX, no torch.
"""

from __future__ import annotations

import argparse

from eval_spread import rows


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jax", required=True, help="the JAX log (JSONL rows)")
    p.add_argument("--key", required=True, help="the metric, e.g. sem_miou, type_miou")
    p.add_argument("logs", nargs="+", help="the port's logs, seed 0 first")
    args = p.parse_args(argv)
    jax_rows = rows(args.jax)
    port = [rows(path) for path in args.logs]
    steps = sorted(s for s in jax_rows if s > 0 and all(s in r for r in port))
    parted = []
    for s in steps:
        vals = [r[s][args.key] for r in port]
        spread = max(vals) - min(vals)
        gap = jax_rows[s][args.key] - vals[0]
        if gap > spread:
            parted.append(s)
        print(f"{s:5d}  seed 0 {vals[0]:.4f}; JAX {jax_rows[s][args.key]:.4f}; "
              f"spread {spread:.4f}{'  below by more' if gap > spread else ''}")
    print(f"seed 0 below JAX by more than the spread at {len(parted)} of {len(steps)} evals"
          + (f"; first at {parted[0]}" if parted else ""))
    return {"parted": parted, "evals": len(steps)}


if __name__ == "__main__":
    main()
