"""Train-step throughput of the port (port of the root ``bench.py``).

    python -m gcanet_tpu_torch.bench [--device cpu]
    GCA_BENCH_MESH=N torchrun --nproc_per_node N -m gcanet_tpu_torch.bench

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline"}``, the
metric named as the JAX bench names it (``train_clouds_per_sec_per_chip_8k_pts``,
or ``scene_train_clouds_per_sec_per_chip_8k_pts`` with
``GCA_BENCH_FAMILY=scene``).  The workload is ``config.py::bench_config``
(``GCA_BENCH_*``; flagship B=10, N=8192, ``max_instances`` 48); the scene
family runs at B=8 unless ``GCA_BENCH_BATCH`` says otherwise, on the
scannetv2 grouping recipe with the mean table at ``N/5``, scene grid
``GCA_BENCH_SCENE_GRID`` (48), the U-Net in bf16 unless
``GCA_BENCH_SCENE_BF16=0``, recomputed with ``GCA_BENCH_SCENE_REMAT=1``.
The model and Adam are built from the seed, one fixed synthetic batch
(seed 0) is made, one warm-up step is taken, then ``GCA_BENCH_ITERS`` (10)
steps are timed: with CUDA events on a card, the host clock on the CPU.

``vs_baseline`` divides by the JAX bench's documented estimate of the
reference: 5.0 clouds/s (batch 3 at 7000 points on an A100).  The JAX
bench's ``mfu`` and ``hbm_util`` came from XLA's cost model and TPU peaks
and are not reported.  It runs on the card; ``--device cpu`` (or
``main(device="cpu")``) runs it on the CPU.

``GCA_BENCH_MESH=N`` > 1 benches the data-parallel step: one process per
device in a group of ``N`` (``parallel/dist.py``; rank r on ``cuda:r``
unless ``--device`` says otherwise), each on its ``B/N`` items of the one
global batch.  Rank 0 prints the line, with the JAX bench's per-device
value ``B * iters / seconds / N``, ``devices`` and
``total_clouds_per_sec``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from gcanet_tpu_torch.config import bench_config, scene_grouping_defaults
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_scene_batch
from gcanet_tpu_torch.parallel.dist import (broadcast_module, data_parallel_world,
                                            get_dist_info, local_shard, maybe_init_from_env,
                                            pick_device)
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.utils import threefry

REFERENCE_CLOUDS_PER_SEC = 5.0


def build(family: str, device: torch.device):
    """``(cfg, model, optimizer, batch, step, metric)`` of the bench workload:
    the model and Adam from the seed, one synthetic batch (seed 0; under
    ``GCA_BENCH_MESH`` this rank's chunk of it) on ``device``, and
    ``step(model, optimizer, batch, r1=...)``."""
    cfg = bench_config()
    world = data_parallel_world(cfg)
    env = os.environ
    if family == "scene":
        from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet

        cfg = cfg.replace(grouping=scene_grouping_defaults(
            cfg.grouping, class_numpoint_mean=(cfg.num_points / 5.0,) * 10))
        if "GCA_BENCH_BATCH" not in env:
            cfg = cfg.replace(batch_size=8)
        model = SoftGroupNet(
            cfg, scene_grid=int(env.get("GCA_BENCH_SCENE_GRID", "48")),
            compute_bf16=bool(int(env.get("GCA_BENCH_SCENE_BF16", str(int(cfg.scene_bf16))))),
            remat=bool(int(env.get("GCA_BENCH_SCENE_REMAT", "0"))))
        raw = synth_scene_batch(cfg, cfg.batch_size, seed=0)
        step, metric = scene_step.scene_train_step, "scene_train_clouds_per_sec_per_chip_8k_pts"
    elif family == "abc":
        from gcanet_tpu_torch.models.primitive_net import PrimitiveNet

        model = PrimitiveNet(cfg)
        raw = synth_batch(cfg, cfg.batch_size, seed=0)
        step, metric = step_lib.train_step, "train_clouds_per_sec_per_chip_8k_pts"
    else:
        raise ValueError(f"GCA_BENCH_FAMILY={family!r}; 'abc' or 'scene'")
    model.to(device)
    raw = {k: v for k, v in raw.items() if k != "index"}
    if world > 1:
        broadcast_module(model)
        raw = local_shard(raw, get_dist_info()[0], world)
    optimizer = step_lib.make_optimizer(cfg, model.parameters())
    batch = step_lib.batch_to_device(raw, device)
    return cfg, model, optimizer, batch, step, metric


def main(argv: list[str] | None = None, device: str | torch.device | None = None) -> dict:
    """Run the bench and print its JSON line (rank 0 under a mesh); returns
    the line's dict.  Joins the launcher's group when there is one and this
    process is in none."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    joined = maybe_init_from_env()
    try:
        return _run(device if device is not None else args.device)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(device: str | torch.device | None) -> dict:
    world = data_parallel_world(bench_config())
    dev = pick_device(device, world, "the bench")
    family = os.environ.get("GCA_BENCH_FAMILY", "abc")
    cfg, model, optimizer, batch, step, metric = build(family, dev)
    n_iters = int(os.environ.get("GCA_BENCH_ITERS", "10"))
    # step i's grid shift is the JAX bench's: its key PRNGKey(1) folded
    # with the step (bench.py:122), every shift copied over before the clock
    shifts = [step_lib.grid_shift(threefry.key(1), i, dev) for i in range(n_iters + 1)]

    metrics = step(model, optimizer, batch, r1=shifts[0])           # warm-up
    float(metrics["total_loss"])
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_iters):
            metrics = step(model, optimizer, batch, r1=shifts[i + 1])
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for i in range(n_iters):
            metrics = step(model, optimizer, batch, r1=shifts[i + 1])
        seconds = time.perf_counter() - t0
    if not torch.isfinite(metrics["total_loss"]):
        raise RuntimeError(f"the bench's last total_loss is {float(metrics['total_loss'])}")
    clouds_per_sec = cfg.batch_size * n_iters / seconds / world
    row = {"metric": metric, "value": round(clouds_per_sec, 3), "unit": "clouds/s",
           "vs_baseline": round(clouds_per_sec / REFERENCE_CLOUDS_PER_SEC, 3)}
    if world > 1:
        row["devices"] = world
        row["total_clouds_per_sec"] = round(clouds_per_sec * world, 3)
    if get_dist_info()[0] == 0:
        print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
