"""Timing utilities (port of ``gcanet_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so a timing waits for the
device of the tensors it measures: CUDA events on the card, the host clock
on the CPU (where every op has finished when it returns).  A timing is
written down with what it ran on (``device_line``).
"""

from __future__ import annotations

import subprocess
import time

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def cuda_devices(tree) -> list[torch.device]:
    """The CUDA devices the tensors of a (nested) result live on."""
    return sorted({t.device for t in _tensors(tree) if t.device.type == "cuda"},
                  key=lambda d: d.index or 0)


def force_ready(tree):
    """Wait until the work producing the tensors of ``tree`` has finished on
    their devices; returns ``tree``."""
    for dev in cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup``: CUDA events where the result lies on a card, else the host
    clock."""
    r = None
    for _ in range(max(warmup, 1)):
        r = fn(*args)
    devices = cuda_devices(r)
    force_ready(r)
    if devices:
        with torch.cuda.device(devices[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                r = fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    return (time.perf_counter() - t0) / iters


def device_line(device: torch.device | str) -> str:
    """What ``device`` is, for a timing's record: for a card the
    ``name, power.limit`` that ``nvidia-smi`` prints for it (the torch name
    and the error where ``nvidia-smi`` fails), else the device type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(index)}, power limit not read ({e})"
