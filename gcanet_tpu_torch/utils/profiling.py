"""Profiling and tracing helpers (port of ``gcanet_tpu/utils/profiling.py``):
a ``torch.profiler`` trace, wall timers that wait for the device, and the
parameter count."""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from gcanet_tpu_torch.utils.timing import force_ready


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work (host ops, and the card's kernels where a
    card is present) and write its trace into ``log_dir`` (TensorBoard's
    profiler plugin reads it; so does Chrome's ``chrome://tracing``).
    Yields the profiler, whose ``key_averages()`` sums the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def device_time(tree=None) -> float:
    """Wall clock after the device work producing ``tree`` has finished."""
    if tree is not None:
        force_ready(tree)
    return time.time()


def timing(fn):
    """Print the seconds each call of ``fn`` takes, its result ready."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        r = fn(*args, **kwargs)
        force_ready(r)
        print(f"{fn.__module__}.{fn.__name__} : {time.perf_counter() - t0}")
        return r

    return wrapper


def parameter_count(model: torch.nn.Module) -> float:
    """Million-parameter count of ``model``, printed and returned."""
    n = sum(p.numel() for p in model.parameters())
    print(f"parameters number: {n / 1e6} M")
    return n / 1e6
