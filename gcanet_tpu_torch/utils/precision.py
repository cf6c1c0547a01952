"""Precision policy utilities (port of ``gcanet_tpu/utils/precision.py``).

bf16 storage and compute with fp32 islands: ``force_f32`` casts floating
arguments up, ``to_compute_dtype`` casts down, ``matmul_precision`` scopes
the float32 matmul precision (TF32 on or off) and restores it on exit.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch


def _map_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of ``tree`` (tensors, dicts, lists, tuples
    and named tuples, nested) to ``dtype``; everything else passes as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, _map_floats(v, dtype)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_floats(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, dtype) for v in tree)
    return tree


def force_f32(fn):
    """Decorator: run ``fn`` with every floating argument cast to fp32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return fn(*_map_floats(args, torch.float32), **_map_floats(kwargs, torch.float32))

    return wrapped


def to_compute_dtype(tree: Any, precision: str) -> Any:
    """Cast floating leaves to the configured compute dtype ('fp32' | 'bf16')."""
    if precision == "bf16":
        return _map_floats(tree, torch.bfloat16)
    return tree


_MATMUL_PRECISION = {"default": None, "float32": "highest", "tensorfloat32": "high"}


@contextlib.contextmanager
def matmul_precision(kind: str = "default"):
    """Scope the float32 matmul precision: 'default' leaves it as it is,
    'float32' turns TF32 off, 'tensorfloat32' on.  The old setting (and
    ``torch.backends.cuda.matmul.allow_tf32``) is restored on exit."""
    if kind not in _MATMUL_PRECISION:
        raise ValueError(f"unknown matmul precision {kind!r}; one of {sorted(_MATMUL_PRECISION)}")
    old = torch.get_float32_matmul_precision()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        if _MATMUL_PRECISION[kind] is not None:
            torch.set_float32_matmul_precision(_MATMUL_PRECISION[kind])
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def get_max_memory() -> int:
    """Peak device memory of the current CUDA device in MB; 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_allocated() // (1024 * 1024))
