"""Numerically-safe primitives (port of ``gcanet_tpu/ops/mathutil.py``)."""

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(x^2)) floored at ``eps`` (zero, not NaN, gradient at x == 0)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def safe_unit(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / ||x|| with torch-like behaviour near zero."""
    return x / (safe_norm(x, dim=dim, keepdim=True, eps=eps) + eps)
