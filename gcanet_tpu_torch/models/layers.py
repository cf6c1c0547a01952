"""Shared building blocks, channels-last (port of ``gcanet_tpu/models/layers.py``).

The JAX package wraps Dense + GroupNorm into ``ConvGNAct`` / ``DenseGN``
modules.  Here the linear layer and the norm are separate attributes of the
owning module, named after the reference's state_dict keys (``conv1.0`` and
``bn1`` are siblings there), and ``conv_gn_act`` / ``dense_gn`` apply them.

Dtypes follow flax: a ``Dense`` computes in the promotion of its input's
and its weight's dtypes unless given one, so the model runs on bf16 copies
of its weights (``precision="bf16"``), and ``GroupNorm`` takes its
statistics in fp32 and returns its input's dtype.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class _Bound(nn.Module):
    """The modules a function reads, under one parent, so that
    ``functional_call`` can bind their parameters for one call."""

    def __init__(self, fn: Callable, modules: Mapping[str, nn.Module]):
        super().__init__()
        self.fn = (fn,)              # in a tuple: a module is not registered twice
        self.mods = nn.ModuleDict(dict(modules))

    def forward(self, *args):
        return self.fn[0](*args)


def remat(fn: Callable, modules: Mapping[str, nn.Module], *args: torch.Tensor):
    """``fn(*args)`` whose activations are recomputed in the backward
    (``torch.utils.checkpoint``, flax's ``remat``).  The parameters of
    ``modules`` (those ``fn`` reads) are taken as they are bound now (the
    bf16 copies of a ``precision="bf16"`` step) and bound again for the
    recomputation, which runs after the step's forward has returned."""
    bound = _Bound(fn, modules)
    names, params = zip(*bound.named_parameters())
    k = len(names)

    def run(*flat):
        return torch.func.functional_call(bound, dict(zip(names, flat[:k])), flat[k:])

    return checkpoint(run, *params, *args, use_reentrant=False)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s dtypes: input, weight and bias are
    cast to ``dtype``, by default the promotion of the input's and the
    weight's dtypes (fp32 input and fp32 weight: plain ``nn.Linear``)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def conv_gn_act(conv: nn.Module, gn: nn.Module, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """1x1 conv (no bias) + GroupNorm + LeakyReLU(0.2), the DGCNN conv block;
    ``dtype`` (bf16) runs it in that dtype, GroupNorm statistics in fp32
    (flax ``ConvGNAct(dtype=...)``).  ``conv`` is a ``Dense`` or a
    ``Sequential`` holding one."""
    dense = conv[0] if isinstance(conv, nn.Sequential) else conv
    return leaky_relu(gn(dense(x, dtype)))


def dense_gn(dense: nn.Module, gn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense + GroupNorm, no activation."""
    return gn(dense(x))


class GroupNorm(nn.Module):
    """GroupNorm over channels-last ``[B, ..., C]``: per sample, statistics
    over every non-batch position x C/G (flax ``GroupNorm`` semantics).  A
    half-precision input is normalised in fp32 and the result cast back, as
    flax does."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.float().reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        centered = xg - mean
        var = centered.square().mean(dim=(1, 3), keepdim=True)
        y = (centered * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """Batch norm (eps 1e-4, the reference's ``norm_fn``) whose training
    statistics are taken over the ``active`` positions only, as batch norm
    over sparse-conv voxel features is; the output is zeroed outside
    ``active``.

    ``dim`` is the channel axis of ``x``; ``active`` must broadcast to ``x``
    with size 1 on ``dim`` (training needs it).  Statistics are computed and
    applied in fp32 and the result cast back to ``x.dtype``.  In training
    mode the variance is biased, for the normalisation and for the running
    update alike, and the running statistics move as flax's with
    ``momentum=0.9`` do: ``running = 0.9 * running + 0.1 * batch``
    (``nn.BatchNorm``'s would take the unbiased variance).
    """

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _batch_stats(self, x: torch.Tensor, active: torch.Tensor, dim: int):
        dims = [d for d in range(x.dim()) if d != dim % x.dim()]
        xf = x.float()
        m = active.float()
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=dims, keepdim=True) / cnt
        var = (((xf - mean) ** 2) * m).sum(dim=dims, keepdim=True) / cnt
        return mean, var

    def forward(self, x: torch.Tensor, active: torch.Tensor | None = None,
                dim: int = -1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[dim] = -1
        if self.training:
            mean, var = self._batch_stats(x, active, dim)
            with torch.no_grad():
                for run, stat in ((self.running_mean, mean), (self.running_var, var)):
                    run.mul_(self.momentum).add_((1 - self.momentum) * stat.reshape(-1))
        else:
            mean, var = self.running_mean.view(shape), self.running_var.view(shape)
        y = ((x.float() - mean) * torch.rsqrt(var + self.eps)
             * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)
        if active is not None:
            y = y * active.to(x.dtype)
        return y


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9)`` over channels-last ``[..., C]``: in
    training mode the statistics of the batch, over every axis but the
    last, with flax's fast variance ``E[x^2] - E[x]^2`` (clipped at 0),
    biased in the normalisation and in the running update alike
    (``running = 0.9 * running + 0.1 * batch``; ``nn.BatchNorm*`` would
    take the unbiased variance); in eval mode the running statistics."""

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                for run, stat in ((self.running_mean, mean), (self.running_var, var)):
                    run.mul_(self.momentum).add_((1 - self.momentum) * stat)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias).to(x.dtype)


class MLP(nn.Sequential):
    """Linear ReLU Linear (softgroup/model/blocks.py:9-27 with two layers and
    no norm); children 0 and 2 are the linears, as in the reference's keys."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int):
        super().__init__(Dense(in_features, hidden_features), nn.ReLU(),
                         Dense(hidden_features, out_features))
