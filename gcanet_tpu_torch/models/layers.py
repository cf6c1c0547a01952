"""Shared building blocks, channels-last (port of ``gcanet_tpu/models/layers.py``).

The JAX package wraps Dense + GroupNorm into ``ConvGNAct`` / ``DenseGN``
modules.  Here the linear layer and the norm are separate attributes of the
owning module, named after the reference's state_dict keys (``conv1.0`` and
``bn1`` are siblings there), and ``conv_gn_act`` / ``dense_gn`` apply them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def conv_gn_act(conv: nn.Module, gn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv (no bias) + GroupNorm + LeakyReLU(0.2), the DGCNN conv block."""
    return leaky_relu(gn(conv(x)))


def dense_gn(dense: nn.Module, gn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Dense + GroupNorm, no activation."""
    return gn(dense(x))


class GroupNorm(nn.Module):
    """GroupNorm over channels-last ``[B, ..., C]``: per sample, statistics
    over every non-batch position x C/G (flax ``GroupNorm`` semantics)."""

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
        xg = x.reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        centered = xg - mean
        var = centered.square().mean(dim=(1, 3), keepdim=True)
        y = (centered * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


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


class MLP(nn.Sequential):
    """Linear ReLU Linear (softgroup/model/blocks.py:9-27 with two layers and
    no norm); children 0 and 2 are the linears, as in the reference's keys."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int):
        super().__init__(nn.Linear(in_features, hidden_features), nn.ReLU(),
                         nn.Linear(hidden_features, out_features))


def init_lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: every linear/conv weight
    N(0, 1/fan_in) (flax's lecun-normal scale), biases 0; norms keep their
    identity initialisation."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.in_features
        elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            fan_in = m.in_channels * int(torch.tensor(m.kernel_size).prod())
        else:
            continue
        with torch.no_grad():
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
