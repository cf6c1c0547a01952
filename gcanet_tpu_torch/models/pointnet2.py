"""PointNet++ set-abstraction and feature-propagation modules (port of
``gcanet_tpu/models/pointnet2.py``; reference
pointnet2_ops/pointnet2_utils.py:279-379 and pointnet2_modules.py:22-209),
channels-last on the op kit of ``ops/pointnet2.py``.

torch needs each layer's input width where flax infers it: the modules
take ``in_channels``, the width of the point features (0 = none).  Their
batch norms follow flax (``layers.BatchNorm``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import BatchNorm, Dense
from gcanet_tpu_torch.ops import pointnet2 as p2
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_library_rules


class SharedMLP(nn.Module):
    """Per-point Dense (no bias) + BatchNorm + ReLU stack."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        widths = [in_channels, *channels]
        self.convs = nn.ModuleList(Dense(a, b, bias=False) for a, b in zip(widths, widths[1:]))
        self.bns = nn.ModuleList(BatchNorm(c) for c in channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(x)))
        return x


def _dense_names(mlp: SharedMLP) -> dict:
    """The flax children of a ``SharedMLP`` that its rule table counts."""
    return {f"Dense_{i}": {} for i in range(len(mlp.convs))}


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor], radius: float, nsample: int,
                    use_xyz: bool = True) -> torch.Tensor:
    """Ball query, grouping and centre subtraction: ``xyz [B, N, 3]``,
    ``new_xyz [B, S, 3]``, ``features [B, N, C]`` or None ->
    ``[B, S, nsample, C(+3)]``."""
    idx = p2.ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = p2.group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    grouped = p2.group_points(features, idx)
    return torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor],
              use_xyz: bool = True) -> torch.Tensor:
    """The single-group variant: ``[B, 1, N, C(+3)]``."""
    grouped_xyz = xyz[:, None]
    if features is None:
        return grouped_xyz
    return torch.cat([grouped_xyz, features[:, None]], dim=-1) if use_xyz else features[:, None]


def _group_width(in_channels: int, use_xyz: bool) -> int:
    return in_channels + 3 if use_xyz or not in_channels else in_channels


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (pointnet2_modules.py:62-135):
    ``forward(xyz, features)`` -> ``(new_xyz [B, S, 3], [B, S, sum of the
    mlps' last widths])``; ``npoint=None`` groups all points into one.
    Weights: the JAX module's ``init`` with ``PRNGKey(seed)``."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int = 0, use_xyz: bool = True, seed: int = 0):
        super().__init__()
        self.npoint, self.radii, self.nsamples, self.use_xyz = npoint, radii, nsamples, use_xyz
        width = _group_width(in_channels, use_xyz)
        self.mlps = nn.ModuleList(SharedMLP(width, mlp) for mlp in mlps)
        init_from_seed(self, build_library_rules("sa_msg", {
            f"SharedMLP_{j}": _dense_names(m) for j, m in enumerate(self.mlps)}), seed)

    @classmethod
    def make(cls, mlp: Sequence[int], npoint: Optional[int] = None,
             radius: Optional[float] = None, nsample: Optional[int] = None,
             use_xyz: bool = True, in_channels: int = 0) -> "PointnetSAModuleMSG":
        """The single-scale module (pointnet2_modules.py:138-166)."""
        return cls(npoint, [radius], [nsample], [mlp], in_channels, use_xyz)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        if self.npoint is not None:
            idx = p2.furthest_point_sample(xyz, self.npoint)
            new_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
        else:
            new_xyz = xyz.new_zeros(xyz.shape[0], 1, 3)
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            g = (query_and_group(xyz, new_xyz, features, radius, nsample, self.use_xyz)
                 if self.npoint is not None else group_all(xyz, features, self.use_xyz))
            outs.append(mlp(g).amax(dim=2))                         # [B, S, C]
        return new_xyz, torch.cat(outs, dim=-1)


PointnetSAModule = PointnetSAModuleMSG      # the JAX package's subclass adds only ``make``


class PointnetFPModule(nn.Module):
    """Feature propagation (pointnet2_modules.py:169-209): the known points'
    features at the unknown ones by inverse-distance weights over their 3
    nearest, concatenated with the unknown points' own, through a
    ``SharedMLP``.  ``in_channels`` = known + unknown feature widths.
    Weights: the JAX module's ``init`` with ``PRNGKey(seed)``."""

    def __init__(self, mlp: Sequence[int], in_channels: int, seed: int = 0):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)
        init_from_seed(self, build_library_rules(
            "fp", {"SharedMLP_0": _dense_names(self.mlp)}), seed)

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        if known is not None:
            dist, idx = p2.three_nn(unknown, known)
            recip = 1.0 / (dist + 1e-8)
            weight = recip / recip.sum(-1, keepdim=True)
            interp = p2.three_interpolate(known_feats.transpose(1, 2), idx,
                                          weight).transpose(1, 2)   # [B, S, C]
        else:
            interp = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                        known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
