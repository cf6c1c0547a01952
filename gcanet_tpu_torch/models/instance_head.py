"""Per-proposal instance head: dense masked 3-D U-Net + cls/mask/IoU heads
(port of ``gcanet_tpu/models/instance_head.py``; reference dgcnn-4.py:611-615,
1379-1392, blocks at softgroup/model/blocks.py:44-143).

A submanifold sparse conv equals a dense conv at the active voxels when the
inactive ones are held at zero, so every conv runs dense on the proposal
grid and its output is multiplied by the occupancy.  Public tensors are
channels-last (``[P, G^3, C]``, as in the JAX package); the U-Net permutes
to ``[P, C, G, G, G]`` for ``conv3d`` inside.  Module and attribute names
are the reference's state_dict keys (``tiny_unet.blocks.block0.conv_branch.2``
...), so ``Conv3d`` weights are ``[out, in, k, k, k]`` and the transposed
conv's are ``[in, out, k, k, k]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gcanet_tpu_torch.models.layers import MLP, MaskedBatchNorm


class SubMConv3d(nn.Conv3d):
    """3x3x3 masked dense conv (SAME padding, no bias) == submanifold sparse
    conv at active sites.  Runs in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), padding=self.padding) * active


class ResidualBlock(nn.Module):
    """blocks.py:44-79 pre-activation residual block (BN -> ReLU -> conv) x2,
    with a 1x1 ``i_branch`` when the width changes (Custom1x1Subm3d)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_branch = nn.ModuleList([
            MaskedBatchNorm(in_channels), nn.ReLU(),
            SubMConv3d(in_channels, out_channels),
            MaskedBatchNorm(out_channels), nn.ReLU(),
            SubMConv3d(out_channels, out_channels)])
        if in_channels != out_channels:
            self.i_branch = nn.Sequential(nn.Linear(in_channels, out_channels, bias=False))

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        bn0, _, conv0, bn1, _, conv1 = self.conv_branch
        h = torch.relu(bn0(x, active, dim=1)) * active
        h = conv0(h, active)
        h = torch.relu(bn1(h, active, dim=1)) * active
        h = conv1(h, active)
        identity = x
        if hasattr(self, "i_branch"):
            w = self.i_branch[0].weight.to(x.dtype)
            identity = F.conv3d(x, w[:, :, None, None, None])
        return h + identity * active


def _blocks(*widths: tuple[int, int]) -> nn.ModuleDict:
    return nn.ModuleDict({f"block{i}": ResidualBlock(cin, cout)
                          for i, (cin, cout) in enumerate(widths)})


class TinyUNet(nn.Module):
    """UBlock([C, 2C], block_reps=2) of blocks.py:82-143 on dense masked grids.

    ``x [P, C, G, G, G]``, ``active [P, 1, G, G, G]`` in x's dtype.  The
    stride-2 occupancy is a 2^3 max-pool of the full-resolution one.
    """

    def __init__(self, channels: int = 64):
        super().__init__()
        c = channels
        self.blocks = _blocks((c, c), (c, c))
        self.conv = nn.ModuleList([MaskedBatchNorm(c), nn.ReLU(),
                                   nn.Conv3d(c, 2 * c, 2, stride=2, bias=False)])
        self.u = nn.ModuleDict({"blocks": _blocks((2 * c, 2 * c), (2 * c, 2 * c))})
        self.deconv = nn.ModuleList([MaskedBatchNorm(2 * c), nn.ReLU(),
                                     nn.ConvTranspose3d(2 * c, c, 2, stride=2, bias=False)])
        self.blocks_tail = _blocks((2 * c, c), (c, c))

    def forward(self, x: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks.values():
            x = blk(x, a0)
        identity = x

        bn, _, down = self.conv                                  # blocks.py:99-107
        h = torch.relu(bn(x, a0, dim=1)) * a0
        a1 = F.max_pool3d(a0.float(), 2).to(a0.dtype)
        h = F.conv3d(h, down.weight.to(h.dtype), stride=2) * a1
        for blk in self.u["blocks"].values():
            h = blk(h, a1)

        bn, _, up = self.deconv                                  # blocks.py:112-119
        h = torch.relu(bn(h, a1, dim=1)) * a1
        h = F.conv_transpose3d(h, up.weight.to(h.dtype), stride=2) * a0

        x = torch.cat([identity, h], dim=1)                      # blocks.py:140
        for blk in self.blocks_tail.values():
            x = blk(x, a0)
        return x


class InstanceHeadOutput(NamedTuple):
    cls_scores: torch.Tensor        # [P, num_classes]
    iou_scores: torch.Tensor        # [P, num_classes]
    mask_scores: torch.Tensor       # [CH, B*N, num_classes] per-entry voxel mask
    entry_pid: torch.Tensor         # [CH, B*N] == Proposals.point_pid


class InstanceHead(nn.Module):
    """forward_instance (dgcnn-4.py:1379-1392) on dense voxelised proposals.

    ``compute_bf16`` runs the U-Net in bfloat16 (the JAX default); batch-norm
    statistics are applied in fp32 and every head output is fp32.
    """

    def __init__(self, num_classes: int = 7, channels: int = 64,
                 grid_size: int = 16, compute_bf16: bool = True):
        super().__init__()
        self.grid_size = grid_size
        self.compute_bf16 = compute_bf16
        self.num_classes = num_classes
        self.tiny_unet = TinyUNet(channels)
        self.tiny_unet_outputlayer = nn.ModuleList([MaskedBatchNorm(channels), nn.ReLU()])
        self.mask_linear = MLP(channels, num_classes, hidden_features=channels)
        self.cls_linear = nn.Linear(channels, num_classes)
        self.iou_score_linear = nn.Linear(channels, num_classes)

    def forward(self, vox_feats: torch.Tensor, active: torch.Tensor,
                entry_voxel: torch.Tensor, point_pid: torch.Tensor) -> InstanceHeadOutput:
        p, g3, c = vox_feats.shape
        g = self.grid_size
        dt = torch.bfloat16 if self.compute_bf16 else torch.float32
        x = vox_feats.to(dt).reshape(p, g, g, g, c).permute(0, 4, 1, 2, 3)
        a = active.reshape(p, 1, g, g, g).to(dt)

        x = self.tiny_unet(x, a)
        x = torch.relu(self.tiny_unet_outputlayer[0](x, a, dim=1)) * a
        x = x.permute(0, 2, 3, 4, 1).reshape(p, g3, -1).float()

        # mask head: per-voxel MLP, gathered at each entry's voxel
        mask_vox = self.mask_linear(x)                            # [P, G3, cls]
        ch, n_total = point_pid.shape
        pid_flat = point_pid.reshape(-1)
        vox_flat = entry_voxel.reshape(-1)
        valid = (pid_flat >= 0) & (vox_flat >= 0)
        entry_mask = mask_vox[torch.clamp(pid_flat, 0, p - 1).long(),
                              torch.clamp(vox_flat, 0, g3 - 1).long()]
        entry_mask = torch.where(valid[:, None], entry_mask, 0.0)
        entry_mask = entry_mask.reshape(ch, n_total, self.num_classes)

        # global average pool over active voxels (roipool.cu:12-71)
        denom = torch.clamp(active.sum(dim=1, keepdim=True), min=1)
        pooled = torch.sum(x * active[..., None], dim=1) / denom  # [P, C]
        return InstanceHeadOutput(self.cls_linear(pooled),
                                  self.iou_score_linear(pooled),
                                  entry_mask, point_pid)
