"""The SoftGroup scene family (port of ``gcanet_tpu/models/softgroup_scene.py``;
reference softgroup/model/softgroup.py:18-731).

The scene is voxelised into a dense masked grid (a submanifold sparse conv
equals a dense conv at the active voxels when the inactive ones are held at
zero), run through a 3-level U-Net, and mapped back to the points; semantic
and offset heads follow, then soft per-class grouping, the per-proposal
voxelisation and the flagship's instance head.  The top-level modules carry
the flax tree's names (``input_conv``, ``unet``, ``output_layer``,
``semantic_linear``, ``offset_linear``, ``instance_head``).  Grids are
channels-first inside (``[B, C, G, G, G]``, for ``conv3d``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gcanet_tpu_torch.config import Config, check_supported
from gcanet_tpu_torch.models.instance_head import InstanceHead, InstanceHeadOutput, ResidualBlock
from gcanet_tpu_torch.models.layers import MLP, MaskedBatchNorm, init_lecun_normal_
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import segment as seg
from gcanet_tpu_torch.ops import voxelize as vox_ops


class SceneUNet(nn.Module):
    """Dense masked U-Net of depth 3 (widths C, 2C, 4C) over ``x [B, C, G, G,
    G]`` with occupancy ``active [B, 1, G, G, G]`` in x's dtype.

    ``blocks`` 0-2 run down the levels, 3-4 up them on the skip concat;
    each way down is masked BN, ReLU and a stride-2 conv, each way up a
    stride-2 transposed conv.  The stride-2 occupancy is a 2^3 max-pool.
    Runs in x's dtype (bf16 or fp32); batch norm statistics are fp32 and
    the output is fp32.  ``remat`` recomputes each residual block in the
    backward instead of keeping its activations (``torch.utils.checkpoint``;
    the JAX package's ``fnn.remat(ResidualBlock)``).
    """

    def __init__(self, channels: int = 32, remat: bool = False):
        super().__init__()
        c = channels
        self.remat = remat
        self.blocks = nn.ModuleList([
            ResidualBlock(c, c), ResidualBlock(2 * c, 2 * c), ResidualBlock(4 * c, 4 * c),
            ResidualBlock(4 * c, 2 * c), ResidualBlock(2 * c, c)])
        self.down_norm = nn.ModuleList([MaskedBatchNorm(c), MaskedBatchNorm(2 * c)])
        self.down_conv = nn.ModuleList([nn.Conv3d(c, 2 * c, 2, stride=2, bias=False),
                                        nn.Conv3d(2 * c, 4 * c, 2, stride=2, bias=False)])
        self.up_conv = nn.ModuleList([nn.ConvTranspose3d(4 * c, 2 * c, 2, stride=2, bias=False),
                                      nn.ConvTranspose3d(2 * c, c, 2, stride=2, bias=False)])

    def _down(self, i: int, h: torch.Tensor, a: torch.Tensor):
        h = torch.relu(self.down_norm[i](h, a, dim=1)) * a
        a2 = F.max_pool3d(a.float(), 2).to(a.dtype)
        return F.conv3d(h, self.down_conv[i].weight.to(h.dtype), stride=2) * a2, a2

    def _up(self, i: int, h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(h, self.up_conv[i].weight.to(h.dtype), stride=2) * a

    def _block(self, i: int, h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        block = self.blocks[i]
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(h, a)
        return torch.utils.checkpoint.checkpoint(
            block, h, a, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), _stats_kept(block)))

    def forward(self, x: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
        x0 = self._block(0, x, a0)
        x1, a1 = self._down(0, x0, a0)
        x1 = self._block(1, x1, a1)
        x2, a2 = self._down(1, x1, a1)
        x2 = self._block(2, x2, a2)
        x1 = self._block(3, torch.cat([x1, self._up(0, x2, a1)], dim=1), a1)
        x0 = self._block(4, torch.cat([x0, self._up(1, x1, a0)], dim=1), a0)
        return x0.float()


@contextlib.contextmanager
def _stats_kept(module: nn.Module):
    """The backward's recomputation of a checkpointed block moves no running
    statistic a second time (flax's remat drops the recomputed
    ``batch_stats``): they are put back as they were."""
    saved = {k: v.clone() for k, v in module.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in module.named_buffers():
                v.copy_(saved[k])


class SoftGroupOutput(NamedTuple):
    semantic_scores: torch.Tensor                   # [B*N, num_classes] logits
    pt_offsets: torch.Tensor                        # [B*N, 3]
    proposals: grouping_ops.Proposals | None        # None when semantic_only
    instance: InstanceHeadOutput | None


class SoftGroupNet(nn.Module):
    """``forward(xyz [B, N, 3] in [0, 1]^3, feats [B, N, 3])`` ->
    ``SoftGroupOutput``; ``feats`` are the 3 colour channels (the width of
    ``input_conv`` in every JAX scene driver).

    ``scene_grid`` is the voxel resolution (a multiple of 4);
    ``compute_bf16`` runs the U-Net in bf16; ``semantic_only`` builds the
    backbone and point heads alone (no instance head, no grouping);
    ``remat`` recomputes the U-Net's residual blocks in the backward.  The
    instance head is bf16 whatever ``compute_bf16`` says, as in the JAX
    package.  Grouping is soft per class (``cfg.scene_soft_grouping``) or
    the flagship's argmax partition with both affinity gates off.  Weights
    are random, seeded with ``cfg.seed``, until a checkpoint is loaded.
    """

    def __init__(self, cfg: Config, scene_grid: int = 64, channels: int = 32,
                 compute_bf16: bool = False, semantic_only: bool = False,
                 remat: bool = False):
        super().__init__()
        check_supported(cfg, scene=True)
        if scene_grid % 4:
            raise ValueError(f"scene_grid {scene_grid} is not a multiple of 4")
        self.cfg = cfg
        self.scene_grid = scene_grid
        self.channels = channels
        self.compute_bf16 = compute_bf16
        self.semantic_only = semantic_only
        num_cls = cfg.num_primitives
        self.input_conv = nn.Linear(3, channels, bias=False)
        self.unet = SceneUNet(channels, remat=remat)
        self.output_layer = MaskedBatchNorm(channels)
        self.semantic_linear = MLP(channels, num_cls, hidden_features=channels)
        self.offset_linear = MLP(channels, 3, hidden_features=channels)
        if not semantic_only:
            self.instance_head = InstanceHead(num_cls, channels, cfg.instance_head.grid_size)
        init_lecun_normal_(self, torch.Generator().manual_seed(cfg.seed))

    def _backbone(self, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """Voxelise (scatter-mean per voxel), U-Net, gather back to the
        points: ``[B*N, C]``."""
        b, n, in_c = feats.shape
        g = self.scene_grid
        g3 = g * g * g
        vox = torch.clamp((xyz * g).to(torch.int32), 0, g - 1)         # truncating cast
        vid = (vox[..., 0] * g + vox[..., 1]) * g + vox[..., 2]        # [B, N]
        flat_vid = (torch.arange(b, dtype=torch.int32, device=xyz.device)[:, None] * g3
                    + vid).reshape(-1)
        vfeats = seg.segment_mean(feats.reshape(b * n, in_c), flat_vid, b * g3)
        active = (seg.segment_count(flat_vid, b * g3) > 0).reshape(b, 1, g, g, g)

        dt = torch.bfloat16 if self.compute_bf16 else torch.float32
        h = self.input_conv(vfeats).reshape(b, g, g, g, self.channels)
        h = h.permute(0, 4, 1, 2, 3).contiguous() * active
        h = self.unet(h.to(dt), active.to(dt))
        h = torch.relu(self.output_layer(h, active, dim=1)) * active
        # voxel -> point: [B, C, G^3] at (item, :, voxel)
        bid = torch.arange(b, device=xyz.device).repeat_interleave(n)
        return h.reshape(b, self.channels, g3)[bid, :, vid.reshape(-1).long()]

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, x4_split: bool = False,
                r1: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> SoftGroupOutput:
        """``x4_split`` (one scene, 4 | N) runs the backbone on the 4
        interleaved parts ``[p::4]`` as a batch of 4 and re-interleaves the
        point features (the S3DIS test protocol, softgroup.py:380-411).  In
        training mode the proposal grids shift by ``r1 [2, 3]`` when given,
        else by a draw from ``generator`` (on the model's device); both are
        unused in eval mode."""
        if self.training and not self.semantic_only and r1 is None and generator is None:
            raise ValueError("the training forward draws its grid shift from r1 or a "
                             "generator; it never uses torch's global RNG")
        cfg = self.cfg
        b, n, _ = feats.shape
        num_cls = cfg.num_primitives
        if x4_split:
            if b != 1 or n % 4:
                raise ValueError(f"x4_split needs one scene with 4 | N, got B={b}, N={n}")

            def split(a):
                return a.reshape(n // 4, 4, *a.shape[2:]).transpose(0, 1).contiguous()

            pfeat = self._backbone(split(xyz), split(feats))
            pfeat = pfeat.reshape(4, n // 4, -1).transpose(0, 1).reshape(n, -1)
        else:
            pfeat = self._backbone(xyz, feats)

        semantic_scores = self.semantic_linear(pfeat)
        pt_offsets = self.offset_linear(pfeat)
        if self.semantic_only:
            return SoftGroupOutput(semantic_scores, pt_offsets, None, None)

        shifted = (xyz + pt_offsets.reshape(b, n, 3)).detach().float()
        logits = semantic_scores.reshape(b, n, num_cls).detach().float()
        ih = cfg.instance_head
        if cfg.scene_soft_grouping:
            proposals = grouping_ops.build_soft_proposals(
                shifted, logits, num_cls, cfg.grouping, max_proposals=ih.max_proposals)
        else:
            # the argmax partition on the plain radius graph: the affinity
            # gates are the flagship's and would cut every edge here
            gcfg = dataclasses.replace(cfg.grouping, similarity_threshold_inst=0.0,
                                       similarity_threshold_para=0.0)
            proposals = grouping_ops.build_proposals(
                shifted, logits.argmax(dim=-1).to(torch.int32),
                pfeat.reshape(b, n, -1).detach().float(),
                torch.zeros((b, n, 22), device=xyz.device), num_cls, gcfg,
                max_proposals=ih.max_proposals,
                using_set_aggr=(not self.training) and cfg.using_set_aggr)

        vx = vox_ops.clusters_voxelization(
            xyz.reshape(b * n, 3), pfeat, proposals.point_pid,
            num_proposals=ih.max_proposals, grid_size=ih.grid_size,
            rand_quantize=self.training, r1=r1, generator=generator)
        instance = self.instance_head(vx.feats, vx.active, vx.entry_voxel, proposals.point_pid)
        return SoftGroupOutput(semantic_scores, pt_offsets, proposals, instance)
