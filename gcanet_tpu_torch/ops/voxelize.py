"""Proposal voxelisation for the instance head (port of
``gcanet_tpu/ops/voxelize.py::clusters_voxelization``).

Each proposal's points are rescaled into a dense G^3 grid
(dgcnn-4.py:1300-1355); voxel features are the scatter-mean of the point
features, so the gradient of the voxel features flows back into the point
features.  Training shifts every grid by a random offset
(``rand_quantize``).

Also the parity ops of SoftGroup's ``voxelize_idx`` / ``voxelize_fp``
(``voxelization_idx``, ``voxelize_mean``), which no path of the model
calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcanet_tpu_torch.ops import segment as seg


class VoxelizedProposals(NamedTuple):
    """feats [P, G^3, C] (zero at empty voxels); active [P, G^3] bool;
    entry_voxel [CH, B*N] voxel id of each (channel, point) entry, -1 if the
    entry is in no proposal."""

    feats: torch.Tensor
    active: torch.Tensor
    entry_voxel: torch.Tensor


def clusters_voxelization(coords: torch.Tensor,      # [B*N, 3]
                          feats: torch.Tensor,       # [B*N, C]
                          point_pid: torch.Tensor,   # [CH, B*N], -1 = none
                          num_proposals: int,
                          grid_size: int,
                          rand_quantize: bool = False,
                          r1: torch.Tensor | None = None,
                          scale: float | None = None) -> VoxelizedProposals:
    """``rand_quantize`` shifts each proposal's grid by ``r1``, one ``[2,
    3]`` uniform draw shared by every proposal (``torch.rand(3)`` at
    dgcnn-4.py:1341-1342; the training step's is the JAX step's,
    ``train/step.py::grid_shift``)."""
    if rand_quantize and r1 is None:
        raise ValueError("rand_quantize shifts the grids by r1: pass the step's draw "
                         "(train/step.py::grid_shift)")
    ch, n_total = point_pid.shape
    g = grid_size
    g3 = g * g * g
    p = num_proposals
    if scale is None:
        scale = float(g)

    entry_pid = point_pid.reshape(-1)                      # [CH*B*N]
    entry_pt = torch.arange(n_total, device=coords.device).repeat(ch)
    entry_valid = entry_pid >= 0
    entry_coords = coords[entry_pt]                        # [E, 3]

    cmin = seg.segment_min(entry_coords, entry_pid, p)     # [P, 3]
    cmax = seg.segment_max(entry_coords, entry_pid, p)
    # clusters_scale = 1 / ((max-min)/G).max - 0.01, clamped to <= scale
    extent = torch.amax((cmax - cmin) / g, dim=1)
    clusters_scale = 1.0 / torch.clamp(extent, min=1e-12) - 0.01
    clusters_scale = torch.clamp(clusters_scale, max=scale)  # [P]
    cmin = cmin * clusters_scale[:, None]
    if rand_quantize:
        # fp32, so a bf16 grid origin promotes to fp32 here, as in JAX
        r1 = r1.to(device=cmin.device, dtype=torch.float32)
        rng_range = cmax * clusters_scale[:, None] - cmin
        cmin = cmin - torch.clamp(g - rng_range - 0.001, min=0.0) * r1[0]
        cmin = cmin - torch.clamp(g - rng_range + 0.001, max=0.0) * r1[1]

    pid_c = torch.clamp(entry_pid, 0, p - 1).long()
    e_scale = torch.where(entry_valid, clusters_scale[pid_c], 0.0)
    rel = entry_coords * e_scale[:, None] - cmin[pid_c]    # in [0, G)
    # masked entries may hold -inf/NaN here; they are dropped below
    rel = torch.nan_to_num(rel, nan=0.0, posinf=0.0, neginf=0.0)
    vox = torch.clamp(rel.to(torch.int32), 0, g - 1)
    voxel_id = (vox[:, 0] * g + vox[:, 1]) * g + vox[:, 2]
    voxel_id = torch.where(entry_valid, voxel_id, -1)

    combined = torch.where(entry_valid, entry_pid * g3 + voxel_id, -1)
    vfeats = seg.segment_mean(feats[entry_pt], combined, p * g3)
    vcount = seg.segment_count(combined, p * g3)
    return VoxelizedProposals(feats=vfeats.reshape(p, g3, -1),
                              active=(vcount > 0).reshape(p, g3),
                              entry_voxel=voxel_id.reshape(ch, n_total))


def voxelization_idx(coords: torch.Tensor, max_voxels: int):
    """Parity op for SoftGroup's ``voxelize_idx`` (voxelize.cpp:11-96, mode
    4; port of ``gcanet_tpu/ops/voxelize.py::voxelization_idx``).

    ``coords [M, 4]`` int (batch, x, y, z) -> ``(out_coords [max_voxels, 4],
    p2v [M] int32, num_voxels)``: voxels are numbered by first occurrence,
    as the reference's insertion-ordered hash map numbers them; rows past
    ``num_voxels`` are 0.  Needs ``num_voxels <= max_voxels``.  No host
    sync: ``num_voxels`` is a 0-d int32 tensor."""
    m = coords.shape[0]
    dev = coords.device
    c = coords.to(torch.int32)
    # lexicographic order over the 4 int32 columns by stable sorts from the
    # last column to the first (packing them into int64 would need a shift
    # per column and could not hold four full int32 values)
    order = torch.arange(m, device=dev)
    for col in (3, 2, 1, 0):
        order = order[torch.sort(c[order, col], stable=True).indices]
    sc = c[order]
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = (sc[1:] != sc[:-1]).any(dim=1)
    grp = torch.cumsum(first.to(torch.int64), 0) - 1        # voxel of each sorted row
    # each voxel's first position in the input; segments past max_voxels
    # are dropped and empty ones hold int32 max, as jax.ops.segment_min does
    occ = torch.where(first, order, m)
    first_pos = torch.full((max_voxels + 1,), torch.iinfo(torch.int32).max,
                           dtype=torch.int64, device=dev)
    first_pos.scatter_reduce_(0, grp.clamp(max=max_voxels), occ, "amin")
    rank = torch.argsort(torch.argsort(first_pos[:max_voxels], stable=True), stable=True)
    p2v = torch.empty(m, dtype=torch.int32, device=dev)
    p2v[order] = rank[grp.clamp(max=max_voxels - 1)].to(torch.int32)
    out_coords = torch.zeros((max_voxels, coords.shape[1]), dtype=coords.dtype, device=dev)
    out_coords[p2v.long()] = coords
    return out_coords, p2v, first.sum(dtype=torch.int32)


def voxelize_mean(feats: torch.Tensor, p2v: torch.Tensor, max_voxels: int) -> torch.Tensor:
    """SoftGroup's ``voxelize_fp`` mode 4: the mean of each voxel's point
    features (0 for an empty voxel); differentiable."""
    return seg.segment_mean(feats, p2v, max_voxels)
