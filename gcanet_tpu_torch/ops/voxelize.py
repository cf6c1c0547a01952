"""Proposal voxelisation for the instance head (port of
``gcanet_tpu/ops/voxelize.py::clusters_voxelization``).

Each proposal's points are rescaled into a dense G^3 grid
(dgcnn-4.py:1300-1355); voxel features are the scatter-mean of the point
features, so the gradient of the voxel features flows back into the point
features.  Training shifts every grid by a random offset
(``rand_quantize``).
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
                          generator: torch.Generator | None = None,
                          scale: float | None = None) -> VoxelizedProposals:
    """``rand_quantize`` shifts each proposal's grid by one ``[2, 3]``
    uniform draw shared by every proposal (``torch.rand(3)`` at
    dgcnn-4.py:1341-1342): ``r1`` when given, else drawn from
    ``generator`` (which must live on ``coords``' device)."""
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
        if r1 is None:
            r1 = torch.rand((2, 3), generator=generator, device=coords.device)
        r1 = r1.to(cmin)
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
