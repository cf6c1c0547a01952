"""Segment reductions over proposal/instance assignments (port of
``gcanet_tpu/ops/segment.py``).

Membership is a per-element integer segment id; ids outside
``[0, num_segments)`` (e.g. -1 = unassigned) go to an overflow bucket that is
dropped.  Empty segments give 0 for sums/counts, +inf for ``segment_min`` and
-inf for ``segment_max`` (the identities ``jax.ops.segment_*`` use).
"""

from __future__ import annotations

import torch

_BIG = 1e30


def _sanitize(seg_ids: torch.Tensor, num_segments: int):
    valid = (seg_ids >= 0) & (seg_ids < num_segments)
    return torch.where(valid, seg_ids, num_segments).long(), valid


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids, valid = _sanitize(seg_ids, num_segments)
    mask = valid[..., None] if data.dim() > seg_ids.dim() else valid
    data = torch.where(mask, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def segment_count(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids, valid = _sanitize(seg_ids, num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=seg_ids.device)
    return out.index_add_(0, ids, valid.to(torch.int32))[:num_segments]


def segment_mean(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment feature mean; zero for empty segments."""
    s = segment_sum(data, seg_ids, num_segments)
    n = segment_count(seg_ids, num_segments)
    return s / torch.clamp(n, min=1)[:, None].to(s.dtype)


def _segment_extreme(data, seg_ids, num_segments, reduce, fill, identity):
    ids, valid = _sanitize(seg_ids, num_segments)
    data = torch.where(valid[..., None], data, fill)
    out = torch.full((num_segments + 1, *data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    index = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, index, data, reduce, include_self=True)[:num_segments]


def segment_min(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, seg_ids, num_segments, "amin", _BIG, float("inf"))


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, seg_ids, num_segments, "amax", -_BIG, float("-inf"))
