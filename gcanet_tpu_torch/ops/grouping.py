"""Instance grouping: gated ball query + connected components + HAIS
(port of ``gcanet_tpu/ops/grouping.py``, the argmax-partition path).

One boolean ``[N, N]`` neighbour matrix per batch item covers every class:
the radius test on the shifted coordinates, class equality, and the
embedding-affinity gate folded into a distance threshold.  Its connected
components come from ``ops/cc.py`` (the hand-written CUDA sweep on a card).
Proposals are fixed-shape per-point assignment channels ordered by
(batch item, class, kept-before-primary, root index), truncated to
``max_proposals``; channel 1 carries set-aggregation absorptions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gcanet_tpu_torch.config import GroupingConfig
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.ops.knn import pairwise_sqdist

_BIG_F = 1e30
_BIG_I = 2**30


class Proposals(NamedTuple):
    """Fixed-shape proposal set over a flattened batch of B*N points.

    point_pid: [2, B*N] int32 (-1 = none); valid: [P] bool; cls, batch:
    [P] int32 (-1 if unused); size: [P] int32; num: scalar int32.
    """

    point_pid: torch.Tensor
    valid: torch.Tensor
    cls: torch.Tensor
    batch: torch.Tensor
    size: torch.Tensor
    num: torch.Tensor


def gated_neighbor_mask(shifted: torch.Tensor, cls: torch.Tensor,
                        emb: torch.Tensor, param: torch.Tensor,
                        num_classes: int, cfg: GroupingConfig):
    """One batch item's gated radius graph over all classes.

    ``shifted [N, 3]``, ``cls [N]``, ``emb [N, E]``, ``param [N, 22]`` ->
    ``(nbr [N, N] bool, class_valid [num_classes] bool)``.
    """
    n = shifted.shape[0]
    dev = shifted.device
    flat_cls = torch.clamp(cls, 0, num_classes - 1).long()
    same_class = cls[:, None] == cls[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    counts = torch.bincount(flat_cls, minlength=num_classes)
    class_valid = counts >= cfg.min_npoint
    pt_class_ok = class_valid[flat_cls]

    nbr = same_class & ~eye & (pairwise_sqdist(shifted) < cfg.radius ** 2)
    nbr &= pt_class_ok[:, None] & pt_class_ok[None, :]

    def class_gate(feats: torch.Tensor, thr: float) -> torch.Tensor:
        # aff = exp(-(d/dmax)^2/2) > thr  <=>  d^2 < dmax^2 * (-2 ln thr),
        # dmax^2 the max over same-class pairs of the point's class
        d2 = torch.clamp(pairwise_sqdist(feats), min=0.0)
        row_max = torch.where(same_class, d2, -_BIG_F).amax(dim=1)
        seg_max = torch.full((num_classes,), float("-inf"), device=dev)
        seg_max.scatter_reduce_(0, flat_cls, row_max, "amax", include_self=True)
        lim = torch.clamp(seg_max, min=0.0)[flat_cls] * (-2.0 * math.log(thr))
        return d2 < lim[:, None]

    # a threshold <= 0 passes every off-diagonal pair (exp(..) > 0)
    if cfg.similarity_threshold_inst > 0.0:
        nbr &= class_gate(emb, cfg.similarity_threshold_inst)
    if cfg.similarity_threshold_para > 0.0:
        nbr &= class_gate(param, cfg.similarity_threshold_para)
    if cfg.neighbor_cap:
        # each row keeps its first ``cap`` neighbours (bfs_cluster.cu:30):
        # the graph becomes directed
        nbr &= torch.cumsum(nbr.to(torch.int32), dim=1) <= cfg.neighbor_cap
    return nbr, class_valid


def connected_components(nbr: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Min-label propagation over ``nbr`` (row = out-edges); see ``ops/cc.py``."""
    return cc.connected_components(nbr, max_iters)


def _cc_stats(labels: torch.Tensor, shifted: torch.Tensor):
    """Per-point component size, and size and centroid at each root slot."""
    n = labels.shape[0]
    idx = labels.long()
    size_at_root = torch.zeros(n, dtype=torch.int32, device=labels.device)
    size_at_root.index_add_(0, idx, torch.ones_like(labels))
    sum_at_root = torch.zeros_like(shifted).index_add_(0, idx, shifted)
    csize = size_at_root[idx]
    center_at_root = sum_at_root / torch.clamp(size_at_root, min=1)[:, None]
    return csize, size_at_root, center_at_root


@torch.no_grad()
def build_proposals(shifted: torch.Tensor,      # [B, N, 3]
                    cls: torch.Tensor,          # [B, N] int32
                    emb: torch.Tensor,          # [B, N, E]
                    param: torch.Tensor,        # [B, N, 22]
                    num_classes: int,
                    cfg: GroupingConfig,
                    max_proposals: int,
                    using_set_aggr: bool = False) -> Proposals:
    """Full grouping pass over a batch (batch items one after another)."""
    b, n, _ = shifted.shape
    dev = shifted.device
    n_total = b * n
    if ((b * num_classes) * 2 + 1) * n_total + n_total - 1 >= 2**31:
        raise ValueError(f"proposal rank overflows int32 at B={b}, N={n}, "
                         f"C={num_classes}")
    if using_set_aggr and (cfg.absorb_fragment_cap or cfg.absorb_point_cap):
        raise NotImplementedError("absorb caps (--strict_caps) are not ported yet")

    if num_classes <= len(cfg.class_numpoint_mean):
        mean_tbl = torch.tensor(cfg.class_numpoint_mean[:num_classes],
                                dtype=torch.float32, device=dev)
    else:
        mean_tbl = torch.full((num_classes,), -1.0, device=dev)

    per_item = []
    for i in range(b):
        nbr, class_valid = gated_neighbor_mask(
            shifted[i], cls[i], emb[i], param[i], num_classes, cfg)
        if cfg.neighbor_cap:
            # directed capped graph: propagate along incoming edges
            nbr = nbr.t().contiguous()
        labels = connected_components(nbr, cfg.cc_max_iters)
        del nbr
        per_item.append((labels, *_cc_stats(labels, shifted[i]), class_valid))
    labels, csize, _, center_at_root, class_valid = (
        torch.stack(t) for t in zip(*per_item))

    flat_cls = torch.clamp(cls, 0, num_classes - 1).long()        # [B, N]
    cmean = mean_tbl[flat_cls]
    low = cfg.low_frac * cmean
    high = cfg.high_frac * cmean
    fsize = csize.to(torch.float32)
    # split_clusters (hierarchical_aggregation.cpp:53-78)
    is_primary = fsize >= high
    is_kept = (fsize >= low) & (fsize < high)
    is_fragment = fsize < high
    pt_class_ok = torch.gather(class_valid, 1, flat_cls)
    qualifies = (is_primary | is_kept) & pt_class_ok

    # ---- global proposal ordering: (batch, class, kept<primary, root) ----
    ar_n = torch.arange(n, dtype=torch.int32, device=dev)
    batch_ids = torch.arange(b, dtype=torch.int32, device=dev)[:, None].expand(b, n)
    g_labels = (labels + batch_ids * n).reshape(-1).long()
    g_is_root = (labels == ar_n[None, :]).reshape(-1)
    g_qual = qualifies.reshape(-1)
    g_cls = flat_cls.reshape(-1).to(torch.int32)
    g_primary = is_primary.reshape(-1)
    g_batch = batch_ids.reshape(-1)
    g_idx = torch.arange(n_total, dtype=torch.int64, device=dev)

    root_rank = ((g_batch.long() * num_classes + g_cls) * 2
                 + g_primary.long()) * n_total + g_idx
    root_rank = torch.where(g_is_root & g_qual, root_rank, _BIG_I)
    p = max_proposals
    pad = max(0, p - n_total)
    rank_full = torch.cat([root_rank, torch.full((pad,), _BIG_I, dtype=torch.int64,
                                                 device=dev)])
    order = torch.argsort(rank_full, stable=True)
    top_valid = rank_full[order[:p]] < _BIG_I
    top_roots = torch.clamp(order[:p], max=n_total - 1)

    # root -> pid scatter (overflow slot at n_total)
    pid_of_root = torch.full((n_total + 1,), -1, dtype=torch.int32, device=dev)
    ar_p = torch.arange(p, dtype=torch.int32, device=dev)
    pid_of_root[top_roots[top_valid]] = ar_p[top_valid]
    pid_of_root = pid_of_root[:n_total]

    pid_a = torch.where(g_qual, pid_of_root[g_labels], -1)

    prop_cls = torch.where(top_valid, g_cls[top_roots], -1)
    prop_batch = torch.where(top_valid, g_batch[top_roots], -1)
    prop_size = torch.where(top_valid, csize.reshape(-1)[top_roots], 0)
    num = top_valid.sum().to(torch.int32)

    pid_b = torch.full((n_total,), -1, dtype=torch.int32, device=dev)
    if using_set_aggr:
        # fragment_find_primary_ (hierarchical_aggregation.cu:22-75): the
        # nearest same-class same-item primary absorbs a fragment whose
        # center lies within r_set = coeff * sqrt(primary_npoint)
        g_center = center_at_root.reshape(n_total, 3)
        g_frag_root = g_is_root & is_fragment.reshape(-1) & pt_class_ok.reshape(-1)
        prop_center = g_center[top_roots]
        prop_is_primary = g_primary[top_roots] & top_valid
        d2 = torch.sum((g_center[:, None, :] - prop_center[None, :, :]) ** 2, dim=-1)
        cand = (prop_is_primary[None, :]
                & (prop_cls[None, :] == g_cls[:, None])
                & (prop_batch[None, :] == g_batch[:, None]))
        d2 = torch.where(cand, d2, _BIG_F)
        nearest = torch.argmin(d2, dim=1)
        nearest_d2 = torch.gather(d2, 1, nearest[:, None])[:, 0]
        r_set2 = (cfg.set_aggr_r_coeff ** 2) * prop_size[nearest].to(torch.float32)
        absorbed = g_frag_root & (nearest_d2 < r_set2)
        absorb_pid_at_root = torch.where(absorbed, nearest.to(torch.int32), -1)
        pid_b = absorb_pid_at_root[g_labels]
        pid_b = torch.where(is_fragment.reshape(-1) & (pid_b >= 0), pid_b, -1)

    return Proposals(point_pid=torch.stack([pid_a, pid_b]), valid=top_valid,
                     cls=prop_cls, batch=prop_batch, size=prop_size, num=num)
