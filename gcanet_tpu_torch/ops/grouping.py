"""Instance grouping (port of ``gcanet_tpu/ops/grouping.py``).

``build_proposals``, the flagship's argmax partition: one boolean ``[N, N]``
neighbour matrix per batch item covers every class (the radius test on the
shifted coordinates, class equality, and the embedding-affinity gate folded
into a distance threshold).  Proposals are fixed-shape per-point assignment
channels ordered by (batch item, class, kept-before-primary, root index),
truncated to ``max_proposals``; channel 1 carries set-aggregation
absorptions.

``build_soft_proposals``, the scene family's soft per-class grouping: one
connected-components run per grouped class per batch item over the radius
graph restricted to that class's soft subset, one channel per grouped class.

``simple_clusters``, the plain radius-graph clustering within each class
with the per-class size test.

Both proposal functions take ``chunk`` (``parallel/chunks.py``) when the
batch is one chunk of a larger one served over several devices: their
ranks are then the whole batch's, the cap keeps the batch's
``max_proposals`` smallest ranks over every chunk, and the scene family's
``min_npoint`` counts the whole batch, so each chunk keeps what one device
would keep of its items.

Connected components come from ``ops/cc.py`` (the hand-written CUDA sweep on
a card).
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

    point_pid: [CH, B*N] int32 (-1 = none; CH = 2 for ``build_proposals``,
    one per grouped class for ``build_soft_proposals``); valid: [P] bool;
    cls, batch: [P] int32 (-1 if unused); size: [P] int32; num: scalar int32.
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


def proposal_rank_bound(b: int, n: int, num_classes: int) -> int:
    """An upper bound of ``build_proposals``' ranks at ``B=b, N=n``."""
    return ((b * num_classes) * 2 + 1) * (b * n) + b * n - 1


def soft_rank_bound(b: int, n: int, grouped: int) -> int:
    """An upper bound of ``build_soft_proposals``' ranks, ``grouped`` classes."""
    return grouped * (b * n) + b * n


def check_rank_bound(bound: int, what: str) -> None:
    """Refuse a shape whose proposal ranks may reach the ``_BIG_I``
    sentinel: a rank at or above it would mark a real proposal as none.
    Checked before anything is allocated."""
    if bound >= _BIG_I:
        raise ValueError(f"{what}: ranks up to {bound} reach the sentinel 2**30; "
                         f"the shape is too large")


def _within_cap(top_rank: torch.Tensor, p: int, chunk) -> torch.Tensor:
    """Which of the ``p`` smallest ranks of a batch (or of a chunk) are
    proposals: below the sentinel, and with ``chunk`` also among the ``p``
    smallest over every chunk of the batch (the ranks are the batch's, so
    they are unique across chunks)."""
    valid = top_rank < _BIG_I
    if chunk is not None:
        everyone = torch.sort(torch.cat(chunk.all_gather(top_rank))).values
        valid &= top_rank <= everyone[p - 1].to(top_rank.device)
    return valid


def _rank_in_group(order_key: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """Each element's rank within its ``group`` when sorted by the unique
    ``order_key`` (a group's keys sort together, ahead of the next group's)."""
    order = torch.argsort(order_key)
    sorted_group = group[order]
    first = torch.searchsorted(sorted_group, sorted_group, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device) - first
    return rank


@torch.no_grad()
def build_proposals(shifted: torch.Tensor,      # [B, N, 3]
                    cls: torch.Tensor,          # [B, N] int32
                    emb: torch.Tensor,          # [B, N, E]
                    param: torch.Tensor,        # [B, N, 22]
                    num_classes: int,
                    cfg: GroupingConfig,
                    max_proposals: int,
                    using_set_aggr: bool = False, chunk=None) -> Proposals:
    """Full grouping pass over a batch (batch items one after another);
    ``chunk``: see the module docstring."""
    b, n, _ = shifted.shape
    dev = shifted.device
    n_total = b * n
    first, b_all = (chunk.offset, chunk.total) if chunk is not None else (0, b)
    check_rank_bound(proposal_rank_bound(b_all, n, num_classes),
                     f"proposal rank at B={b_all}, N={n}, C={num_classes}")

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

    root_rank = (((g_batch.long() + first) * num_classes + g_cls) * 2
                 + g_primary.long()) * (b_all * n) + g_idx + first * n
    root_rank = torch.where(g_is_root & g_qual, root_rank, _BIG_I)
    p = max_proposals
    pad = max(0, p - n_total)
    rank_full = torch.cat([root_rank, torch.full((pad,), _BIG_I, dtype=torch.int64,
                                                 device=dev)])
    order = torch.argsort(rank_full, stable=True)
    top_valid = _within_cap(rank_full[order[:p]], p, chunk)
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
        if cfg.absorb_fragment_cap:
            # hierarchical_aggregation.cu:9: a primary absorbs at most ``cap``
            # fragments, in ascending fragment-root order (the JAX package's
            # stand-in for the CUDA arrival order)
            key = torch.where(absorbed, nearest, p)
            absorbed &= _rank_in_group(key * (n_total + 1) + g_idx, key) < cfg.absorb_fragment_cap
        absorb_pid_at_root = torch.where(absorbed, nearest.to(torch.int32), -1)
        pid_b = absorb_pid_at_root[g_labels]
        pid_b = torch.where(is_fragment.reshape(-1) & (pid_b >= 0), pid_b, -1)
        if cfg.absorb_point_cap:
            # hierarchical_aggregation.cu:11: at most ``cap`` absorbed points
            # per primary, in (fragment root, point index) order
            pidk = torch.where(pid_b >= 0, pid_b, p).long()
            order_key = (pidk * n_total + g_labels) * n_total + g_idx
            pid_b = torch.where(_rank_in_group(order_key, pidk) < cfg.absorb_point_cap,
                                pid_b, -1)

    return Proposals(point_pid=torch.stack([pid_a, pid_b]), valid=top_valid,
                     cls=prop_cls, batch=prop_batch, size=prop_size, num=num)


def radius_neighbor_mask(coords: torch.Tensor, radius: float,
                         batch_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Plain radius graph over ``coords [N, 3]`` (no self edges), optionally
    within equal ``batch_ids`` only."""
    n = coords.shape[0]
    nbr = pairwise_sqdist(coords) < radius * radius
    nbr &= ~torch.eye(n, dtype=torch.bool, device=coords.device)
    if batch_ids is not None:
        nbr &= batch_ids[:, None] == batch_ids[None, :]
    return nbr



@torch.no_grad()
def simple_clusters(coords: torch.Tensor, semantic: torch.Tensor, radius: float,
                    npoint_thr: float, class_numpoint_mean, max_iters: int = 64):
    """The reference's ``bfs_cluster`` grouping: connected components of the
    radius graph within each class (the CUDA sweep on a card), keeping the
    components of at least ``npoint_thr * class_numpoint_mean[class]``
    points.  ``coords [N, 3]``, ``semantic [N]`` -> (labels ``[N]`` int32,
    the component's minimum point index or -1 where dropped; keep ``[N]``
    bool)."""
    same = semantic[:, None] == semantic[None, :]
    nbr = radius_neighbor_mask(coords, radius) & same
    labels = connected_components(nbr, max_iters)
    n = labels.shape[0]
    size = torch.zeros(n, dtype=torch.int32, device=coords.device).index_add_(
        0, labels.long(), torch.ones(n, dtype=torch.int32, device=coords.device))[labels.long()]
    mean_tbl = torch.as_tensor(class_numpoint_mean, dtype=torch.float32, device=coords.device)
    thr = npoint_thr * mean_tbl[torch.clamp(semantic, 0, mean_tbl.shape[0] - 1).long()]
    keep = size.to(torch.float32) >= thr
    return torch.where(keep, labels, -1), keep

@torch.no_grad()
def build_soft_proposals(shifted: torch.Tensor,          # [B, N, 3]
                         semantic_logits: torch.Tensor,  # [B, N, C]
                         num_classes: int,
                         cfg: GroupingConfig,
                         max_proposals: int, chunk=None) -> Proposals:
    """Soft per-class grouping (SoftGroup, softgroup/model/softgroup.py:412-481).

    For each class not in ``cfg.ignore_classes`` the clustered subset is
    ``softmax(logits)[:, c] > score_thr``, so one point may join several
    classes' clusterings.  A class is skipped when its subset has fewer than
    ``min_npoint`` points across the whole batch.  Within each batch item,
    connected components of the radius graph on the subset; a component is
    kept when its size reaches ``npoint_thr * mean[c]`` (plain
    ``npoint_thr`` where the mean is -1).  Proposals are ordered class-major,
    then by the component's global minimum point index, and truncated to
    ``max_proposals``.  ``point_pid`` has one channel per grouped class.
    ``chunk``: see the module docstring.
    """
    b, n, c_all = shifted.shape[0], shifted.shape[1], semantic_logits.shape[-1]
    dev = shifted.device
    if c_all != num_classes:
        raise ValueError(f"{c_all} logit channels for {num_classes} classes")
    n_total = b * n
    grouped = tuple(ci for ci in range(num_classes) if ci not in tuple(cfg.ignore_classes))
    gc = len(grouped)
    if gc < 1:
        raise ValueError("every class is ignored: nothing to group")
    first, b_all = (chunk.offset, chunk.total) if chunk is not None else (0, b)
    check_rank_bound(soft_rank_bound(b_all, n, gc),
                     f"soft-proposal rank at B={b_all}, N={n}, C={gc}")

    grouped_t = torch.tensor(grouped, dtype=torch.long, device=dev)
    member = torch.softmax(semantic_logits, dim=-1)[..., grouped_t] > cfg.score_thr
    count = member.sum(dim=(0, 1))                                      # [gc]
    if chunk is not None:
        count = torch.stack(chunk.all_gather(count)).sum(dim=0).to(dev)
    class_ok = count >= cfg.min_npoint

    mean_all = torch.full((num_classes,), -1.0, device=dev)
    k = min(num_classes, len(cfg.class_numpoint_mean))
    mean_all[:k] = torch.tensor(cfg.class_numpoint_mean[:k], dtype=torch.float32,
                                device=dev)
    mean_g = mean_all[grouped_t]
    thr_g = torch.where(mean_g < 0, cfg.npoint_thr, cfg.npoint_thr * mean_g)

    labels, csize = [], []
    for i in range(b):
        geo = radius_neighbor_mask(shifted[i], cfg.radius)
        for ci in range(gc):
            m = member[i, :, ci]
            lab = connected_components(geo & m[:, None] & m[None, :], cfg.cc_max_iters)
            size = torch.zeros(n, dtype=torch.int32, device=dev)
            size.index_add_(0, lab.long(), m.to(torch.int32))
            labels.append(lab)
            csize.append(size[lab.long()])
        del geo
    labels = torch.stack(labels).reshape(b, gc, n)     # per-class root: min member index
    csize = torch.stack(csize).reshape(b, gc, n)       # member count of that component

    memb = member.permute(0, 2, 1)                                      # [B, gc, N]
    keep = memb & (csize.to(torch.float32) >= thr_g[None, :, None]) & class_ok[None, :, None]

    # ---- global proposal ordering: (class, global min point index) ----
    ar_n = torch.arange(n, dtype=torch.int32, device=dev)
    groot = labels + (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None, None]
    is_root = memb & (labels == ar_n[None, None, :])

    def chan_flat(x):                  # [B, gc, N] -> [gc, B*N], channel ci = class grouped[ci]
        return x.transpose(0, 1).reshape(gc, n_total)

    f_keep = chan_flat(keep)
    f_root = chan_flat(is_root & keep)
    f_groot = chan_flat(groot).long()
    f_size = chan_flat(csize)

    ci_idx = torch.arange(gc, dtype=torch.long, device=dev)[:, None]
    key = ci_idx * n_total + f_groot                                    # [gc, B*N]
    rank = torch.where(f_root, key, _BIG_I).reshape(-1)
    p = max_proposals
    pad = max(0, p - gc * n_total)
    rank_full = torch.cat([rank, torch.full((pad,), _BIG_I, dtype=torch.long, device=dev)])
    order = torch.argsort(rank_full, stable=True)
    top_rank = rank_full[order[:p]]
    if chunk is not None:               # the batch's rank: (class, root over the batch)
        top_rank = torch.where(top_rank < _BIG_I, top_rank // n_total * (b_all * n)
                               + first * n + top_rank % n_total, _BIG_I)
    top_valid = _within_cap(top_rank, p, chunk)
    top_entry = torch.clamp(order[:p], max=gc * n_total - 1)

    # (channel, groot) -> pid table with an overflow slot for unused pids
    slot = (top_entry // n_total) * n_total + f_groot.reshape(-1)[top_entry]
    pid_tbl = torch.full((gc * n_total + 1,), -1, dtype=torch.int32, device=dev)
    ar_p = torch.arange(p, dtype=torch.int32, device=dev)
    pid_tbl[torch.where(top_valid, slot, gc * n_total)] = torch.where(top_valid, ar_p, -1)
    point_pid = torch.where(f_keep, pid_tbl[key], -1)

    f_cls = grouped_t.to(torch.int32)[:, None].expand(gc, n_total).reshape(-1)
    f_batch = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n)
    f_batch = f_batch[None, :].expand(gc, n_total).reshape(-1)
    return Proposals(point_pid=point_pid,
                     valid=top_valid,
                     cls=torch.where(top_valid, f_cls[top_entry], -1),
                     batch=torch.where(top_valid, f_batch[top_entry], -1),
                     size=torch.where(top_valid, f_size.reshape(-1)[top_entry], 0),
                     num=top_valid.sum().to(torch.int32))
