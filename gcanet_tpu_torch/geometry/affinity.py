"""Geometric-consistency affinities, spectral helpers and mean shift (port
of ``gcanet_tpu/geometry/affinity.py``).

  * ``construction_affinity_matrix_type``: per predicted type, the
    point-to-primitive distance (or a sampled-spline chamfer) -> Gaussian
    affinity -> D^-1/2 symmetric normalisation.
  * ``construction_affinity_matrix_normal``: kNN normal-angle affinity.
  * ``mean_shift``: flat-kernel mean shift on the input's device, with the
    labels of sklearn's ``MeanShift(bandwidth, bin_seeding=False)``.
  * ``compute_entropy``, ``map_type_gt``.
"""

from __future__ import annotations

import math

import torch

from gcanet_tpu_torch.geometry import primitive_dis as pdis
from gcanet_tpu_torch.ops import knn as knn_ops

PARAM_SLICES = {5: (0, 4), 1: (4, 8), 4: (8, 15), 3: (15, 22)}

# elements of one float64 [rows, N] block of mean-shift distances (512 MB)
_BLOCK = 2**26


def map_type_gt(t: torch.Tensor) -> torch.Tensor:
    t = torch.where((t == 0) | (t == 6) | (t == 7), 9, t)
    return torch.where(t == 8, 2, t)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values to 0.  The JAX package computes with subnormals
    flushed to zero (XLA on the CPU and the TPU), and ``aff > 0`` picks how
    a pair is averaged, so the port flushes where its affinities can fall
    below the smallest normal float: the exponentials and the scaling."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


def _sym_normalize(affinity: torch.Tensor) -> torch.Tensor:
    """exp already applied; D^-1/2 A D^-1/2, then symmetrise."""
    d = torch.sum(affinity, -1)
    dinv = 1.0 / torch.sqrt(torch.clamp(d, min=1e-12))
    aff = _flush(_flush(affinity * dinv[..., :, None]) * dinv[..., None, :])
    mask = (aff > 0).to(aff.dtype)
    return (aff + aff.transpose(-1, -2)) / torch.clamp(mask + mask.transpose(-1, -2), 1.0, 2.0)


def _type_columns(t_pred: torch.Tensor, typ: int, min_points: int) -> torch.Tensor:
    """[B, N]: the columns of type ``typ`` in items holding >= min_points of it."""
    col_is_type = t_pred == typ
    return col_is_type & (col_is_type.sum(-1) >= min_points)[:, None]


def construction_affinity_matrix_type(inputs_xyz: torch.Tensor, type_per_point: torch.Tensor,
                                      t_param_pred: torch.Tensor, sigma: float = 1.0,
                                      min_points: int = 30, spline_samples=None) -> torch.Tensor:
    """inputs_xyz [B, N, 3]; type_per_point [B, N, C] scores or [B, N] ids;
    params [B, N, 22] -> [B, N, N].

    For the analytic types (plane, sphere, cylinder, cone) column j holds
    the distance of every point to point j's predicted primitive.  Spline
    types need sampled surfaces, ``spline_samples = {2: [B, M, 3], 9: [B,
    M, 3]}``; without them their columns stay background.
    """
    t_pred = map_type_gt(type_per_point.argmax(-1) if type_per_point.dim() == 3
                         else type_per_point)
    b, n = t_pred.shape
    dist = torch.full((b, n, n), -1.0, dtype=torch.float32, device=inputs_xyz.device)
    for typ, (lo, hi) in PARAM_SLICES.items():
        use = _type_columns(t_pred, typ, min_points)
        for i in range(b):
            d = pdis.ROUTINES[typ](inputs_xyz[i], t_param_pred[i, :, lo:hi])    # [N, M=N]
            dist[i] = torch.where(use[i][None, :], d, dist[i])
    for typ, samples in (spline_samples or {}).items():
        use = _type_columns(t_pred, typ, min_points)
        d_col = torch.stack([pdis.distance_from_bspline(inputs_xyz[i], samples[i])
                             for i in range(b)])                               # [B, N]
        dist = torch.where(use[:, None, :], d_col[:, :, None], dist)

    background = dist == -1.0
    aff = _flush(torch.exp(-dist**2 / (2 * sigma * sigma)))
    aff = torch.where(background, 1e-12, aff)
    return _sym_normalize(aff)


def construction_affinity_matrix_normal(inputs_xyz: torch.Tensor, normals: torch.Tensor,
                                        sigma: float = 0.1, knn: int = 50) -> torch.Tensor:
    """kNN normal-angle affinity, ``[B, N, 3]`` x2 -> ``[B, N, N]``."""
    b, n, _ = inputs_xyz.shape
    dev = inputs_xyz.device
    idx = knn_ops.knn_indices(inputs_xyz, knn)                 # [B, N, K]
    n_sub = knn_ops.gather_neighbors(normals, idx)             # [B, N, K, 3]
    ang = torch.arccos(torch.clamp(torch.sum(normals[:, :, None, :] * n_sub, -1),
                                   -0.99, 0.99))
    dst = _flush(torch.exp(-ang**2 / (2 * sigma * sigma)))     # [B, N, K]

    aff = torch.zeros((b, n, n), dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None].expand_as(idx)
    ri = torch.arange(n, device=dev)[None, :, None].expand_as(idx)
    aff.index_put_((bi, ri, idx), dst, accumulate=True)
    aff = torch.where(aff == 0, 1e-12, aff)
    aff = _sym_normalize(aff)

    # the second normalisation pass: off-diagonal min-max, then a Gaussian
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj = torch.where(eye, 0.0, aff)
    lo, hi = torch.amin(adj), torch.amax(adj)
    adj = (adj - lo) / torch.clamp(hi - lo, min=1e-12)
    adj = torch.exp(-adj**2 / 2.0)
    return torch.where(eye, 0.0, adj)


def _sqdist64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[M, N]`` of float64 rows, by the expansion (exact
    to float64 rounding for float32 inputs)."""
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)


def _row_blocks(rows: torch.Tensor, n: int):
    return rows.split(max(1, _BLOCK // max(n, 1)))


def _greedy_keep(centres: torch.Tensor, r2: float) -> torch.Tensor:
    """sklearn's de-duplication of centres sorted by priority: a centre is
    kept unless an earlier kept one lies within the bandwidth.  Decided in
    rounds on the device: a centre whose earlier neighbours are all decided
    is removed if one of them is kept, else kept.  One host read a round."""
    k = centres.shape[0]
    cd = centres.double()
    near = torch.cat([_sqdist64(block, cd) <= r2 for block in _row_blocks(cd, k)])
    earlier = near & torch.ones_like(near).tril(-1)
    kept = torch.zeros(k, dtype=torch.bool, device=centres.device)
    removed = torch.zeros_like(kept)
    while True:
        undecided = ~(kept | removed)
        hit = (earlier & kept).any(1)
        wait = (earlier & undecided).any(1)
        removed = removed | (undecided & hit)
        kept = kept | (undecided & ~hit & ~wait)
        mean_shift.host_syncs += 1
        if bool((kept | removed).all()):
            return kept


def _mean_shift_one(x: torch.Tensor, bandwidth: float, max_iter: int):
    """One item's fit -> (labels [N] int64, its iteration count)."""
    n = x.shape[0]
    xd = x.double()
    r2 = float(bandwidth) ** 2
    stop = 1e-3 * bandwidth
    means = x.clone()
    intensity = torch.zeros(n, dtype=torch.int64, device=x.device)
    live = torch.arange(n, device=x.device)
    for it in range(max_iter + 1):
        new, cnt = [], []
        for block in _row_blocks(live, n):
            m = means[block].double()
            within = _sqdist64(m, xd) <= r2
            cnt.append(within.sum(1))
            new.append((within.double() @ xd / cnt[-1][:, None]).to(x.dtype))
        new, cnt = torch.cat(new), torch.cat(cnt)
        empty = cnt == 0
        shift = torch.linalg.vector_norm(new - means[live], dim=1)
        means[live] = torch.where(empty[:, None], means[live], new)
        intensity[live] = cnt
        done = empty | (shift <= stop) | (it == max_iter)
        live = live[~done]
        mean_shift.host_syncs += 1
        if live.numel() == 0:
            break

    valid = intensity > 0
    seeds = torch.arange(n, device=x.device)[valid]
    mean_shift.host_syncs += 1
    if seeds.numel() == 0:
        raise ValueError(f"No point was within bandwidth={bandwidth} of any seed")
    # seeds whose means are equal tuples are one centre, holding the last
    # such seed's intensity; unique() sorts the centres ascending
    centres, inverse = torch.unique(means[seeds], dim=0, return_inverse=True)
    mean_shift.host_syncs += 1
    last = torch.full((centres.shape[0],), -1, dtype=torch.int64, device=x.device)
    last.scatter_reduce_(0, inverse, seeds, "amax")
    # descending by (intensity, centre): reverse the ascending tuples, then a
    # stable sort by intensity
    rev = torch.arange(centres.shape[0] - 1, -1, -1, device=x.device)
    order = rev[torch.sort(intensity[last[rev]], descending=True, stable=True).indices]
    ordered = centres[order]
    kept = ordered[_greedy_keep(ordered, r2)]
    mean_shift.host_syncs += 1
    kd = kept.double()
    labels = torch.cat([_sqdist64(block, kd).argmin(1) for block in _row_blocks(xd, kd.shape[0])])
    return labels, it


def mean_shift(x: torch.Tensor, bandwidth: float, max_iter: int = 300) -> torch.Tensor:
    """Flat-kernel mean shift of each batch item, ``x [B, N, F]`` -> labels
    ``[B, N]`` int64, on ``x``'s device.

    The semantics of sklearn's ``MeanShift(bandwidth, bin_seeding=False,
    cluster_all=True, max_iter=300)``: every point is a seed; a seed's mean
    moves to the mean of the points within ``bandwidth`` (distance <=) until
    it moves by at most ``1e-3 * bandwidth``, or after ``max_iter + 1``
    updates; its intensity is the size of the last neighbourhood it
    averaged.  Equal final means merge; the centres, in descending order of
    (intensity, centre), are de-duplicated greedily within ``bandwidth``;
    every point takes the nearest kept centre.  Distances are float64.

    All live seeds of an item move at once, in row blocks of at most
    ``_BLOCK`` distances.  ``mean_shift.host_syncs`` counts the host reads
    (one per iteration, one per de-duplication round, three more per item);
    ``mean_shift.iterations`` is the last call's largest iteration count
    (the sklearn fit's ``n_iter_``).
    """
    fits = [_mean_shift_one(item, bandwidth, max_iter) for item in x]
    mean_shift.iterations = max(it for _, it in fits)
    return torch.stack([labels for labels, _ in fits])


mean_shift.host_syncs = 0
mean_shift.iterations = 0


def compute_entropy(features: torch.Tensor) -> torch.Tensor:
    """features [1, N, K] -> scalar."""
    feat = features[0]
    n, k = feat.shape
    diff = feat[:, None, :] - feat[None, :, :]
    flat = diff.reshape(-1, k)
    interval = torch.amax(flat, 0) - torch.amin(flat, 0)
    dst = torch.sqrt(torch.clamp(torch.sum((diff / interval) ** 2, -1), min=1e-24))
    average_dst = torch.sum(dst) / (n * n)
    alpha = -math.log(0.5) / average_dst
    s = torch.exp(-alpha * dst)
    eps = 1e-7
    entropy = -s * torch.log(s + eps) - (1 - s) * torch.log(1 - s + eps)
    return torch.sum(entropy) / (n * n)
