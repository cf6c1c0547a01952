"""Point-axis-sharded trunk forward: ring kNN's consumer (port of
``gcanet_tpu/parallel/sharded_encoder.py``).

Per-point semantics for one cloud larger than a device's working set (the
``[N, K, C]`` edge tensors and the ``[N, N]`` distance matrix): the point
axis is cut into ``d`` shards, one per device, neighbour search is the ring
kNN (tiles of ``[N/d, N/d]``) and the neighbour gathers stream the value
blocks around the same ring (``parallel/sharded_knn.py``).  The per-point
half of the flagship runs with the model's own weights: the encoder (three
edge convs and the global-max MLP, the max taken over every shard), the
trunk, the type, param and normal-angle embedding heads.  Grouping and
instance extraction stay single-device paths.

GroupNorm couples every point of the cloud, so its statistics are summed
over the shards: each shard's ``[2, groups]`` moments go to the first
device, are added, and come back.  The normalisation is the JAX one-pass
``E[x^2] - E[x]^2`` (clamped at 0, eps 1e-5), not the model's two-pass
``GroupNorm``, so that the two sharded programs round alike.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gcanet_tpu_torch.models.layers import GroupNorm, leaky_relu
from gcanet_tpu_torch.models.primitive_net import canonicalize_params
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.parallel.sharded_knn import ring_gather, ring_knn

Shards = List[torch.Tensor]

GN_EPS = 1e-5


def posnormal_metric(xq: torch.Tensor, xk: torch.Tensor) -> torch.Tensor:
    """Two-block form of the position-normal metric (dgcnn-4.py:50-90;
    ``ops/knn.py::pairwise_dist_points_normals``) on ``[.., 6]`` blocks (xyz
    ++ normal): ``d_pos^2 * (1 + (2 - 2 n_i . n_j))``."""
    pd = knn_ops.pairwise_sqdist(xq[..., :3], xk[..., :3])
    nd = 2.0 - 2.0 * torch.matmul(xq[..., 3:6].float(), xk[..., 3:6].float().transpose(-1, -2))
    return pd * (1.0 + nd)


def _to_each(t: torch.Tensor, like: Shards) -> Shards:
    return [t.to(x.device, non_blocking=True) for x in like]


def gn_sharded(gns: Sequence[GroupNorm], xs: Shards) -> Shards:
    """GroupNorm with statistics over the GLOBAL point axis: ``xs`` are the
    batchless shards ``[N/d(, K), C]``, ``gns`` the shards' copies of one
    ``GroupNorm`` (its groups, weight and bias)."""
    groups = gns[0].num_groups
    home = xs[0].device
    total, count = None, 0
    for x in xs:
        xg = x.reshape(-1, groups, x.shape[-1] // groups)
        mom = torch.stack([xg.sum(dim=(0, 2)), (xg * xg).sum(dim=(0, 2))])
        mom = mom.to(home, non_blocking=True)
        total = mom if total is None else total + mom
        count += xg.shape[0] * xg.shape[2]
    mean = total[0] / count
    var = torch.clamp(total[1] / count - mean * mean, min=0.0)
    scale = torch.rsqrt(var + GN_EPS)
    out = []
    for gn, x, m, r in zip(gns, xs, _to_each(mean, xs), _to_each(scale, xs)):
        xg = x.reshape(-1, groups, x.shape[-1] // groups)
        xn = ((xg - m[:, None]) * r[:, None]).reshape(x.shape)
        out.append(xn * gn.weight + gn.bias)
    return out


def _linear(denses: Sequence[nn.Linear], xs: Shards) -> Shards:
    return [F.linear(x, m.weight, m.bias) for m, x in zip(denses, xs)]


def dense_gn(denses: Sequence[nn.Linear], gns: Sequence[GroupNorm], xs: Shards) -> Shards:
    """Dense (with its bias) + GroupNorm with statistics over every shard."""
    return gn_sharded(gns, _linear(denses, xs))


def _relu(xs: Shards) -> Shards:
    return [torch.relu(x) for x in xs]


def _conv_gn_act_max(denses, gns, xs: Shards) -> Shards:
    """1x1 conv (no bias) + sharded GroupNorm + LeakyReLU(0.2), then the
    max over the K neighbours: ``[N/d, K, C]`` -> ``[N/d, C']``."""
    return [leaky_relu(h).amax(dim=1) for h in dense_gn(denses, gns, xs)]


def _edge_conv(convs, gns, xs: Shards, k: int) -> Shards:
    """One edge conv over the ring: kNN in feature space, then the split
    kernel ``a = x W1``, ``c = x (W2 - W1)`` (``models/dgcnn.py::edge_conv``)
    with ``a`` ring-gathered at the neighbours."""
    idx = ring_knn(xs, k)
    c_in = xs[0].shape[-1]
    a = [x @ m.weight[:, :c_in].t() for m, x in zip(convs, xs)]
    ctr = [x @ (m.weight[:, c_in:] - m.weight[:, :c_in]).t() for m, x in zip(convs, xs)]
    h = [g + c[:, None, :] for g, c in zip(ring_gather(a, idx), ctr)]
    return [leaky_relu(y).amax(dim=1) for y in gn_sharded(gns, h)]


@torch.no_grad()
def sharded_type_forward(model_per_device: Sequence[nn.Module],
                         x6_shards: Shards) -> Tuple[Shards, Shards, Shards]:
    """Per-point ``(type_per_point [N/d, C], param_per_point [N/d, 22],
    embedding [N/d, out_dim])`` per shard, for ``x6_shards`` the ``d``
    shards ``[N/d, 6]`` (xyz ++ normal) of one cloud, shard ``s`` on its own
    device; ``model_per_device[s]`` is the flagship ``PrimitiveNet`` on
    shard ``s``'s device (one module may serve several equal devices).  The
    body of JAX ``make_sharded_type_fn``: mode 5 only, without
    ``shared_graph``; exact kNN."""
    models = list(model_per_device)
    cfg = models[0].cfg
    if cfg.mode != 5 or cfg.shared_graph:
        raise ValueError("the sharded trunk supports only mode 5 without shared_graph "
                         f"(got mode={cfg.mode}, shared_graph={cfg.shared_graph})")
    if len(models) != len(x6_shards):
        raise ValueError(f"{len(models)} models for {len(x6_shards)} shards")

    def mods(name: str) -> List[nn.Module]:
        return [m.get_submodule(name) for m in models]

    xs = [x.float() for x in x6_shards]
    k = cfg.nn_nb
    k2 = min(cfg.nn_nb_inner, k) if cfg.nn_nb_inner else k

    # encoder layer 1: position-normal ring kNN, the gathered neighbours
    # shared with the embedding head's normal-angle feature
    idx1 = ring_knn(xs, k, metric=posnormal_metric)
    nbr1 = ring_gather(xs, idx1)                                   # [N/d, K, 6]
    ef = [knn_ops.edge_feature_from_gathered(x[None], n[None])[0] for x, n in zip(xs, nbr1)]
    x1 = _conv_gn_act_max([c[0] for c in mods("encoder.conv1")], mods("encoder.bn1"), ef)
    x2 = _edge_conv([c[0] for c in mods("encoder.conv2")], mods("encoder.bn2"), x1, k2)
    x3 = _edge_conv([c[0] for c in mods("encoder.conv3")], mods("encoder.bn3"), x2, k2)
    xf = [torch.cat(parts, dim=-1) for parts in zip(x1, x2, x3)]  # [N/d, 256]
    x4 = _relu(dense_gn(mods("encoder.mlp1"), mods("encoder.bnmlp1"), xf))
    home = xs[0].device
    gmax = torch.stack([h.amax(dim=0).to(home, non_blocking=True) for h in x4]).amax(dim=0)
    feats = [torch.cat([g.expand(f.shape[0], -1), f], dim=-1)
             for g, f in zip(_to_each(gmax, xs), xf)]              # [N/d, 1280]

    # trunk and heads (primitive_net.py)
    t = _relu(dense_gn(mods("conv1"), mods("bn1"), feats))
    x_all = _relu(dense_gn(mods("conv2"), mods("bn2"), t))
    x_type = _relu(dense_gn(mods("mlp_prim_prob1"), mods("bn_prim_prob1"), x_all))
    logits = _linear(mods("mlp_prim_prob2"), x_type)
    type_pp = ([torch.log_softmax(z, dim=-1) for z in logits] if "r" in cfg.loss_class
               else logits)
    x_para = _relu(dense_gn(mods("mlp_param_prob1"), mods("bn_param_prob1"), x_all))
    param_pp = [canonicalize_params(p) for p in _linear(mods("mlp_param_prob2"), x_para)]

    # embedding head, its normal-angle feature from the layer-1 gather
    nf = [knn_ops.edge_feature_normals_g_from_gathered(x[None], n[None])[0]
          for x, n in zip(xs, nbr1)]
    normal_feature = _conv_gn_act_max([c[0] for c in mods("conv_normal")],
                                      mods("bn_normal"), nf)
    emb_in = [torch.cat(parts, dim=-1) for parts in zip(x_all, x_type, x_para, normal_feature)]
    he = _relu(dense_gn(mods("mlp_seg_prob1"), mods("bn_seg_prob1"), emb_in))
    emb = _linear(mods("mlp_seg_prob2"), he)
    return type_pp, param_pp, emb
