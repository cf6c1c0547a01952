"""Point-axis-sharded kNN: the port's sequence parallelism (port of
``gcanet_tpu/parallel/sharded_knn.py``).

One cloud's points are cut into ``d`` equal shards, shard ``s`` resident on
``devices[s]``.  The queries stay where they are; the key blocks travel a
ring: at step ``t`` shard ``s`` holds key block ``(s - t) % d``, computes an
``[N/d, N/d]`` distance tile against it, merges the tile into its running
top-k, and the blocks then move one hop, from shard ``s`` to shard
``(s + 1) % d``.  The largest distance matrix is ``[N/d, N/d]`` rather than
``[N, N]``.

The JAX package runs the ring as one ``shard_map`` program over a mesh with
``lax.ppermute``; here one process drives the ``d`` devices (as the port's
serving does, ``parallel/chunks.py``) and a hop is ``.to(next device,
non_blocking=True)``: a peer copy between two cards, nothing on one card.
Every step is enqueued without a host sync (no ``.item()``, no read of a
flag), so the shards' work overlaps on several cards.  Equal devices are
allowed; the arithmetic is then still the ring's, tile by tile.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from gcanet_tpu_torch.ops import knn as knn_ops

Metric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _hop(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """The ring's ``ppermute``: block ``s`` moves to shard ``(s + 1) % d``."""
    d = len(blocks)
    return [blocks[(s - 1) % d].to(blocks[s].device, non_blocking=True) for s in range(d)]


def _check_shards(shards: Sequence[torch.Tensor]) -> int:
    rows = {int(x.shape[0]) for x in shards}
    if len(rows) != 1:
        raise ValueError(f"the shards must hold equal numbers of points, got {sorted(rows)}")
    return rows.pop()


@torch.no_grad()
def ring_knn(shards: Sequence[torch.Tensor], k: int,
             metric: Metric | None = None) -> List[torch.Tensor]:
    """``shards``: ``d`` query shards ``[N/d, C]``, shard ``s`` on its own
    device.  Returns, per shard, the GLOBAL indices ``[N/d, k]`` (int64) of
    each point's ``k`` nearest under ``metric(q_block, key_block) -> [nq,
    nk]`` (default squared euclidean, ``ops/knn.py::pairwise_sqdist``),
    nearest first.  Index ``g`` is point ``g % (N/d)`` of shard ``g // (N/d)``.

    Each step concatenates the running best distances with the tile, keeps
    the ``k`` smallest and takes their indices along (JAX: ``concatenate`` +
    ``top_k`` + ``take_along_axis``); a position past the first ``k`` columns
    is the tile's column ``pos - k``, whose global index is ``src * N/d +
    pos - k``, so the index tile is never built."""
    if metric is None:
        metric = knn_ops.pairwise_sqdist
    d = len(shards)
    nl = _check_shards(shards)
    keys = list(shards)
    best_d = [torch.full((nl, k), float("inf"), dtype=torch.float32, device=x.device)
              for x in shards]
    best_i = [torch.zeros((nl, k), dtype=torch.int64, device=x.device) for x in shards]
    for t in range(d):
        for s, xq in enumerate(shards):
            src = (s - t) % d
            cat_d = torch.cat([best_d[s], metric(xq, keys[s]).float()], dim=1)
            best_d[s], pos = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
            del cat_d
            kept = torch.gather(best_i[s], 1, pos.clamp(max=k - 1))
            best_i[s] = torch.where(pos < k, kept, pos + (src * nl - k))
        if t + 1 < d:
            keys = _hop(keys)
    return best_i


@torch.no_grad()
def ring_gather(val_shards: Sequence[torch.Tensor],
                gidx_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Rows of the point-sharded values at GLOBAL indices: ``val_shards``
    ``[N/d, C]`` per shard, ``gidx_shards`` ``[..., K]`` per shard (each on
    its shard's device) -> ``[..., K, C]`` per shard.  The value blocks
    travel the ring; each step fills the entries whose source block is
    resident (JAX: ``where(sel, keys[loc], out)``)."""
    d = len(val_shards)
    nl = _check_shards(val_shards)
    keys = list(val_shards)
    out = [v.new_zeros(g.shape + v.shape[-1:]) for v, g in zip(val_shards, gidx_shards)]
    for t in range(d):
        for s, g in enumerate(gidx_shards):
            src = (s - t) % d
            sel = (g // nl) == src
            loc = (g - src * nl).clamp(0, nl - 1)
            out[s] = torch.where(sel[..., None], keys[s][loc], out[s])
        if t + 1 < d:
            keys = _hop(keys)
    return out


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device | str]) -> List[torch.Tensor]:
    """``x [N, ...]`` cut into ``len(devices)`` contiguous shards, shard ``s``
    on ``devices[s]``; ``N`` must divide by the device count."""
    d = len(devices)
    if x.shape[0] % d:
        raise ValueError(f"N={x.shape[0]} points do not shard over {d} devices")
    nl = x.shape[0] // d
    return [x[s * nl:(s + 1) * nl].to(dev, non_blocking=True) for s, dev in enumerate(devices)]


def sharded_knn(x: torch.Tensor, k: int, devices: Sequence[torch.device | str],
                metric: Metric | None = None) -> torch.Tensor:
    """The whole ring from a global cloud: ``x [N, C]`` -> global top-k
    indices ``[N, k]`` on ``x``'s device (JAX ``make_sharded_knn``).  ``N``
    must divide by ``len(devices)``."""
    idx = ring_knn(shard_rows(x, devices), k, metric)
    return torch.cat([i.to(x.device) for i in idx])
