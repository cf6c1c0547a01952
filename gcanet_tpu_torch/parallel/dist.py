"""Process groups and cross-process helpers (port of
``gcanet_tpu/parallel/dist.py``).

Training, evaluation and the bench run data-parallel as one process per
device under ``torch.distributed``: the JAX package's multi-process mesh.
``mesh_shape = N`` > 1 needs an initialised group of world ``N``, as
``torchrun --nproc_per_node N`` makes one (``maybe_init_from_env``);
nothing here starts processes.  Each rank holds a replica of the model and
its contiguous chunk of every global batch; the train step averages the
gradients, the losses and the batch statistics over the group in one
``all_reduce`` (``all_reduce_mean``), as the JAX step's ``pmean`` does.

The backend is chosen once, explicitly (``default_backend``): NCCL for CUDA
tensors where every rank of a host has a card of its own (with gloo beside
it for CPU tensors), gloo on the CPU and where ranks share a card (NCCL
refuses two ranks on one card; ``check_devices`` raises before it would).
On CUDA tensors only ``all_reduce`` and ``broadcast`` are used, which gloo
supports; Python objects (``collect_results``, ``AverageMeter``) travel as
CPU tensors.
"""

from __future__ import annotations

import os
import pickle
import socket
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch
import torch.distributed as dist


def default_backend() -> str:
    """``"cpu:gloo,cuda:nccl"`` when every local rank (``LOCAL_WORLD_SIZE``)
    has a card of its own, else ``"gloo"``."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_dist(coordinator: str | None = None, num_processes: int = 1, process_id: int = 0,
              backend: str | None = None) -> None:
    """Join a group of ``num_processes`` (no-op for one).  ``coordinator``
    is ``host:port`` or an init URL (``tcp://...``, ``env://``); ``backend``
    defaults to ``default_backend()``.  Reference:
    softgroup/util/dist.py:34-37 ``init_dist('nccl')``."""
    if num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("a group of several processes needs a coordinator address")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(), init_method=url,
                            world_size=num_processes, rank=process_id)


def maybe_init_from_env() -> bool:
    """Join the group the launcher describes: torchrun's ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, or the JAX package's
    ``GCA_NUM_PROCESSES``, ``GCA_PROCESS_ID``, ``GCA_COORDINATOR``
    (``host:port``).  Returns True when it initialised a group; False when
    there is one process or a group exists already."""
    env = os.environ
    if dist.is_initialized():
        return False
    world = int(env.get("WORLD_SIZE", "1"))
    if world > 1:
        init_dist(f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}", world,
                  int(env["RANK"]))
        return True
    n = int(env.get("GCA_NUM_PROCESSES", "1"))
    if n > 1:
        coordinator = env.get("GCA_COORDINATOR")
        if not coordinator:
            raise ValueError("GCA_NUM_PROCESSES > 1 requires GCA_COORDINATOR=host:port "
                             "(and GCA_PROCESS_ID per process)")
        init_dist(coordinator, n, int(env.get("GCA_PROCESS_ID", "0")))
        return True
    return False


def shard_bounds(batch_size: int, rank: int, world: int):
    """This process's contiguous ``[start, stop)`` slice of the global
    batch; raises when the batch does not split evenly."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"process_count {world}")
    local = batch_size // world
    return rank * local, (rank + 1) * local


def get_dist_info():
    """``(rank, world_size)`` of the default group; ``(0, 1)`` without one
    (softgroup/util/dist.py:40-48)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return get_dist_info()[0] == 0


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK``, else its rank."""
    return int(os.environ.get("LOCAL_RANK", get_dist_info()[0]))


def mesh_size(cfg) -> int:
    """``cfg.mesh_shape`` as a device count (a non-number is 1, as in JAX)."""
    return int(cfg.mesh_shape) if str(cfg.mesh_shape).isdigit() else 1


def data_parallel_world(cfg) -> int:
    """The data-parallel world that ``cfg`` trains, evaluates or benches
    on: 1, or ``mesh_shape`` when this process is in a group of that size.
    Raises when the two differ: ``mesh_shape = N`` > 1 runs one process per
    device and nothing here starts them (the counterpart of ``make_mesh``
    refusing a smaller mesh, ``gcanet_tpu/train/step.py:131-135``)."""
    n = mesh_size(cfg)
    world = get_dist_info()[1]
    if n != world:
        raise ValueError(
            f"mesh_shape={cfg.mesh_shape} trains one process per device, but this "
            f"process is in a group of {world}: launch it as torchrun --nproc_per_node {n} "
            f"(or call init_dist) with --mesh_shape equal to the world size")
    return n


def rank_device(device: str | torch.device | None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``,
    which must exist."""
    if device is not None:
        return torch.device(device)
    index = local_rank()
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"rank {get_dist_info()[0]}'s default device cuda:{index} does "
                           f"not exist ({count} visible); pass device=")
    return torch.device("cuda", index)


def check_devices(device: torch.device) -> None:
    """Raise when this group's backend is NCCL and two of its ranks sit on
    one card of one host, which NCCL refuses: use gloo there
    (``init_dist(..., backend="gloo")``)."""
    if get_dist_info()[1] == 1 or "nccl" not in str(dist.get_backend()):
        return
    mine = f"{socket.gethostname()}/{device}"
    seen = collect_results([mine])
    if seen.count(mine) > 1:
        raise ValueError(f"ranks {[i for i, s in enumerate(seen) if s == mine]} share "
                         f"{device} under NCCL, which refuses that; use the gloo backend")


def pick_device(device: str | torch.device | None, world: int, what: str) -> torch.device:
    """The device ``what`` (a trainer, the bench) runs on: ``device``, by
    default ``cuda`` on one device and ``rank_device`` in a group of
    ``world`` > 1, where ``check_devices`` must pass.  Raises when the
    default is a card and none is present."""
    if world > 1:
        dev = rank_device(device)
        check_devices(dev)
        return dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on cuda by default and no CUDA device is "
                           f"available; pass device='cpu' to run it on the CPU")
    return dev


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """In place, each tensor becomes its mean over the group (JAX's
    ``pmean``: the sum over ranks, divided by the world size), all of them
    in one ``all_reduce`` of one flat float32 buffer on their device."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, as
    ``replicate_to_mesh`` replicates one state."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def local_shard(batch: Mapping[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """This rank's contiguous part of every entry of a global collated
    numpy batch along its leading axis (``[B, ...]`` or ``[B *
    max_instances, ...]``; ``index`` lists too): what ``P("data")`` hands a
    shard, with ``I_gt_global`` rebased to the part's own instance table
    (JAX ``local_step``'s ``- axis_index("data") * shard_rows``; -1 stays),
    so that it is the batch this rank would collate for itself."""
    out = {}
    for k, v in batch.items():
        lo, hi = shard_bounds(len(v), rank, world)
        out[k] = v[lo:hi]
    if "I_gt_global" in out:
        base = shard_bounds(len(batch["instance_pointnum"]), rank, world)[0]
        ig = out["I_gt_global"]
        out["I_gt_global"] = np.where(ig >= 0, ig - base, -1).astype(ig.dtype)
    return out


def _encode_part(part: List[Any]) -> np.ndarray:
    """A result list pickled into a flat uint8 array."""
    return np.frombuffer(pickle.dumps(part), dtype=np.uint8)


def _decode_rows(rows: Iterable[np.ndarray], sizes: Iterable[int]) -> List[Any]:
    """Inverse of ``_encode_part`` over the gathered, padded rows, in rank
    order."""
    out: List[Any] = []
    for row, size in zip(rows, np.asarray(list(sizes)).ravel()):
        out.extend(pickle.loads(np.asarray(row)[: int(size)].tobytes()))
    return out


def collect_results(part: List[Any]) -> List[Any]:
    """Every process's result list, concatenated in rank order, on every
    process (softgroup/util/dist.py:51-76): pickled, padded to the longest,
    ``all_gather``-ed as CPU uint8 tensors.  Identity with one process."""
    world = get_dist_info()[1]
    if world == 1:
        return part
    data = torch.from_numpy(_encode_part(part).copy())
    size = torch.tensor([data.numel()], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    buf = torch.zeros(int(max(sizes)), dtype=torch.uint8)
    buf[: data.numel()] = data
    rows = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(rows, buf)
    return _decode_rows([r.numpy() for r in rows], [int(s) for s in sizes])


def _all_gather_floats(values: List[float]) -> np.ndarray:
    """``[world, len(values)]`` float64 over the group (CPU tensors)."""
    t = torch.tensor(values, dtype=torch.float64)
    rows = [torch.zeros_like(t) for _ in range(get_dist_info()[1])]
    dist.all_gather(rows, t)
    return torch.stack(rows).numpy()


class AverageMeter:
    """softgroup/util/utils.py:13-51, reduced across processes on read when
    ``apply_dist_reduce``."""

    def __init__(self, apply_dist_reduce: bool = False):
        self.apply_dist_reduce = apply_dist_reduce
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    def _distributed(self) -> bool:
        return self.apply_dist_reduce and get_dist_info()[1] > 1

    def get_val(self) -> float:
        """The last value, averaged over processes."""
        if not self._distributed():
            return self.val
        return float(np.mean(_all_gather_floats([self.val])))

    def get_avg(self) -> float:
        """The count-weighted average over every process's updates (one
        gather of ``(sum, count)``, not a mean of per-process means)."""
        if not self._distributed():
            return self.sum / max(self.count, 1)
        tot = _all_gather_floats([self.sum, float(self.count)]).sum(axis=0)
        return float(tot[0] / max(tot[1], 1.0))
