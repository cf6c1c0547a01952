"""One batch served over a list of devices: the in-process counterpart of
the JAX package's single-controller mesh (``gcanet_tpu/serve.py:62-67``).

The batch splits into contiguous chunks, one per device, each run by a
thread of its own on that device's replica of the model (the reference's
``nn.DataParallel``).  A GSPMD program over the whole batch computes what
one device computes; the port's forward is batch-wide in two places, the
proposal cap and the scene family's per-class ``min_npoint``, so those two
see every chunk through ``Chunk.all_gather`` (``ops/grouping.py``), and a
chunked batch gives the one-device result.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import torch


class Chunk:
    """Chunk ``index`` of a batch: its first item ``offset`` and the batch's
    ``total`` items, and ``all_gather`` across the batch's chunks."""

    def __init__(self, group: "BatchChunks", index: int):
        self.group, self.index = group, index
        self.offset = sum(group.sizes[:index])
        self.total = sum(group.sizes)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every chunk's ``t``, as CPU tensors in chunk order.  Each chunk's
        thread must call it at the same point of its forward."""
        g = self.group
        g.slots[self.index] = t.detach().cpu()
        g.barrier.wait()
        out = list(g.slots)
        g.barrier.wait()                 # nobody overwrites a slot still being read
        return out


class BatchChunks:
    """The chunks of one batch of ``sizes[i]`` items each."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = list(sizes)
        self.slots: List[torch.Tensor | None] = [None] * len(sizes)
        self.barrier = threading.Barrier(len(sizes))

    def chunk(self, index: int) -> Chunk:
        return Chunk(self, index)


def run_chunks(fns: Sequence[Callable[[], object]], chunks: BatchChunks) -> List[object]:
    """``fns[i]()`` in one thread each, at the caller's intra-op thread
    count; returns their results in order.  The first exception is raised
    here after every thread has ended (the barrier is broken, so no thread
    waits for a chunk that failed)."""
    results: List[object] = [None] * len(fns)
    errors: List[BaseException] = []
    n_threads = torch.get_num_threads()

    def run(i: int) -> None:
        torch.set_num_threads(n_threads)
        try:
            results[i] = fns[i]()
        except BaseException as e:          # noqa: BLE001 -- raised by the caller
            errors.append(e)
            chunks.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return results
