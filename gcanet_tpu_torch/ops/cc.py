"""Connected components over a dense boolean adjacency.

Port of ``gcanet_tpu/ops/cc_pallas.py``: the masked min-label sweep

    out[i] = min_j { labels[j] : nbr[i, j] }     (BIG_LABEL if row i is empty)

is the hand-written CUDA kernel ``csrc/cc_sweep.cu`` on a CUDA tensor and its
plain PyTorch version on a CPU tensor.  The loop around it (min with the old
labels, two pointer jumps, stop when nothing changed or after ``max_iters``
sweeps) is PyTorch on either device; reading the ``changed`` flag is its one
host sync per sweep.  The TPU layout rules (256-padding, divisor row tiles)
are gone: the kernel takes any N and any row stride.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from gcanet_tpu_torch.utils import kernels

BIG_LABEL = 2**30
SOURCE = "cc_sweep.cu"
_count_lock = threading.Lock()     # a data-parallel predictor launches from several threads


def masked_min_sweep_plain(nbr: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sweep: ``nbr [N, N]`` bool/uint8, ``labels [N]`` int32."""
    return torch.where(nbr.bool(), labels[None, :], BIG_LABEL).amin(dim=1)


@functools.cache
def _sweep_fn():
    fn = kernels.load(SOURCE).cc_masked_min_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(nbr: torch.Tensor, labels: torch.Tensor) -> None:
    if nbr.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"nbr must be bool or uint8, got {nbr.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    n = labels.shape[0] if labels.dim() == 1 else -1
    if nbr.dim() != 2 or tuple(nbr.shape) != (n, n):
        raise ValueError(f"nbr {tuple(nbr.shape)} and labels "
                         f"{tuple(labels.shape)} are not [N, N] and [N]")
    if n >= BIG_LABEL:
        raise ValueError(f"N={n} collides with the empty-row sentinel 2**30")
    if labels.device != nbr.device:
        raise ValueError(f"labels on {labels.device}, nbr on {nbr.device}")
    if not labels.is_contiguous():
        raise ValueError("labels must be contiguous")
    if n > 1 and (nbr.stride(1) != 1 or nbr.stride(0) < n):
        raise ValueError(f"nbr rows must be contiguous, strides {nbr.stride()}")


def masked_min_sweep(nbr: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One sweep.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (and counts the launch in ``.launches``) or raises."""
    _check(nbr, labels)
    if nbr.device.type == "cpu":
        return masked_min_sweep_plain(nbr, labels)
    if nbr.device.type != "cuda":
        raise ValueError(f"masked_min_sweep runs on cpu or cuda, not {nbr.device}")
    n = labels.shape[0]
    out = torch.empty_like(labels)
    with torch.cuda.device(nbr.device):
        err = _sweep_fn()(nbr.data_ptr(), nbr.stride(0), labels.data_ptr(),
                          out.data_ptr(), n,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cc_masked_min_sweep launch failed: cudaError {err}")
    with _count_lock:
        masked_min_sweep.launches += 1
    return out


masked_min_sweep.launches = 0


def connected_components(nbr: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Min-label propagation with pointer jumping over ``nbr [N, N]``
    (row = out-edges).  On a symmetric graph each point ends labelled with
    the minimum index of its component.  Returns ``[N]`` int32."""
    n = nbr.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=nbr.device)
    for _ in range(max_iters):
        new = torch.minimum(labels, masked_min_sweep(nbr, labels))
        new = torch.minimum(new, new[new.long()])
        new = torch.minimum(new, new[new.long()])
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels
