"""Device-to-host copies."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Copy several device tensors to the host in ONE transfer: their bytes
    are packed into one buffer (each piece padded to 8 bytes) and split on
    the host."""
    pieces, metas = [], []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        pieces.append(torch.nn.functional.pad(raw, (0, pad)) if pad else raw)
        metas.append((t.dtype, tuple(t.shape), raw.numel() + pad))
    buf = torch.cat(pieces).cpu().numpy()
    out, off = [], 0
    for dtype, shape, nbytes in metas:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        count = int(np.prod(shape, dtype=np.int64))
        out.append(np.frombuffer(buf, np_dtype, count, off).reshape(shape))
        off += nbytes
    return out
