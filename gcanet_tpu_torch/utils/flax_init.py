"""Flax's initialisation of a port model from a seed: the JAX package's
``model.init(PRNGKey(seed), ...)`` values, drawn on the host with the
port's own copy of ``jax.random`` (``utils/threefry.py``).

Flax gives each parameter a key of its own (``flax/core/scope.py``:
``Scope.make_rng`` and ``_fold_in_static``): the root key folded with the
first four bytes, big-endian, of the SHA-1 of the names of the scopes from
the root down to the parameter's owner, followed by the owner's parameter
counter (1 for its first ``self.param``, 2 for its second, zeros and ones
initialisers included) in as few big-endian bytes as it takes.  No
separator byte is hashed (``flax_fix_rng_separator`` is off).  A Dense,
Conv or ConvTranspose creates its ``kernel`` first, a norm its ``scale``;
so every kernel is counter 1 of its scope.

The scope paths come from the rule tables of ``utils/from_jax.py``.  A
kernel is drawn in flax's layout, where flax takes its fan-in (all axes
but the last: ``variance_scaling``'s in-axis -2 times the receptive
field), and then taken to the port's layout by the table's transform, so
the values land where ``state_dict_from_jax`` would put the JAX model's.
Biases are 0, norms the identity and running statistics 0 and 1, as flax
initialises them; the bare tables (a query decoder's queries, a ViT's
tokens) are ``normal(1.0)`` draws.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np
import torch
from torch import nn

from gcanet_tpu_torch.utils import threefry
from gcanet_tpu_torch.utils.from_jax import (CONV3D, DECONV3D, LINEAR, RAW, _Rule, _key,
                                             _from_flax, leaf_pairs)

# the standard deviation of N(0, 1) cut to [-2, 2]: flax's
# ``variance_scaling(..., "truncated_normal")`` divides by it so that the
# cut draw keeps the variance 1 / fan_in
TRUNC_STD = 0.87962566103423978

# the bare parameters the port draws, all ``normal(1.0)``: their counter
# in their scope (the code order of its ``self.param`` calls)
_RAW_COUNTER = {"query": 1, "pe": 2,                 # query_decoder.py:108,113
                "cls_token": 1, "pos_embedding": 2}  # transformer.py:99,101


def param_key(root: threefry.Key, scope: tuple[str, ...], counter: int) -> threefry.Key:
    """The key of the ``counter``-th parameter of the flax scope at path
    ``scope`` under the root key ``root`` (``_fold_in_static``)."""
    h = hashlib.sha1()
    for name in scope:
        h.update(name.encode("utf-8"))
    h.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return threefry.fold_in(root, int.from_bytes(h.digest()[:4], "big"))


@functools.lru_cache(maxsize=512)
def _draw(seed: int, scope: tuple[str, ...], counter: int, shape: tuple[int, ...],
          law: str) -> np.ndarray:
    k = param_key(threefry.key(seed), scope, counter)
    if law == "normal":                                 # normal(1.0)
        out = threefry.normal(k, shape)
    else:                                               # lecun_normal()
        variance = np.float32(1.0 / math.prod(shape[:-1]))
        out = threefry.truncated_normal(k, -2.0, 2.0, shape) * (
            np.sqrt(variance) / np.float32(TRUNC_STD))
    out.setflags(write=False)
    return out


def _flax_shape(kind: str, shape: torch.Size) -> tuple[int, ...]:
    """The flax kernel shape whose ``_from_flax`` is ``shape``."""
    if kind == LINEAR:
        return tuple(shape[::-1])
    if kind == CONV3D:                              # [out, in, k, k, k]
        return (*shape[2:], shape[1], shape[0])
    return (*shape[2:], shape[0], shape[1])         # DECONV3D: [in, out, k, k, k]


def init_from_seed(model: nn.Module, rules: list[_Rule], seed: int) -> None:
    """Set every parameter and running statistic of ``model`` to what flax's
    ``init`` with ``PRNGKey(seed)`` gives the JAX model whose key map is
    ``rules``.  Raises if a parameter of ``model`` has no rule."""
    seed = int(seed)
    state = model.state_dict()
    new: dict[str, torch.Tensor] = {}
    for prefix, fpath, kind, has_bias in rules:
        for leaf, _ in leaf_pairs(kind, has_bias):
            name = _key(prefix, leaf)
            cur = state[name]
            if kind == RAW:
                value = _draw(seed, fpath[:-1], _RAW_COUNTER[fpath[-1]], tuple(cur.shape),
                              "normal")
            elif leaf == "weight" and kind in (LINEAR, CONV3D, DECONV3D):
                value = _from_flax(kind, leaf, _draw(
                    seed, fpath, 1, _flax_shape(kind, cur.shape), "lecun"))
            elif leaf in ("weight", "running_var"):
                value = np.ones(cur.shape, np.float32)
            else:                                   # biases, running means
                value = np.zeros(cur.shape, np.float32)
            new[name] = torch.from_numpy(np.array(value, np.float32, order="C"))
    missing = {n for n, _ in model.named_parameters()} - set(new)
    if missing:
        raise ValueError(f"parameters without a flax rule: {sorted(missing)}")
    with torch.no_grad():
        for name, value in new.items():
            state[name].copy_(value)
