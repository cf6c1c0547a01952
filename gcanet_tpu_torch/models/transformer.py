"""Pre-norm transformer and ViT blocks (port of
``gcanet_tpu/models/transformer.py``; reference models/transformer.py).

The attention is written out as the JAX package computes it
(``jax.nn.dot_product_attention``): logits in fp32 scaled by
``dim_head**-0.5`` on queries pre-scaled by ``dim**-0.5 * dim_head**0.5``
(the reference scales by the model dim), blocked entries set to
``-0.7 * float32 max``, softmax in fp32.  flax's defaults are kept:
LayerNorm eps 1e-6, the tanh form of GELU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import Dense
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_library_rules

_BLOCKED = -0.7 * torch.finfo(torch.float32).max


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q [B, T, H, D]``, ``k``/``v [B, S, H, D]``, ``mask`` broadcastable
    to ``[B, H, T, S]`` (True = attend) -> ``[B, T, H, D]``."""
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        logits = torch.where(mask, logits, _BLOCKED)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(Dense(dim, hidden_dim), nn.GELU(approximate="tanh"),
                                 Dense(hidden_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """transformer.py:36-76, scaled by ``dim**-0.5`` as the reference is."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(dim, 3 * inner, bias=False)
        self.to_out = Dense(inner, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        q = q * (self.dim ** -0.5 * self.dim_head ** 0.5)
        attn_mask = None
        if mask is not None:
            attn_mask = (mask[:, None, :] & mask[:, :, None])[:, None]
        out = dot_product_attention(q, k, v, attn_mask)
        return self.to_out(out.reshape(b, n, -1))


class _Layer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, heads, dim_head)
        self.norm2 = layer_norm(dim)
        self.ff = FeedForward(dim, mlp_dim)


def _attention_names(depth: int) -> dict:
    """The flax children of a ``Transformer`` that its rule table counts."""
    return {f"Attention_{i}": {} for i in range(depth)}


class Transformer(nn.Module):
    """transformer.py:78-91: ``depth`` x (pre-norm attention, pre-norm
    feed-forward), each residual.  Weights: the JAX module's ``init`` with
    ``PRNGKey(seed)``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 seed: int = 0):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(dim, heads, dim_head, mlp_dim) for _ in range(depth))
        init_from_seed(self, build_library_rules("transformer", _attention_names(depth)), seed)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer.attn(layer.norm1(x), mask)
            x = x + layer.ff(layer.norm2(x))
        return x


class ViT(nn.Module):
    """transformer.py:93-136: ``img [B, C, H, W]`` -> logits ``[B, classes]``.
    Weights: the JAX module's ``init`` with ``PRNGKey(seed)``."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 channels: int = 3, dim_head: int = 64, seed: int = 0):
        super().__init__()
        self.patch_size, self.pool = patch_size, pool
        n = (image_size // patch_size) ** 2
        self.to_patch_embedding = Dense(patch_size * patch_size * channels, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.mlp_head = nn.Sequential(layer_norm(dim), Dense(dim, num_classes))
        init_from_seed(self, build_library_rules(
            "vit", {"Transformer_0": _attention_names(depth)}), seed)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, c, h, w = img.shape
        x = img.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
        x = self.to_patch_embedding(x.reshape(b, (h // p) * (w // p), -1))
        n = x.shape[1]
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        x = self.transformer(x + self.pos_embedding[:, :n + 1])
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x)
