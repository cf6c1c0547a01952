"""Mask2Former-style learned-query decoder (port of
``gcanet_tpu/models/query_decoder.py``; reference models/query_decoder.py),
paired with the Hungarian criterion of ``losses/mask2former.py``.

Points are a fixed ``[B, N, C]`` batch, so each cross attention is one
batched call.  The attention is ``models/transformer.py``'s, as the JAX
package's ``jax.nn.dot_product_attention`` computes it; LayerNorm eps 1e-6
as in flax.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import Dense
from gcanet_tpu_torch.models.transformer import dot_product_attention, layer_norm
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_library_rules


class _Projections(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(d_model, d_model) for _ in range(4))

    def attend(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.nhead, -1)

        out = dot_product_attention(split(self.q_proj(q_in)), split(self.k_proj(k_in)),
                                    split(self.v_proj(v_in)), mask)
        return self.out_proj(out.reshape(q_in.shape))


class CrossAttentionLayer(_Projections):
    """query_decoder.py:5-45: queries attend to the point features."""

    def forward(self, source: torch.Tensor, query: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                pe: Optional[torch.Tensor] = None) -> torch.Tensor:
        # source [B, N, D]; query [B, Q, D]; attn_mask [B, Q, N], True = blocked
        q_in = query if pe is None else query + pe
        mask = None if attn_mask is None else ~attn_mask[:, None]
        # the reference's norm result is discarded (query_decoder.py:40-42)
        return self.attend(q_in, source, source, mask) + query


class SelfAttentionLayer(_Projections):
    def __init__(self, d_model: int, nhead: int):
        super().__init__(d_model, nhead)
        self.norm = layer_norm(d_model)

    def forward(self, x: torch.Tensor, pe: Optional[torch.Tensor] = None) -> torch.Tensor:
        q_in = x if pe is None else x + pe
        return self.norm(self.attend(q_in, q_in, x) + x)


class FFN(nn.Module):
    def __init__(self, d_model: int, hidden_dim: int):
        super().__init__()
        self.linear1 = Dense(d_model, hidden_dim)
        self.linear2 = Dense(hidden_dim, d_model)
        self.norm = layer_norm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.linear2(torch.relu(self.linear1(x))) + x)


def _head(d_model: int, out: int) -> nn.Sequential:
    return nn.Sequential(Dense(d_model, d_model), nn.ReLU(), Dense(d_model, out))


class QueryDecoder(nn.Module):
    """query_decoder.py:104-239 with iterative mask-guided attention:
    ``x [B, N, in_channel]`` -> ``{"labels", "masks", "scores",
    "parameters", "aux_outputs"}``.  Weights: the JAX module's ``init`` with
    ``PRNGKey(seed)``."""

    def __init__(self, num_layer: int = 6, num_query: int = 100, num_class: int = 18,
                 in_channel: int = 32, d_model: int = 256, nhead: int = 8,
                 hidden_dim: int = 1024, iter_pred: bool = True, attn_mask: bool = True,
                 use_pe: bool = False, seed: int = 0):
        super().__init__()
        self.iter_pred, self.attn_mask = iter_pred, attn_mask
        self.input_proj = nn.Sequential(Dense(in_channel, d_model), layer_norm(d_model),
                                        nn.ReLU())
        self.x_mask = nn.Sequential(Dense(in_channel, d_model), nn.ReLU(),
                                    Dense(d_model, d_model))
        self.query = nn.Parameter(torch.empty(num_query, d_model))
        self.pe = nn.Parameter(torch.empty(num_query, d_model)) if use_pe else None
        self.out_norm = layer_norm(d_model)
        self.out_cls = _head(d_model, num_class)
        self.out_score = _head(d_model, 1)
        self.out_paras = _head(d_model, 22)
        self.cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(d_model, nhead) for _ in range(num_layer))
        self.self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(d_model, nhead) for _ in range(num_layer))
        self.ffn_layers = nn.ModuleList(FFN(d_model, hidden_dim) for _ in range(num_layer))
        names = {f"FFN_{i}": {} for i in range(num_layer)}
        init_from_seed(self, build_library_rules(
            "query_decoder", dict(names, **({"pe": {}} if use_pe else {}))), seed)

    def _predict(self, q: torch.Tensor, mask_feats: torch.Tensor):
        qn = self.out_norm(q)
        masks = torch.einsum("bqd,bnd->bqn", qn, mask_feats)
        am = None
        if self.attn_mask:
            am = torch.sigmoid(masks) < 0.5
            am = (am & ~am.all(dim=-1, keepdim=True)).detach()
        return self.out_cls(qn), self.out_score(qn), masks, self.out_paras(qn), am

    def forward(self, x: torch.Tensor) -> Dict:
        b = x.shape[0]
        inst_feats = self.input_proj(x)
        mask_feats = self.x_mask(x)
        query = self.query[None].expand(b, -1, -1)
        pe = None if self.pe is None else self.pe[None].expand(b, -1, -1)
        aux: List[Dict] = []
        labels, scores, masks, paras, am = self._predict(query, mask_feats)
        for cross, self_attn, ffn in zip(self.cross_attention_layers,
                                         self.self_attention_layers, self.ffn_layers):
            if self.iter_pred:
                aux.append({"labels": labels, "masks": masks, "scores": scores,
                            "parameters": paras})
            query = cross(inst_feats, query, am if self.iter_pred else None, pe)
            query = ffn(self_attn(query, pe))
            labels, scores, masks, paras, am = self._predict(query, mask_feats)
        return {"labels": labels, "masks": masks, "scores": scores, "parameters": paras,
                "aux_outputs": aux}
