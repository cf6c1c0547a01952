"""SPP-Net, the HPNet-style baseline (port of ``gcanet_tpu/models/sppnet.py``;
reference models/sppnet.py:228-349).

The DGCNN encoder in mode 5 (xyz and normals in, the default uniform
neighbourhood size) under four heads: embedding, type (log-softmax when
``"r"`` is in ``loss_class``), unit normals and canonicalised primitive
parameters.  No grouping and no instance head: it trains through its head
losses alone (``head_losses``, over ``losses/losses.py``), so
``Predictor`` and ``Trainer`` refuse it
(``models/registry.py::check_instance_model``).

Attribute names are the reference's state_dict keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.losses import losses as L
from gcanet_tpu_torch.models.dgcnn import DGCNNEncoderGn
from gcanet_tpu_torch.models.layers import Dense, GroupNorm, dense_gn
from gcanet_tpu_torch.models.primitive_net import canonicalize_params
from gcanet_tpu_torch.ops.mathutil import safe_norm
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_sppnet_rules


class SPPNetOutput(NamedTuple):
    embedding: torch.Tensor         # [B, N, emb]
    type_per_point: torch.Tensor    # [B, N, num_primitives]
    normal_per_point: torch.Tensor  # [B, N, 3]
    param_per_point: torch.Tensor   # [B, N, 22]


class PrimitiveNetSPP(nn.Module):
    """``forward(xyz, normals)`` -> ``SPPNetOutput``.  ``num_primitives``
    and ``emb_size`` default to the reference's 10 and 50 (the registry
    passes neither, as in the JAX package).  Weights are random: the JAX
    model's ``init`` with ``PRNGKey(seed)`` (default ``cfg.seed``)."""

    def __init__(self, cfg: Config, num_primitives: int = 10, emb_size: int = 50,
                 seed: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = DGCNNEncoderGn(nn_nb=cfg.nn_nb, knn_impl=cfg.knn_impl, mode=5)
        self.conv1 = Dense(1280, 512)
        self.bn1 = GroupNorm(8, 512)
        self.conv2 = Dense(512, 256)
        self.bn2 = GroupNorm(4, 256)
        for name, out in (("seg", emb_size), ("prim", num_primitives), ("normal", 3),
                          ("param", 22)):
            self.add_module(f"mlp_{name}_prob1", Dense(256, 256))
            self.add_module(f"bn_{name}_prob1", GroupNorm(4, 256))
            self.add_module(f"mlp_{name}_prob2", Dense(256, out))
        init_from_seed(self, build_sppnet_rules(), cfg.seed if seed is None else seed)

    def _head(self, name: str, x_all: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense_gn(getattr(self, f"mlp_{name}_prob1"),
                                getattr(self, f"bn_{name}_prob1"), x_all))
        return getattr(self, f"mlp_{name}_prob2")(h)

    def forward(self, xyz: torch.Tensor, normals: torch.Tensor) -> SPPNetOutput:
        feats = self.encoder(torch.cat([xyz, normals], dim=-1))       # [B, N, 1280]
        x = torch.relu(dense_gn(self.conv1, self.bn1, feats))
        x_all = torch.relu(dense_gn(self.conv2, self.bn2, x))
        type_logits = self._head("prim", x_all)
        nrm = self._head("normal", x_all)
        return SPPNetOutput(
            embedding=self._head("seg", x_all),
            type_per_point=(torch.log_softmax(type_logits, dim=-1)
                            if "r" in self.cfg.loss_class else type_logits),
            normal_per_point=nrm / (safe_norm(nrm, dim=-1, keepdim=True) + 1e-12),
            param_per_point=canonicalize_params(self._head("param", x_all)))


def head_losses(out: SPPNetOutput, batch: dict, max_instances: int) -> dict:
    """The losses SPP-Net trains with, on a ``synth_batch``/ABC batch of
    tensors: the embedding pull/push loss against ``I_gt``, the type NLL
    against ``T_gt``, the parameter loss and the normal loss against
    ``gt_normal``, summed with the weights 2, 2, 0.5 and 1 of the JAX
    package's SPP-Net training drive (``total``)."""
    ld = {"feat_loss": L.compute_embedding_loss(out.embedding, batch["I_gt"], max_instances)[0],
          "nnl_loss": L.compute_nnl_loss(out.type_per_point, batch["T_gt"]),
          "param_loss": L.compute_param_loss(out.param_per_point, batch["T_gt"],
                                             batch["T_param"]),
          "normal_loss": L.compute_normal_loss(out.normal_per_point, batch["gt_normal"])}
    ld["total"] = (2.0 * ld["feat_loss"] + 2.0 * ld["nnl_loss"] + 0.5 * ld["param_loss"]
                   + ld["normal_loss"])
    return ld
