"""The flagship GCANet model (port of ``gcanet_tpu/models/primitive_net.py``;
reference models/dgcnn-hais-concat-direct-4.py:537-1499).

Encoder + heads + offset module + grouping + voxelisation + instance head.
``model.train()`` selects the training path (``train=True`` in the JAX
package): batch statistics in the instance head's norms, random grid
shifts in the voxelisation, no set aggregation.

``cfg.mode`` 5 takes xyz and normals; 0 and 3 take xyz only, and 3 adds a
normal head whose output feeds the embedding head's normal-angle feature.
``cfg.ablation`` replaces the offset module by an MLP and
``offset_variant="dual"`` by the ``-2`` model's dual-attention module
(``offset_dual.py``); ``cfg.encoder_bf16`` runs the encoder's and the
embedding head's edge tensors in bf16, and ``cfg.remat`` recomputes the
encoder's blocks, the embedding head's conv block and the default offset
module in the backward (the dual one is not recomputed, as in the JAX
package).  Under ``precision="bf16"`` the step calls the model on bf16
copies of its weights and inputs (``train/step.py``); the dtypes then
follow the JAX package's.

Every parameterised submodule is named after its key in the reference's
``model_state_dict`` (without the ``affinitynet.`` prefix), so a reference
checkpoint or a JAX parameter tree maps onto it key by key
(``utils/from_jax.py``).  The instance head's parts sit at the top level
because the reference registers them there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gcanet_tpu_torch.config import Config, check_supported
from gcanet_tpu_torch.models.dgcnn import DGCNNEncoderGn
from gcanet_tpu_torch.models.instance_head import InstanceHead, InstanceHeadOutput
from gcanet_tpu_torch.models.layers import (MLP, Dense, GroupNorm, conv_gn_act,
                                            dense_gn, remat)
from gcanet_tpu_torch.models.offset import OffsetPredModule
from gcanet_tpu_torch.models.offset_dual import OffsetPredModuleDual
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.ops.mathutil import safe_norm
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_rules


class ModelOutput(NamedTuple):
    type_per_point: torch.Tensor    # [B, N, cls] (log-softmax when 'r' in loss_class)
    param_per_point: torch.Tensor   # [B, N, 22] canonicalised primitive params
    normal_per_point: torch.Tensor  # [B, N, 3] (mode 3 only; zeros otherwise)
    semantic_scores: torch.Tensor   # [B*N, cls] raw logits for grouping
    pt_offsets: torch.Tensor        # [B*N, 3]
    embedding: torch.Tensor         # [B, N, emb]
    proposals: grouping_ops.Proposals
    instance: InstanceHeadOutput


def canonicalize_params(raw: torch.Tensor) -> torch.Tensor:
    """Per-type parameter canonicalisation (dgcnn-4.py:663-676): sphere
    [0:4], plane [4:8], cylinder [8:15], cone [15:22], axes normalised."""
    def unit(v):
        return v / (safe_norm(v, dim=-1, keepdim=True) + 1e-12)

    return torch.cat([raw[..., 0:4],
                      unit(raw[..., 4:7]), raw[..., 7:8],
                      unit(raw[..., 8:11]), raw[..., 11:15],
                      unit(raw[..., 15:18]), raw[..., 18:22]], dim=-1)


class PrimitiveNet(nn.Module):
    """The flagship model: ``forward(xyz, normals)`` -> ``ModelOutput``.

    Weights are random until a checkpoint is loaded: the JAX model's
    ``init`` with ``PRNGKey(seed)`` (default ``cfg.seed``), drawn by
    ``utils/flax_init.py``.
    """

    def __init__(self, cfg: Config, seed: int | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.num_primitives
        ih = cfg.instance_head
        self.encoder = DGCNNEncoderGn(nn_nb=cfg.nn_nb, knn_impl=cfg.knn_impl,
                                      nn_nb_inner=cfg.nn_nb_inner, mode=cfg.mode,
                                      compute_bf16=cfg.encoder_bf16,
                                      edge_backward=cfg.edge_backward,
                                      shared_graph=cfg.shared_graph, remat=cfg.remat)
        # trunk (dgcnn-4.py:644-645)
        self.conv1 = Dense(1280, 512)
        self.bn1 = GroupNorm(8, 512)
        self.conv2 = Dense(512, 256)
        self.bn2 = GroupNorm(4, 256)
        # type, param, normal (mode 3), embedding and normal-angle heads
        # (dgcnn-4.py:650-699)
        self.mlp_prim_prob1 = Dense(256, 256)
        self.bn_prim_prob1 = GroupNorm(4, 256)
        self.mlp_prim_prob2 = Dense(256, c)
        self.mlp_param_prob1 = Dense(256, 256)
        self.bn_param_prob1 = GroupNorm(4, 256)
        self.mlp_param_prob2 = Dense(256, 22)
        if cfg.mode == 3:
            self.mlp_normal_prob1 = Dense(256, 256)
            self.bn_normal_prob1 = GroupNorm(4, 256)
            self.mlp_normal_prob2 = Dense(256, 3)
        # the normal-angle feature is 7 wide over 6-d points; in mode 0 the
        # points are xyz alone and it is the clamped empty dot product, 1 wide
        width6 = cfg.mode in (3, 5)
        self.conv_normal = nn.Sequential(Dense(7 if width6 else 1, 64, bias=False))
        self.bn_normal = GroupNorm(2, 64)
        self.mlp_seg_prob1 = Dense(256 * 3 + 64, 256)
        self.bn_seg_prob1 = GroupNorm(4, 256)
        self.mlp_seg_prob2 = Dense(256, cfg.out_dim)
        # offset module input (dgcnn-4.py:710-716); its points are 6-d in
        # modes 5 and 3 (xyz ++ the given or the predicted normal)
        self.conv3 = Dense(256 + (6 if width6 else 3), 128)
        self.bn3 = GroupNorm(4, 128)
        if cfg.ablation:
            self.offset_linear = MLP(128, 3, hidden_features=128)
        elif cfg.offset_variant == "dual":          # dgcnn-2.py:739-741
            self.offset_pred_block = OffsetPredModuleDual(60, cfg.offset_keypoints)
        else:
            self.offset_pred_block = OffsetPredModule(cfg.offset_knn, cfg.offset_keypoints)
        # instance head: its children are registered here, at the top level
        # where the reference keeps them; the tuple holds the head itself
        # without registering its parameters a second time
        head = InstanceHead(c, ih.channels, ih.grid_size)
        self._instance_head = (head,)
        for name, child in head.named_children():
            self.add_module(name, child)
        init_from_seed(self, build_rules(cfg.mode, cfg.ablation, cfg.offset_variant == "dual"),
                       cfg.seed if seed is None else seed)

    @property
    def instance_head(self) -> InstanceHead:
        return self._instance_head[0]

    def forward(self, xyz: torch.Tensor, normals: torch.Tensor,
                r1: torch.Tensor | None = None, chunk=None) -> ModelOutput:
        """In training mode the voxel grids shift by ``r1 [2, 3]``
        (``train/step.py::grid_shift``), unused in eval mode.  ``chunk``:
        this batch is one chunk of a batch served over several devices
        (``parallel/chunks.py``), whose proposal cap it shares."""
        cfg = self.cfg
        b, n, _ = xyz.shape
        num_cls = cfg.num_primitives
        points = torch.cat([xyz, normals], dim=-1) if cfg.mode == 5 else xyz

        # shared neighbourhood: encoder layer 1 and the normal-angle feature
        knn = (knn_ops.knn_points_normals_indices if cfg.mode == 5
               else knn_ops.knn_indices)
        idx1 = knn(points, cfg.nn_nb, cfg.knn_impl)
        nbr1 = knn_ops.gather_neighbors(points, idx1)
        feats = self.encoder(points, idx1, nbr1)                      # [B, N, 1280]

        x = torch.relu(dense_gn(self.conv1, self.bn1, feats))
        x_all = torch.relu(dense_gn(self.conv2, self.bn2, x))

        x_type = torch.relu(dense_gn(self.mlp_prim_prob1, self.bn_prim_prob1, x_all))
        type_logits = self.mlp_prim_prob2(x_type)
        type_per_point = (torch.log_softmax(type_logits, dim=-1)
                          if "r" in cfg.loss_class else type_logits)
        semantic_scores = type_logits.reshape(b * n, num_cls)

        x_para = torch.relu(dense_gn(self.mlp_param_prob1, self.bn_param_prob1, x_all))
        param_per_point = canonicalize_params(self.mlp_param_prob2(x_para))

        if cfg.mode == 3:                                   # dgcnn-4.py:682-688
            x_nrm = torch.relu(dense_gn(self.mlp_normal_prob1, self.bn_normal_prob1, x_all))
            nrm = self.mlp_normal_prob2(x_nrm)
            normal_per_point = nrm / (safe_norm(nrm, dim=-1, keepdim=True) + 1e-12)
            points6 = torch.cat([points, normal_per_point], dim=-1)
            idx_emb = knn_ops.knn_points_normals_indices(points6, cfg.nn_nb, cfg.knn_impl)
            nf = knn_ops.edge_feature_normals_g(points6, idx_emb)
        else:
            normal_per_point = torch.zeros_like(xyz)
            points6 = points
            nf = knn_ops.edge_feature_normals_g_from_gathered(points6, nbr1)
        dt = torch.bfloat16 if cfg.encoder_bf16 else None

        def normal_block(f):
            return conv_gn_act(self.conv_normal, self.bn_normal, f, dt)

        normal_feature = (remat(normal_block, {"conv": self.conv_normal, "gn": self.bn_normal},
                                nf) if cfg.remat else normal_block(nf)
                          ).amax(dim=2).to(x_all.dtype)               # [B, N, 64]
        emb_in = torch.cat([x_all, x_type, x_para, normal_feature], dim=-1)  # 832
        h = torch.relu(dense_gn(self.mlp_seg_prob1, self.bn_seg_prob1, emb_in))
        embedding = self.mlp_seg_prob2(h)                             # [B, N, emb]

        opc = torch.relu(dense_gn(self.conv3, self.bn3,
                                  torch.cat([x_all, points6], dim=-1)))
        if cfg.ablation:
            pt_offsets = self.offset_linear(opc)                      # [B, N, 3]
        elif cfg.offset_variant == "dual":
            pt_offsets = self.offset_pred_block(xyz, opc, type_logits, embedding)
        elif cfg.remat:
            pt_offsets = remat(self.offset_pred_block, {"m": self.offset_pred_block},
                               xyz, opc, embedding)
        else:
            pt_offsets = self.offset_pred_block(xyz, opc, embedding)  # [B, N, 3]

        # grouping (dgcnn-4.py:1122-1295), on detached inputs
        cls_argmax = type_logits.argmax(dim=-1).to(torch.int32)
        proposals = grouping_ops.build_proposals(
            (xyz + pt_offsets).detach().float(), cls_argmax,
            embedding.detach().float(), param_per_point.detach().float(),
            num_cls, cfg.grouping,
            max_proposals=cfg.instance_head.max_proposals,
            using_set_aggr=(not self.training) and cfg.using_set_aggr, chunk=chunk)

        # per-proposal voxelisation and instance head (dgcnn-4.py:1300-1392);
        # the head's gradient reaches the embedding through the voxel means
        vx = vox_ops.clusters_voxelization(
            xyz.reshape(b * n, 3), embedding.reshape(b * n, -1),
            proposals.point_pid, num_proposals=cfg.instance_head.max_proposals,
            grid_size=cfg.instance_head.grid_size,
            rand_quantize=self.training, r1=r1)
        instance = self.instance_head(vx.feats, vx.active, vx.entry_voxel,
                                      proposals.point_pid)

        return ModelOutput(
            type_per_point=type_per_point,
            param_per_point=param_per_point,
            normal_per_point=normal_per_point,
            semantic_scores=semantic_scores,
            pt_offsets=pt_offsets.reshape(b * n, 3),
            embedding=embedding,
            proposals=proposals,
            instance=instance,
        )
