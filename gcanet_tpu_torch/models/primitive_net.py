"""The flagship GCANet model (port of ``gcanet_tpu/models/primitive_net.py``;
reference models/dgcnn-hais-concat-direct-4.py:537-1499).

Encoder + heads + offset module + grouping + voxelisation + instance head.
``model.train()`` selects the training path (``train=True`` in the JAX
package): batch statistics in the instance head's norms, random grid
shifts in the voxelisation, no set aggregation.
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
from gcanet_tpu_torch.models.layers import (GroupNorm, conv_gn_act, dense_gn,
                                            init_lecun_normal_)
from gcanet_tpu_torch.models.offset import OffsetPredModule
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.ops.mathutil import safe_norm


class ModelOutput(NamedTuple):
    type_per_point: torch.Tensor    # [B, N, cls] (log-softmax when 'r' in loss_class)
    param_per_point: torch.Tensor   # [B, N, 22] canonicalised primitive params
    normal_per_point: torch.Tensor  # [B, N, 3] (zeros in mode 5)
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

    Weights are random, drawn from ``generator`` (default: seeded with
    ``cfg.seed``), until a checkpoint is loaded.
    """

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.num_primitives
        ih = cfg.instance_head
        self.encoder = DGCNNEncoderGn(nn_nb=cfg.nn_nb, knn_impl=cfg.knn_impl,
                                      nn_nb_inner=cfg.nn_nb_inner)
        # trunk (dgcnn-4.py:644-645)
        self.conv1 = nn.Linear(1280, 512)
        self.bn1 = GroupNorm(8, 512)
        self.conv2 = nn.Linear(512, 256)
        self.bn2 = GroupNorm(4, 256)
        # type, param, embedding and normal-angle heads (dgcnn-4.py:650-699)
        self.mlp_prim_prob1 = nn.Linear(256, 256)
        self.bn_prim_prob1 = GroupNorm(4, 256)
        self.mlp_prim_prob2 = nn.Linear(256, c)
        self.mlp_param_prob1 = nn.Linear(256, 256)
        self.bn_param_prob1 = GroupNorm(4, 256)
        self.mlp_param_prob2 = nn.Linear(256, 22)
        self.conv_normal = nn.Sequential(nn.Linear(7, 64, bias=False))
        self.bn_normal = GroupNorm(2, 64)
        self.mlp_seg_prob1 = nn.Linear(256 * 3 + 64, 256)
        self.bn_seg_prob1 = GroupNorm(4, 256)
        self.mlp_seg_prob2 = nn.Linear(256, cfg.out_dim)
        # offset module input (dgcnn-4.py:710-716)
        self.conv3 = nn.Linear(256 + cfg.input_channels, 128)
        self.bn3 = GroupNorm(4, 128)
        self.offset_pred_block = OffsetPredModule(cfg.offset_knn, cfg.offset_keypoints)
        # instance head: its children are registered here, at the top level
        # where the reference keeps them; the tuple holds the head itself
        # without registering its parameters a second time
        head = InstanceHead(c, ih.channels, ih.grid_size)
        self._instance_head = (head,)
        for name, child in head.named_children():
            self.add_module(name, child)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_lecun_normal_(self, generator)

    @property
    def instance_head(self) -> InstanceHead:
        return self._instance_head[0]

    def forward(self, xyz: torch.Tensor, normals: torch.Tensor,
                r1: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> ModelOutput:
        """In training mode the voxel grids shift by ``r1 [2, 3]`` when
        given, else by a draw from ``generator`` (on the model's device);
        both are unused in eval mode."""
        cfg = self.cfg
        b, n, _ = xyz.shape
        num_cls = cfg.num_primitives
        points = torch.cat([xyz, normals], dim=-1)

        # shared neighbourhood: encoder layer 1 and the normal-angle feature
        idx1 = knn_ops.knn_points_normals_indices(points, cfg.nn_nb, cfg.knn_impl)
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

        nf = knn_ops.edge_feature_normals_g_from_gathered(points, nbr1)
        normal_feature = conv_gn_act(self.conv_normal, self.bn_normal, nf).amax(dim=2)
        emb_in = torch.cat([x_all, x_type, x_para, normal_feature], dim=-1)  # 832
        h = torch.relu(dense_gn(self.mlp_seg_prob1, self.bn_seg_prob1, emb_in))
        embedding = self.mlp_seg_prob2(h)                             # [B, N, emb]

        opc = torch.relu(dense_gn(self.conv3, self.bn3,
                                  torch.cat([x_all, points], dim=-1)))
        pt_offsets = self.offset_pred_block(xyz, opc, embedding)      # [B, N, 3]

        # grouping (dgcnn-4.py:1122-1295), on detached inputs
        cls_argmax = type_logits.argmax(dim=-1).to(torch.int32)
        proposals = grouping_ops.build_proposals(
            (xyz + pt_offsets).detach().float(), cls_argmax,
            embedding.detach().float(), param_per_point.detach().float(),
            num_cls, cfg.grouping,
            max_proposals=cfg.instance_head.max_proposals,
            using_set_aggr=(not self.training) and cfg.using_set_aggr)

        # per-proposal voxelisation and instance head (dgcnn-4.py:1300-1392);
        # the head's gradient reaches the embedding through the voxel means
        vx = vox_ops.clusters_voxelization(
            xyz.reshape(b * n, 3), embedding.reshape(b * n, -1),
            proposals.point_pid, num_proposals=cfg.instance_head.max_proposals,
            grid_size=cfg.instance_head.grid_size,
            rand_quantize=self.training, r1=r1, generator=generator)
        instance = self.instance_head(vx.feats, vx.active, vx.entry_voxel,
                                      proposals.point_pid)

        return ModelOutput(
            type_per_point=type_per_point,
            param_per_point=param_per_point,
            normal_per_point=torch.zeros_like(xyz),
            semantic_scores=semantic_scores,
            pt_offsets=pt_offsets.reshape(b * n, 3),
            embedding=embedding,
            proposals=proposals,
            instance=instance,
        )
