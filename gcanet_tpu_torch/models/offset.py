"""Key-point attention offset prediction (port of
``gcanet_tpu/models/offset.py``; reference dgcnn-4.py:351-452).

Cosine similarity of every point's embedding against a fixed subset of key
points (``keypoint_permutation``), top-k, channel attention (KPAM) over the
sorted similarities, a 1x1 conv, a max over k and a linear to 3-d offsets.
The JAX package pulls the top-k rows with a one-hot matmul (a TPU
formulation); an indexed gather gives the same values.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gcanet_tpu_torch.models.layers import GroupNorm, conv_gn_act
from gcanet_tpu_torch.ops.mathutil import safe_norm


def keypoint_permutation(num_points: int, sampling_ratio: int) -> np.ndarray:
    """The exact fixed subset of dgcnn-4.py:403-406."""
    l = np.arange(num_points)
    rng = np.random.RandomState(1234)
    rng.shuffle(l)
    return l[:sampling_ratio]


class KPAM(nn.Module):
    """Channel-softmax attention over the k sorted similarities (dgcnn-4.py:351-373)."""

    def __init__(self, k: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Linear(k, k, bias=False), nn.ReLU(),
                                   nn.Linear(k, k, bias=False))

    def forward(self, x: torch.Tensor, attention_feature: torch.Tensor) -> torch.Tensor:
        # x [B, N, K, C]; attention_feature [B, N, K]
        a = torch.softmax(self.conv1(attention_feature), dim=-1)
        return x * a[..., None]


class OffsetPredModule(nn.Module):
    """dgcnn-4.py:376-452: per-point 3-d offsets to the instance centroid."""

    def __init__(self, nn_nb: int = 30, sampling_ratio: int = 120,
                 feature_dim: int = 128):
        super().__init__()
        self.nn_nb = nn_nb
        self.sampling_ratio = sampling_ratio
        self.conv1 = nn.Sequential(nn.Linear(feature_dim + 3, 128, bias=False))
        self.bn1 = GroupNorm(2, 128)
        self.attention = KPAM(nn_nb)
        self.mlp_offset = nn.Linear(128 + feature_dim, 3)

    def forward(self, points: torch.Tensor, feature: torch.Tensor,
                instance_feature: torch.Tensor) -> torch.Tensor:
        # points [B, N, 3]; feature [B, N, 128]; instance_feature [B, N, E]
        b, n, _ = points.shape
        s = min(self.sampling_ratio, n)
        sub = torch.as_tensor(keypoint_permutation(n, s), device=points.device)

        # cos_dist (dgcnn-4.py:326-342): cos - 1
        inst_sampling = instance_feature[:, sub]
        fn = instance_feature / safe_norm(instance_feature, dim=-1, keepdim=True)
        gn = inst_sampling / safe_norm(inst_sampling, dim=-1, keepdim=True)
        sim = fn @ gn.transpose(1, 2) - 1.0                  # [B, N, S]
        topk_dist, topk_idx = torch.topk(sim, self.nn_nb, dim=-1, sorted=True)

        src = torch.cat([points[:, sub], feature[:, sub]], dim=-1)   # [B, S, 3+C]
        k, c = self.nn_nb, src.shape[-1]
        both = torch.gather(src, 1, topk_idx.reshape(b, n * k, 1).expand(b, n * k, c))
        both = both.reshape(b, n, k, c)
        direction = both[..., :3] - points[:, :, None, :]
        feat_dir = torch.cat([both[..., 3:], direction], dim=-1)    # [B, N, K, C+3]

        attended = self.attention(feat_dir, topk_dist)
        h = conv_gn_act(self.conv1, self.bn1, attended).amax(dim=2)
        return self.mlp_offset(torch.cat([h, feature], dim=-1))     # [B, N, 3]
