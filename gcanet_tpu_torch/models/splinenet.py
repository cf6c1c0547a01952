"""SplineNet: B-spline control-point regression (port of
``gcanet_tpu/models/splinenet.py``; reference models/splinenet.py:55-179).

``DGCNNControlPoints``: four edge convs, a 1x1 conv to 1024 with a max over
points, an MLP and a tanh control grid (``num_control_points``^2 x 3).
Mode 0 is the open-spline net (64/64/128/256 channels), mode 1 the closed
one (128/256/256/512).  The batch norms follow flax (``layers.BatchNorm``:
biased variance in the running update).  Attribute names are the
reference's state_dict keys.
"""

from __future__ import annotations

import torch
from torch import nn

from gcanet_tpu_torch.models.layers import BatchNorm, Dense, leaky_relu
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_splinenet_rules


class DGCNNControlPoints(nn.Module):
    """``forward(points [B, N, 3], weights [B, N] | None)`` -> control grid
    ``[B, cp^2, 3]``; ``model.train()`` selects batch statistics.  Weights:
    the JAX module's ``init`` with ``PRNGKey(seed)``."""

    def __init__(self, num_control_points: int = 20, k: int = 40, mode: int = 0,
                 seed: int = 0):
        super().__init__()
        self.num_control_points = num_control_points
        self.k = k
        chans = (64, 64, 128, 256) if mode == 0 else (128, 256, 256, 512)
        cin = 3
        for i, c in enumerate(chans, 1):
            self.add_module(f"conv{i}", nn.Sequential(Dense(2 * cin, c, bias=False)))
            self.add_module(f"bn{i}", BatchNorm(c))
            cin = c
        self.conv5 = nn.Sequential(Dense(sum(chans), 1024, bias=False))
        self.bn5 = BatchNorm(1024)
        self.conv6 = Dense(1024, 1024)
        self.bn6 = BatchNorm(1024)
        self.conv7 = Dense(1024, 1024)
        self.bn7 = BatchNorm(1024)
        self.conv8 = Dense(1024, 3 * num_control_points ** 2)
        init_from_seed(self, build_splinenet_rules(), seed)

    def forward(self, points: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
        x, skips = points, []
        for i in range(1, 5):
            ef = knn_ops.edge_feature(x, knn_ops.knn_indices(x, self.k))
            ef = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(ef))
            x = leaky_relu(ef).amax(dim=2)
            skips.append(x)
        x = leaky_relu(self.bn5(self.conv5(torch.cat(skips, dim=-1))))
        if weights is not None:
            x = x * weights[..., None]
        code = x.amax(dim=1)                                    # adaptive max pool
        h = torch.relu(self.bn6(self.conv6(code)))
        h = torch.relu(self.bn7(self.conv7(h)))
        cp = torch.tanh(self.conv8(h))
        return cp.reshape(points.shape[0], self.num_control_points ** 2, 3)
