"""Soft-projection block of SampleNet: differentiable soft nearest
neighbours (port of ``gcanet_tpu/models/soft_projection.py``; reference
models/search_knn.py:44-175).

For each query point, its ``group_size`` nearest points of the database
cloud (``ops/pointnet2.py::knn_point``), softmax weights over
``-||q - n||^2 / sigma`` with ``sigma = max(temperature^2, min_sigma)``,
and the weighted average of the neighbours' positions (``project``), of
their features (``propagate``) or both.  ``temperature`` is a trainable
scalar, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from gcanet_tpu_torch.ops.pointnet2 import group_points, knn_point


class SoftProjection(nn.Module):
    def __init__(self, group_size: int, initial_temperature: float = 1.0,
                 min_sigma: float = 1e-4):
        super().__init__()
        self.group_size = group_size
        self.min_sigma = min_sigma
        self.temperature = nn.Parameter(torch.tensor(initial_temperature, dtype=torch.float32))

    def sigma(self) -> torch.Tensor:
        # search_knn.py:121-123
        return torch.clamp(self.temperature ** 2, min=self.min_sigma)

    def _weights(self, point_cloud: torch.Tensor, query_cloud: torch.Tensor):
        """Soft-NN weights ``[B, Q, K]`` and the neighbour indices."""
        _, idx = knn_point(self.group_size, point_cloud, query_cloud)
        d2 = ((group_points(point_cloud, idx) - query_cloud[:, :, None, :]) ** 2).sum(-1)
        return torch.softmax(-d2 / self.sigma(), dim=-1), idx

    @staticmethod
    def _average(values: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (group_points(values, idx) * w[..., None]).sum(dim=2)

    def project(self, point_cloud: torch.Tensor, query_cloud: torch.Tensor) -> torch.Tensor:
        w, idx = self._weights(point_cloud, query_cloud)
        return self._average(point_cloud, idx, w)

    def propagate(self, point_cloud: torch.Tensor, point_features: torch.Tensor,
                  query_cloud: torch.Tensor) -> torch.Tensor:
        w, idx = self._weights(point_cloud, query_cloud)
        return self._average(point_features, idx, w)

    def project_and_propagate(self, point_cloud: torch.Tensor, point_features: torch.Tensor,
                              query_cloud: torch.Tensor):
        w, idx = self._weights(point_cloud, query_cloud)
        return self._average(point_cloud, idx, w), self._average(point_features, idx, w)

    def forward(self, point_cloud: torch.Tensor, query_cloud: torch.Tensor,
                point_features: torch.Tensor | None = None, action: str = "project"):
        if action == "project":
            return self.project(point_cloud, query_cloud)
        if action == "propagate":
            return self.propagate(point_cloud, point_features, query_cloud)
        if action == "project_and_propagate":
            return self.project_and_propagate(point_cloud, point_features, query_cloud)
        raise ValueError("action should be one of the following: 'project', 'propagate', "
                         "'project_and_propagate'")
