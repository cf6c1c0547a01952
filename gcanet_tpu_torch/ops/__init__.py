"""Tensor ops of the port: kNN, connected components, grouping, segments, voxelisation."""
