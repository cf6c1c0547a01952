"""Geometric fitting, point-to-primitive distances, affinities and spline surfaces."""
