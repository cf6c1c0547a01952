"""Synthetic clouds."""
