"""Modules of the flagship model."""
