"""Training losses of the flagship model."""
