"""Instance extraction (the serving half of the JAX train package)."""
