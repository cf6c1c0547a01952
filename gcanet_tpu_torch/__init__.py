"""PyTorch/CUDA port of gcanet_tpu: the flagship model's serving path.

Layout mirrors the JAX package (``config``, ``ops/``, ``models/``,
``train/``, ``serve``).  The port imports neither JAX nor ``gcanet_tpu``.
"""
