"""PyTorch/CUDA port of gcanet_tpu: serving, training and evaluation of the
flagship model (``-4``) and its dual-attention variant (``-2``) and of the
SoftGroup scene family, SPP-Net, and the library modules (PointNet++,
SplineNet, soft projection, transformer/ViT, query decoder).

Layout mirrors the JAX package (``config``, ``ops/``, ``models/``,
``losses/``, ``train/``, ``serve``).  The port imports neither JAX nor
``gcanet_tpu``.
"""
