"""Kernels of the port (hand-written CUDA) beside their plain versions:
``attention`` and ``mlp``, built by ``_build``."""
