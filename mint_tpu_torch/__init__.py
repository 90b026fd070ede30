"""PyTorch/CUDA port of the FACT serving path, held against ``mint_tpu``.

Layout mirrors ``mint_tpu/``: ``ops`` (hand-written CUDA kernels and
their plain PyTorch versions), ``models``, ``infer`` and ``serving``.
The package imports ``torch`` and, from the JAX package, only the
pure-Python ``mint_tpu.config``.
"""
