"""PyTorch/CUDA port of the FACT serving path, held against ``mint_tpu``.

Layout mirrors ``mint_tpu/``: ``config`` (its own copy of the JAX
package's config schema and text-proto parser), ``ops`` (hand-written
CUDA kernels and their plain PyTorch versions), ``models``, ``infer`` and
``serving``.  The package imports ``torch`` and nothing of the JAX
package.
"""
