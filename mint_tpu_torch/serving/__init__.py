"""Batched HTTP inference server on the PyTorch port."""

from mint_tpu_torch.serving.server import GenerationService, serve  # noqa: F401
