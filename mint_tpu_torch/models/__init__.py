"""FACT model in PyTorch: layers, model, builder and the weights bridge."""

from mint_tpu_torch.models.builder import build  # noqa: F401
from mint_tpu_torch.models.fact import FACT, init_params, l2_loss  # noqa: F401
