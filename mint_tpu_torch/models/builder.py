"""Model registry / builder (counterpart of ``mint_tpu/models/builder.py``)."""

from __future__ import annotations

import torch
from torch import nn

from mint_tpu_torch.config.schema import MultiModalModelConfig
from mint_tpu_torch.models.fact import FACT


def _build_fact_model(model_config: MultiModalModelConfig,
                      is_training: bool, **kwargs) -> FACT:
    del is_training  # dropout is never applied on the FACT path (parity)
    return FACT(model_config.fact_model, **kwargs)


MODEL_BUILDER_MAP = {
    "fact_model": _build_fact_model,
}


def build(model_config: MultiModalModelConfig, is_training: bool,
          dtype: torch.dtype = torch.float32,
          device: torch.device | str = "cuda",
          compute_dtype: torch.dtype | None = None) -> FACT:
    """Build a model from a MultiModalModel config (dispatch on the oneof),
    cast once to `dtype` and placed on `device`.  Not training builds are
    put in eval mode.

    Two ways to run in bf16 (``models/layers.py``): ``dtype=bf16`` casts
    the whole model once, LayerNorm kept in f32 (serving, eval);
    ``compute_dtype=bf16`` keeps the parameters in `dtype` (f32) and casts
    to bf16 in every layer on every call, as the JAX package's
    ``build(..., compute_dtype=...)`` does (training: f32 parameters,
    gradients and Adam state).

    The model runs on the card unless the caller asks for the CPU
    (``device="cpu"``, as the tests do); without a card the default
    raises rather than building on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("builder.build: device 'cuda' asked for (the "
                           "default) but no CUDA card is available; pass "
                           "device='cpu' to build on the CPU")
    build_func = MODEL_BUILDER_MAP[model_config.which()]
    model = build_func(model_config, is_training,
                       compute_dtype=compute_dtype).to(device=device,
                                                       dtype=dtype)
    # LayerNorm keeps f32 parameters under any cast, as Flax's
    # LayerNorm(dtype=...) keeps its scale and bias (models/layers.py).
    # They are 1 and 0 at this point, so the cast above lost nothing.
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.float()
    return model.train(is_training)
