"""Autoregressive inference for the PyTorch FACT."""

from mint_tpu_torch.infer.decoder import (  # noqa: F401
    infer_auto_regressive,
    infer_auto_regressive_reference,
    max_steps,
    padded_batch_size,
    quantize_steps,
)
