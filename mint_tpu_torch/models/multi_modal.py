"""Model-family contract bound for FACT (counterpart of
``mint_tpu/models/multi_modal.py``).  In PyTorch the params live in the
module, so the methods take no params argument."""

from __future__ import annotations

import abc
from typing import Any, Dict, List

import torch


class MultiModalModelFamily(abc.ABC):
    """The contract every model family implements (reference
    multi_modal_model.py:20-65)."""

    @abc.abstractmethod
    def call(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training/eval forward pass."""

    @abc.abstractmethod
    def loss(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """Training loss."""

    @abc.abstractmethod
    def predict(self, inputs: Dict[str, torch.Tensor],
                steps: int) -> torch.Tensor:
        """Autoregressive generation."""

    @abc.abstractmethod
    def get_metrics(self, eval_config) -> List[Any]:
        """Online eval metrics (may be empty: offline scoring)."""


class FACTFamily(MultiModalModelFamily):
    """FACT bound to the family contract."""

    def __init__(self, model):
        self.model = model

    def call(self, inputs):
        return self.model(inputs)

    def loss(self, target, pred):
        from mint_tpu_torch.models.fact import l2_loss
        return l2_loss(target, pred)

    def predict(self, inputs, steps: int = 1200):
        from mint_tpu_torch.infer.decoder import infer_auto_regressive
        return infer_auto_regressive(self.model, inputs, steps=steps)

    def get_metrics(self, eval_config) -> List[Any]:
        # Reference FACT returns [] — metrics are computed offline.
        del eval_config
        return []
