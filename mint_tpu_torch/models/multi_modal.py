"""Model-family contract bound for FACT (counterpart of
``mint_tpu/models/multi_modal.py``) and for EDGE (the port's own).  In
PyTorch the params live in the module, so the methods take no params
argument."""

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


class EDGEFamily(MultiModalModelFamily):
    """EDGE bound to the family contract: its forward is the denoiser's
    and its generation the long-form DDIM sampler
    (``infer/diffusion.py``).  Generation only: the loss (EDGE's adds
    forward-kinematics joint and foot-contact terms through the SMPL
    skeleton, not in the repository) raises."""

    def __init__(self, model):
        self.model = model

    @torch.inference_mode()
    def call(self, inputs):
        """Both branches' x0 [2 chunks, seq, nfeats] (the conditional
        first) of chunks ``x`` [chunks, seq, nfeats] with music features
        ``cond`` [chunks, seq, F] at one timestep ``times`` [1]: the
        sampler's denoiser (``EDGE.music_memory``, then ``EDGE.denoise``)."""
        from mint_tpu_torch.models.edge import DispatchMemory

        model, x = self.model, inputs["x"]
        memory = DispatchMemory(model, x.shape[0], model.dtype, model.device)
        model.music_memory(inputs["cond"].to(model.dtype), memory)
        return model.denoise(x, inputs["times"], memory)

    def loss(self, target, pred):
        raise NotImplementedError(
            "EDGE's loss needs the SMPL skeleton's forward kinematics, "
            "which is not in the repository: generation only")

    def predict(self, inputs, steps: int | None = None):
        """Each song's frames: ``cond`` [total chunks, seq, F] (the
        songs' chunks, ``infer.diffusion.chunk_music``), ``chunks`` each
        song's count; ``x_T`` and ``noise`` (every step's z) where given,
        else drawn from ``generator`` (or torch's default); ``record`` /
        ``record_out`` as :func:`infer.diffusion.sample` takes them.
        `steps`, where given, must be the config's sampling steps."""
        from mint_tpu_torch.infer import diffusion

        model = self.model
        cfg = model.config
        if steps is not None and steps != cfg.sampling_steps:
            raise ValueError(f"EDGE samples {cfg.sampling_steps} steps "
                             f"(its config); asked for {steps}")
        cond = inputs["cond"]
        chunks = list(inputs.get("chunks", [cond.shape[0]]))
        shape = (cond.shape[0], model.seq_len, model.nfeats)
        gen = inputs.get("generator")
        x_t = inputs.get("x_T")
        if x_t is None:
            x_t = torch.randn(shape, generator=gen, device=model.device)
        noise = inputs.get("noise")
        if noise is None:
            noise = torch.randn((cfg.sampling_steps - 1,) + shape,
                                generator=gen, device=model.device)
        return diffusion.sample(model, cond, chunks, x_t, noise,
                                inputs.get("record", ()),
                                inputs.get("record_out"))

    def get_metrics(self, eval_config) -> List[Any]:
        del eval_config
        return []
