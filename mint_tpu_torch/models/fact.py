"""The FACT (Full-Attention Cross-modal Transformer) model, in PyTorch.

Counterpart of ``mint_tpu/models/fact.py``: audio and motion encoders
(LinearEmbedding -> PositionEmbedding -> Transformer), a cross-modal layer
over concat(motion, audio) tokens, and the L2 loss.  Autoregressive
generation lives in :mod:`mint_tpu_torch.infer.decoder`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mint_tpu_torch.config.schema import FACTModelConfig
from mint_tpu_torch.models import layers
from mint_tpu_torch.models.modalities import build_modalities_model

AIST_AUDIO_DIM = 35  # the AIST++ frontend's feature width


class FACT(nn.Module):
    """FACT model; construct with a :class:`FACTModelConfig`.

    `audio_dim` is the audio feature width; the flagship config leaves it
    unset, so it defaults to the AIST++ frontend's 35 (as
    ``init_params`` in ``mint_tpu/models/fact.py`` does).
    `compute_dtype` is the JAX model's: every layer casts to it on each
    call while the parameters keep their dtype (``models/layers.py``).
    `mesh` (``parallel/mesh.py``), where its model axis is over 1, makes
    every attention and MLP hold this rank's slice (tensor parallelism);
    the embeddings, LayerNorms and output head stay whole on every rank.
    ``ln_affine_folded`` builds the inference variant whose pre-LN scale
    and bias live inside the next QKV and fc1 kernels: pair it with
    weights from ``models/fold.py`` (``fold_for_decode``).
    """

    def __init__(self, config: FACTModelConfig, audio_dim: int = 0,
                 compute_dtype: torch.dtype | None = None, mesh=None,
                 ln_affine_folded: bool = False):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.ln_affine_folded = ln_affine_folded
        motion_cfg = config.modality_by_name("motion")
        audio_cfg = config.modality_by_name("audio")
        feature_to_model, _, _ = build_modalities_model(config.modality)
        motion_tf = feature_to_model["motion"].get("transformer_layer")
        audio_tf = feature_to_model["audio"].get("transformer_layer")
        if motion_tf is None or audio_tf is None:
            raise ValueError(
                "FACT requires a transformer model for both the motion "
                "and audio modalities")
        cm = config.cross_modal_model
        if cm.cross_modal_concat_dim != "SEQUENCE_WISE":
            raise NotImplementedError(
                "cross_modal_concat_dim %s is not supported."
                % cm.cross_modal_concat_dim)
        self.motion_dim = motion_cfg.feature_dim or cm.output_layer.out_dim
        self.audio_dim = audio_dim or audio_cfg.feature_dim or AIST_AUDIO_DIM

        def transformer(tf):
            return layers.Transformer(tf.hidden_size, tf.num_hidden_layers,
                                      tf.num_attention_heads,
                                      tf.intermediate_size, compute_dtype,
                                      mesh, ln_affine_folded)

        self.motion_linear_embedding = layers.LinearEmbedding(
            self.motion_dim, motion_tf.hidden_size, compute_dtype)
        self.motion_pos_embedding = layers.PositionEmbedding(
            motion_cfg.sequence_length, motion_tf.hidden_size, compute_dtype)
        self.motion_transformer = transformer(motion_tf)
        self.audio_linear_embedding = layers.LinearEmbedding(
            self.audio_dim, audio_tf.hidden_size, compute_dtype)
        self.audio_pos_embedding = layers.PositionEmbedding(
            audio_cfg.sequence_length, audio_tf.hidden_size, compute_dtype)
        self.audio_transformer = transformer(audio_tf)
        self.cross_modal_layer = layers.CrossModalLayer(
            cm.transformer.hidden_size, cm.transformer.num_hidden_layers,
            cm.transformer.num_attention_heads,
            cm.transformer.intermediate_size, cm.output_layer.out_dim,
            output_initializer_range=cm.output_layer.initializer_range,
            compute_dtype=compute_dtype, mesh=mesh,
            ln_affine_folded=ln_affine_folded)

    @property
    def motion_seq_length(self) -> int:
        return self.config.modality_by_name("motion").sequence_length

    @property
    def audio_seq_length(self) -> int:
        return self.config.modality_by_name("audio").sequence_length

    @property
    def dtype(self) -> torch.dtype:
        return self.motion_pos_embedding.pos_embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.motion_pos_embedding.pos_embedding.device

    def encode_motion(self, motion_input: torch.Tensor) -> torch.Tensor:
        """[B, motion_seq, motion_dim] -> [B, motion_seq, hidden]."""
        x = self.motion_linear_embedding(motion_input)
        return self.motion_transformer(self.motion_pos_embedding(x))

    def encode_audio(self, audio_input: torch.Tensor) -> torch.Tensor:
        """[B, audio_seq, audio_dim] -> [B, audio_seq, hidden]."""
        x = self.audio_linear_embedding(audio_input)
        return self.audio_transformer(self.audio_pos_embedding(x))

    def cross(self, motion_features: torch.Tensor,
              audio_features: torch.Tensor,
              first_n_out: int | None = None) -> torch.Tensor:
        """Cross-modal transformer over concat(motion, audio) tokens."""
        return self.cross_modal_layer(motion_features, audio_features,
                                      first_n_out=first_n_out)

    def forward(self, inputs: Dict[str, torch.Tensor],
                first_n_out: int | None = None) -> torch.Tensor:
        """``motion_input`` [B, motion_seq, motion_dim] and ``audio_input``
        [B, audio_seq, audio_dim] -> [B, motion_seq + audio_seq, out_dim]
        (or its first `first_n_out` frames)."""
        motion_features = self.encode_motion(inputs["motion_input"])
        audio_features = self.encode_audio(inputs["audio_input"])
        return self.cross(motion_features, audio_features, first_n_out)


def l2_loss(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean-square loss over the first target_seq_len frames."""
    diff = target - pred[:, :target.shape[1]]
    return torch.mean(torch.square(diff))


@torch.no_grad()
def init_params(model: FACT, generator: torch.Generator) -> FACT:
    """Keras initialization from an explicit generator, in place:
    glorot-uniform Dense kernels and zero biases, truncated normal
    (sigma 0.02, clipped at +-2 sigma) for the position tables and the
    output head, LayerNorm weight 1 and bias 0.  Values are drawn in f32
    on the generator's device and cast to the model's dtype/device (so a
    CPU generator gives the same weights on any device).  Returns model.
    """
    head = model.cross_modal_layer.cross_output_layer
    for module in model.modules():
        if module is head:
            continue
        if isinstance(module, layers.Dense):
            _fill(module.weight, generator, nn.init.xavier_uniform_)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm) and module.weight is not None:
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, layers.PositionEmbedding):
            _fill(module.pos_embedding, generator, layers.trunc_normal_)
    _fill(head.weight, generator, lambda t, generator: layers.trunc_normal_(
        t, model.cross_modal_layer.output_initializer_range, generator))
    head.bias.zero_()
    return model


def _fill(param: torch.Tensor, generator: torch.Generator, init) -> None:
    tmp = torch.empty(param.shape, dtype=torch.float32,
                      device=generator.device)
    init(tmp, generator=generator)
    param.copy_(tmp)
