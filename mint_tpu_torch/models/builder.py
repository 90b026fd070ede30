"""Model registry / builder (counterpart of ``mint_tpu/models/builder.py``)."""

from __future__ import annotations

import torch
from torch import nn

from mint_tpu_torch.config.schema import (FACTModelConfig,
                                          MultiModalModelConfig)
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.models.modalities import build_modalities_model
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.utils.device import resolve


def _build_fact_model(model_config: MultiModalModelConfig,
                      is_training: bool, **kwargs) -> FACT:
    del is_training  # dropout is never applied on the FACT path (parity)
    return FACT(model_config.fact_model, **kwargs)


MODEL_BUILDER_MAP = {
    "fact_model": _build_fact_model,
}


def check_kernel_limits(config: FACTModelConfig,
                        dtype: torch.dtype, model: int = 1) -> None:
    """Raise ValueError, naming the field, where the model `config` builds
    could not run its hand-written kernels in `dtype`: a dtype no kernel
    takes, a transformer whose hidden size its heads do not divide, or a
    head wider than the attention kernels take
    (``attention.HEAD_DIM_CEILING``, 2^30 columns).  The kernels take
    every other width, and every key count and batch (``ops``: attention
    streams K past shared memory, and past
    ``attention.RESIDENT_Q_MAX_HEAD_DIM`` computes each score once into a
    workspace; LayerNorm and the MLP take any width).  With `model` tensor-parallel ranks the split is held to
    :func:`check_split` first."""
    check_split(config, model)
    for field, tf in _transformers(config):
        hidden, heads = tf.hidden_size, tf.num_attention_heads
        if heads <= 0 or hidden % heads:
            raise ValueError(f"{field}: hidden_size {hidden} is not a "
                             f"multiple of num_attention_heads {heads}")
        widest = attention_op.HEAD_DIM_CEILING
        if hidden // heads > widest:
            raise ValueError(f"{field}: head dim {hidden // heads} "
                             f"(hidden_size {hidden} / {heads} heads) over "
                             f"the {widest} the attention kernels take")
    broken = attention_op.limit_broken(dtype) or mlp_op.limit_broken(dtype)
    if broken:
        raise ValueError(f"kernel limit: {broken}")


def _transformers(config: FACTModelConfig):
    """(field name, TransformerConfig) of each transformer the model
    builds: the modality encoders', then the cross-modal one."""
    models, _, _ = build_modalities_model(config.modality)
    stacks = [(f"modality {name!r} transformer",
               models[name].get("transformer_layer"))
              for name in ("motion", "audio") if name in models]
    stacks.append(("cross_modal_model.transformer",
                   config.cross_modal_model.transformer))
    return [(field, tf) for field, tf in stacks if tf is not None]


def check_split(config: FACTModelConfig, model: int) -> None:
    """Raise ValueError, naming the field, where `model` tensor-parallel
    ranks do not split a transformer as the JAX package's rules do.

    The JAX package takes any model axis that divides each dim its rules
    split (``mint_tpu/parallel/mesh.py:43-53``): ``to_qkv``'s 3 x hidden
    columns, ``to_out``'s hidden rows and the MLP width; so does this
    check.  A rank here computes a contiguous run of whole heads where the
    ranks are no more than the heads, else a contiguous run of one head's
    columns (``parallel.mesh.head_columns``)."""
    if model <= 1:
        return
    for field, tf in _transformers(config):
        for name, size in (("hidden_size", tf.hidden_size),
                           ("3 x hidden_size", 3 * tf.hidden_size),
                           ("intermediate_size", tf.intermediate_size)):
            if size % model:
                raise ValueError(f"{field}: {name} {size} does not split "
                                 f"over {model} model ranks")


def build(model_config: MultiModalModelConfig, is_training: bool,
          dtype: torch.dtype = torch.float32,
          device: torch.device | str = "cuda",
          compute_dtype: torch.dtype | None = None, mesh=None,
          ln_affine_folded: bool = False) -> FACT:
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
    raises rather than building on the CPU.  On the card the config is
    first held to the kernels (:func:`check_kernel_limits`): a dtype no
    kernel takes fails here, not mid-decode or mid-step.

    `mesh` (``parallel/mesh.py``) with a model axis over 1 builds this
    rank's slice of every attention and MLP, as :func:`check_split`
    allows.  Load a full state_dict into it through
    ``parallel.shard_state_dict``.

    ``ln_affine_folded`` builds the inference variant whose Blocks'
    LayerNorms carry no parameters (``models/fold.py``: load weights
    from ``fold_ln_affines``)."""
    device = torch.device(device)
    parts = mesh.model if mesh is not None else 1
    if model_config.which() == "fact_model":
        if device.type == "cuda":
            check_kernel_limits(model_config.fact_model,
                                compute_dtype or dtype, parts)
        else:
            check_split(model_config.fact_model, parts)
    device = resolve(device, "builder.build")
    build_func = MODEL_BUILDER_MAP[model_config.which()]
    model = build_func(model_config, is_training,
                       compute_dtype=compute_dtype, mesh=mesh,
                       ln_affine_folded=ln_affine_folded).to(
                           device=device, dtype=dtype)
    # LayerNorm keeps f32 parameters under any cast, as Flax's
    # LayerNorm(dtype=...) keeps its scale and bias (models/layers.py).
    # They are 1 and 0 at this point, so the cast above lost nothing.
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.float()
    return model.train(is_training)
