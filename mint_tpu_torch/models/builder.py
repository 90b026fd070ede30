"""Model registry / builder (counterpart of ``mint_tpu/models/builder.py``)."""

from __future__ import annotations

import torch
from torch import nn

from mint_tpu_torch.config.schema import (FACTModelConfig,
                                          MultiModalModelConfig)
from mint_tpu_torch.models import layers
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.models.modalities import build_modalities_model
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import layer_norm as layer_norm_op
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
    """Raise ValueError, naming the limit and the config field, where the
    model `config` builds would hand a hand-written kernel of `dtype` a
    shape it does not take: each transformer's head dim over its keys
    (the motion window, the audio window, and both for the cross-modal
    stack) to attention, its hidden and MLP widths to the fused MLP and,
    in bf16, its hidden width to LayerNorm.  The kernels' own limits are
    the ops modules' ``limit_broken``.  A pure function of the config: the
    limits that depend on the batch are :func:`check_batch`'s.

    With `model` tensor-parallel ranks the shapes are a rank's: its heads
    (the head dim is unchanged) and its slice of the MLP width, as
    :func:`check_split` allows them.
    """
    check_split(config, model)
    models, params, _ = build_modalities_model(config.modality)
    seq = {name: p["sequence_length"] for name, p in params.items()}
    keys_cross = seq.get("motion", 0) + seq.get("audio", 0)
    stacks = [(f"modality {name!r} transformer",
               models[name].get("transformer_layer"), seq[name],
               f"sequence_length {seq[name]}")
              for name in ("motion", "audio") if name in models]
    stacks.append(("cross_modal_model.transformer",
                   config.cross_modal_model.transformer, keys_cross,
                   f"motion + audio sequence_length {seq.get('motion', 0)}"
                   f" + {seq.get('audio', 0)} = {keys_cross}"))
    for field, tf, keys, why in stacks:
        if tf is None:
            continue  # FACT itself refuses a config without it
        hidden, heads = tf.hidden_size, tf.num_attention_heads
        if heads <= 0 or hidden % heads:
            raise ValueError(f"{field}: hidden_size {hidden} is not a "
                             f"multiple of num_attention_heads {heads}")
        broken = attention_op.limit_broken(dtype, hidden // heads, keys)
        if broken:
            raise ValueError(
                f"{field}: head dim {hidden // heads} (hidden_size {hidden}"
                f" / num_attention_heads {heads}) over {why} keys: "
                f"attention kernel limit: {broken}")
        width = tf.intermediate_size // model
        broken = mlp_op.limit_broken(dtype, hidden, width, hidden)
        if broken:
            raise ValueError(
                f"{field}: hidden_size {hidden} -> intermediate_size "
                f"{tf.intermediate_size}" + (f" / {model} model ranks = "
                                             f"{width}" if model > 1 else "")
                + f" -> hidden_size {hidden}: fused MLP kernel limit: "
                f"{broken}")
        broken = (layer_norm_op.limit_broken(hidden)
                  if dtype == torch.bfloat16 else None)
        if broken:
            raise ValueError(f"{field}: hidden_size {hidden}: bf16 "
                             f"LayerNorm kernel limit: {broken}")


def check_split(config: FACTModelConfig, model: int) -> None:
    """Raise ValueError, naming the field, where `model` tensor-parallel
    ranks do not split a transformer as the JAX package's rules do, or
    would leave a rank without a head.

    The JAX package takes any model axis that divides each dim its rules
    split (``mint_tpu/parallel/mesh.py:43-53``): ``to_qkv``'s 3 x hidden
    columns, ``to_out``'s hidden rows and the MLP width; so does this
    check.  Each rank here computes a contiguous run of whole heads, their
    counts differing by at most one (``parallel.mesh.head_split``: the
    flagship's 10 heads over 4 ranks are 3, 3, 2 and 2), so a model axis
    larger than a transformer's heads is refused, where JAX would take
    it."""
    if model <= 1:
        return
    models, _, _ = build_modalities_model(config.modality)
    stacks = [(f"modality {name!r} transformer",
               models[name].get("transformer_layer"))
              for name in ("motion", "audio") if name in models]
    stacks.append(("cross_modal_model.transformer",
                   config.cross_modal_model.transformer))
    for field, tf in stacks:
        if tf is None:
            continue
        for name, size in (("hidden_size", tf.hidden_size),
                           ("3 x hidden_size", 3 * tf.hidden_size),
                           ("intermediate_size", tf.intermediate_size)):
            if size % model:
                raise ValueError(f"{field}: {name} {size} does not split "
                                 f"over {model} model ranks")
        if tf.num_attention_heads < model:
            raise ValueError(
                f"{field}: num_attention_heads {tf.num_attention_heads} "
                f"do not fill {model} model ranks (a rank would hold no "
                "head)")


def check_batch(model: FACT, batch: int) -> None:
    """Raise ValueError where `batch` samples would give the attention
    kernels more (batch, head) pairs than they take: the decoder and the
    trainer call it on the card before any step, so a capture never
    starts on a batch the kernels refuse."""
    heads = max(m.heads for m in model.modules()
                if isinstance(m, layers.Attention))
    if batch * heads > attention_op.MAX_BATCH_HEADS:
        raise ValueError(
            f"batch {batch} x {heads} attention heads = {batch * heads} "
            f"(batch, head) pairs: the attention kernels take at most "
            f"{attention_op.MAX_BATCH_HEADS}")


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
    first held to the kernels' limits (:func:`check_kernel_limits`): a
    shape a kernel refuses fails here, not mid-decode or mid-step.

    `mesh` (``parallel/mesh.py``) with a model axis over 1 builds this
    rank's slice of every attention and MLP, as :func:`check_split`
    allows, and on the card the kernels' limits are checked at the
    slice's shapes.  Load a full state_dict into it through
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
