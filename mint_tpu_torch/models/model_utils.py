"""Model helper functions (counterpart of ``mint_tpu/models/model_utils.py``,
the reference ``mint/core/base_model_util.py``), as plain functions on
tensors.

The full helper surface: masks, dropout, GELU, the activation table,
gather and split utilities, masked scaled-dot-product attention.  As in
the JAX package, the FACT path does not use them (the reference never
wires the masks into ``Attention``, base_models.py:75-88); they serve
masked and spatial model variants.  The masked attention helper is the
reference's formula in plain PyTorch, not a kernel path.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from mint_tpu_torch.models import layers


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
    """Inverted dropout (base_model_util.py:21-36): each element kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the rest
    zero, drawn from `generator` (on x's device).  The identity when
    `deterministic`, at rate 0 or without a generator, as the JAX
    function is without a key.  Its draws are torch's, not JAX's."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def create_look_ahead_mask(seq_length: int,
                           batch_size: int = 0) -> torch.Tensor:
    """Causal mask, 1 where attention is disallowed (the future), f32
    [seq, seq] or [batch, seq, seq] (base_model_util.py:39-52)."""
    mask = 1.0 - torch.tril(torch.ones(seq_length, seq_length))
    if batch_size > 0:
        mask = mask[None].repeat(batch_size, 1, 1)
    return mask


def create_attention_mask_from_input_mask(from_tensor: torch.Tensor,
                                          to_mask: torch.Tensor
                                          ) -> torch.Tensor:
    """[B, F, ...] and a [B, T] padding mask -> the f32 mask [B, F, T]
    (base_model_util.py:55-86)."""
    batch_size, from_seq = from_tensor.shape[0], from_tensor.shape[1]
    to_mask = to_mask.reshape(batch_size, 1, to_mask.shape[1]).float()
    return torch.ones(batch_size, from_seq, 1,
                      device=to_mask.device) * to_mask


def create_initializer(initializer_range: float = 0.02) -> Callable:
    """The reference's truncated-normal initializer
    (base_model_util.py:89-91): fills a tensor in place with the port's
    ``trunc_normal_`` (sigma `initializer_range`, cut at 2 sigma)."""

    def init(t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return layers.trunc_normal_(t, initializer_range, generator)

    return init


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (base_model_util.py:94-107): the port's one
    implementation, ``layers.gelu_tanh``."""
    return layers.gelu_tanh(x)


def get_activation(activation_string) -> Optional[Callable]:
    """The activation named `activation_string` from the port's table
    (``layers.ACTIVATIONS``; base_model_util.py:110-144): a callable is
    returned as is, an empty name or "linear" gives None, an unknown name
    raises ValueError."""
    if not isinstance(activation_string, str):
        return activation_string
    if not activation_string:
        return None
    act = activation_string.lower()
    if act not in layers.ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {act}")
    return layers.ACTIVATIONS[act]


def get_shape_list(tensor: torch.Tensor) -> list:
    """The tensor's shape as a list (base_model_util.py:147-171)."""
    return list(tensor.shape)


def gather_indexes(sequence_tensor: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """[B, S, W] at [B, P] positions of each row -> [B, P, W]
    (base_model_util.py:174-188)."""
    batch_size, seq_length, width = sequence_tensor.shape
    offsets = (torch.arange(batch_size, device=positions.device)
               * seq_length).reshape(-1, 1)
    flat_positions = (positions.long() + offsets).reshape(-1)
    flat = sequence_tensor.reshape(batch_size * seq_length, width)
    return flat[flat_positions].reshape(batch_size, -1, width)


def split_heads(x: torch.Tensor, num_attention_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H], or the spatial [B, T, J, D] ->
    [B, T, H, J, D/H] (base_model_util.py:191-219)."""
    depth = x.shape[-1] // num_attention_heads
    if x.dim() == 4:
        b, t, j, _ = x.shape
        return x.reshape(b, t, j, num_attention_heads, depth).permute(
            0, 1, 3, 2, 4)
    if x.dim() == 3:
        b, t, _ = x.shape
        return x.reshape(b, t, num_attention_heads, depth).permute(0, 2, 1, 3)
    raise ValueError("Unsupported input tensor dimension.")


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention scaled by the head dim, ``1 / sqrt(d)``
    (base_model_util.py:222-253): returns (output, attention weights).
    The mask is 1 where attention is disallowed, added to the logits as
    ``mask * -1e9``."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(k.shape[-1])
    if mask is not None:
        logits = logits + mask * -1e9
    weights = torch.softmax(logits, dim=-1)
    return weights @ v, weights
