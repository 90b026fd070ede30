"""Fold the pre-LN scale and bias into the next QKV and fc1 kernels: the
port's counterpart of ``mint_tpu/models/fold.py``, on state_dicts.

Every LayerNorm of a FACT ``Block`` (``norm_attn`` and ``norm_mlp``)
feeds exactly one matmul, so its affine moves into that matmul's
weights::

    (g * xn + beta) @ W  ==  xn @ (g[:, None] * W)  +  beta @ W

with ``xn`` the normalised activations.  In nn.Linear's ``[out, in]``
layout that is ``weight * g`` (g along the input columns) and a bias
``weight @ beta``: a new bias of ``to_qkv``, added to fc1's own.  The
folded model (``ln_affine_folded=True``) runs its LayerNorms without
parameters (in bf16 through the affine-free form of the LayerNorm
kernel, ``ops/layer_norm.py``) and gives ``to_qkv`` a bias.  The
arithmetic is f32; each folded leaf is cast back to its own dtype.

Checkpoints are never stored folded: the fold is applied after a
restore (``Evaluator(fold_ln=True)``), and training uses the unfolded
model.  It works on a tensor-parallel rank's slice as well: the
LayerNorms are whole on every rank, and the rank's rows of ``to_qkv``
and fc1 fold into the rank's rows of their biases.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from mint_tpu_torch.models import layers
from mint_tpu_torch.models.fact import FACT

_NORMS = ((".norm_attn.", ".attn.to_qkv."), (".norm_mlp.", ".mlp.fc1."))


def _fold_into(weight: torch.Tensor, bias, g: torch.Tensor,
               beta: torch.Tensor, bias_dtype: torch.dtype):
    """(weight * g, bias + weight @ beta): the LayerNorm's scale g and
    shift beta moved into the Linear (weight [out, in], bias [out] or
    None), in f32, cast to weight's and `bias_dtype`."""
    w = weight.float()
    b = w @ beta
    if bias is not None:
        b = bias.float() + b
    return (w * g[None, :]).to(weight.dtype), b.to(bias_dtype)


def fold_ln_affines(state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A new state_dict with every Block's LayerNorm affines folded into
    its ``to_qkv`` and fc1: the weights of the ``ln_affine_folded`` twin
    of the model `state_dict` belongs to (no ``norm_attn`` or
    ``norm_mlp`` leaves; a ``to_qkv.bias``).  As the JAX fold does, only
    a block that still holds both LayerNorms is folded, so weights that
    are folded already come back unchanged (as a copy); a block with
    both LayerNorms and a ``to_qkv.bias`` (a half-folded tree) raises
    ValueError."""
    out = dict(state_dict)
    suffix = _NORMS[0][0] + "weight"
    for key in state_dict:
        block = key[:-len(suffix)]
        if (not key.endswith(suffix)
                or block + _NORMS[1][0] + "weight" not in state_dict):
            continue
        if block + ".attn.to_qkv.bias" in state_dict:
            raise ValueError(f"{block}.attn.to_qkv.bias exists beside its "
                             "LayerNorms: the weights look folded already")
        for norm, dense in _NORMS:
            g = out.pop(block + norm + "weight").float()
            beta = out.pop(block + norm + "bias").float()
            weight = out[block + dense + "weight"]
            bias = out.get(block + dense + "bias")
            out[block + dense + "weight"], out[block + dense + "bias"] = (
                _fold_into(weight, bias, g, beta,
                           weight.dtype if bias is None else bias.dtype))
    return out


def fold_for_decode(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
                    ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """The ``ln_affine_folded`` twin of `model` (a FACT: same config,
    dtype, device, compute dtype and mesh slice, with the folded weights
    loaded) and those weights.  A no-op, returning its inputs, on a model
    that is folded already."""
    if getattr(model, "ln_affine_folded", False):
        return model, state_dict
    params = fold_ln_affines(state_dict)
    mesh = next((m.mesh for m in model.modules()
                 if isinstance(m, layers.Attention)), None)
    twin = FACT(model.config, audio_dim=model.audio_dim,
                compute_dtype=model.compute_dtype, mesh=mesh,
                ln_affine_folded=True)
    twin = twin.to(device=model.device, dtype=model.dtype)
    twin.load_state_dict(params)
    return twin.train(model.training), params
