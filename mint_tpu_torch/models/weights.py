"""Weights bridge between the Flax parameter tree of ``mint_tpu`` and the
port's ``state_dict``.

The port's modules carry the Flax module names, so a leaf
``params/cross_modal_layer/transformer/block_3/attn/to_qkv/kernel`` maps to
``cross_modal_layer.transformer.block_3.attn.to_qkv.weight``.  A Dense
``kernel [in, out]`` becomes ``Linear.weight [out, in]`` (transposed),
LayerNorm ``scale``/``bias`` become ``weight``/``bias``, and
``pos_embedding`` is copied as is.  Only numpy arrays cross the bridge.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from mint_tpu_torch.models import layers


def _leaf_names(model: nn.Module) -> Dict[str, tuple]:
    """state_dict key -> (Flax path, transpose?) for every parameter."""
    out = {}
    for mod_name, module in model.named_modules():
        prefix = mod_name.split(".") if mod_name else []
        if isinstance(module, nn.Linear):
            out[f"{mod_name}.weight"] = ("/".join(prefix + ["kernel"]), True)
            if module.bias is not None:
                out[f"{mod_name}.bias"] = ("/".join(prefix + ["bias"]), False)
        elif isinstance(module, nn.LayerNorm):
            out[f"{mod_name}.weight"] = ("/".join(prefix + ["scale"]), False)
            out[f"{mod_name}.bias"] = ("/".join(prefix + ["bias"]), False)
        elif isinstance(module, layers.PositionEmbedding):
            out[f"{mod_name}.pos_embedding"] = (
                "/".join(prefix + ["pos_embedding"]), False)
    return out


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def from_jax_params(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """Flax variables ``{"params": {...}}`` (or the inner dict) of numpy
    arrays -> a ``state_dict`` for `model` (f32 CPU tensors; load it with
    ``model.load_state_dict``, which casts to the model's dtype/device).

    Raises ValueError naming any missing or extra leaf or wrong shape.
    """
    if set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    names = _leaf_names(model)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    wanted = {path: (key, transpose)
              for key, (path, transpose) in names.items()}
    missing = sorted(set(wanted) - set(flat))
    extra = sorted(set(flat) - set(wanted))
    if missing or extra:
        raise ValueError(f"params do not match the model: missing "
                         f"{missing}, extra {extra}")
    state = {}
    for path, (key, transpose) in wanted.items():
        arr = np.asarray(flat[path], np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != shapes[key]:
            raise ValueError(
                f"{path}: shape {tuple(flat[path].shape)} does not fit "
                f"{key} {shapes[key]}" + (" (transposed)" if transpose
                                          else ""))
        state[key] = torch.tensor(arr)
    return state


def to_numpy_tree(model: nn.Module) -> Dict[str, Dict]:
    """The model's weights as a Flax-shaped ``{"params": {...}}`` tree of
    f32 numpy arrays (the inverse of :func:`from_jax_params`)."""
    state = model.state_dict()
    tree: Dict[str, Dict] = {}
    for key, (path, transpose) in _leaf_names(model).items():
        arr = state[key].detach().float().cpu().numpy()
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr.T if transpose else arr)
    return {"params": tree}
