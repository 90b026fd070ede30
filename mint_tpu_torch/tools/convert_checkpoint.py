"""The reference TF checkpoint -> a port checkpoint (the port's twin of
``mint_tpu/tools/convert_checkpoint.py``).

    python -m mint_tpu_torch.tools.convert_checkpoint \\
        --tf_checkpoint=/path/to/ckpt-200000 \\
        --config_path=configs/fact_v5_deeper_t10_cm12.config \\
        --output_dir=/path/to/run

The released ``fact_v5_deeper_t10_cm12`` checkpoint is a TF2 object-graph
checkpoint of ``tf.train.Checkpoint(model=FACTModel(...), ...)``.  Its
keys are attribute paths through the Keras object graph, for example

  model/motion_transformer/net/layer_with_weights-{2i}/fn/fn/to_qkv/kernel
        /.ATTRIBUTES/VARIABLE_VALUE

:func:`_flax_key_for` (the port's own copy of the JAX converter's map)
turns each into the Flax parameter path of the JAX package, and
``models/weights.from_jax_params`` turns those into the port's
``state_dict``: Keras Dense kernels are stored [in, out], the Flax layout,
so the only reshaping is the bridge's transpose into ``nn.Linear``'s
[out, in].  The result is written as step 0 of a port checkpoint
(``<output_dir>/0/params.pt``) by ``train/checkpoint.py``'s writer, which
the server's ``--checkpoint_dir`` and the evaluate CLI read as they are.

Two layers: :func:`convert_tf_variables` is a pure function of a
``{tf_name: ndarray}`` dict and needs no tensorflow; :func:`load_tf_variables`
reads a checkpoint's variables and imports tensorflow only when called,
raising a clear ImportError where it is missing.  The model built from
the config is a template of names and shapes only: nothing is computed,
so it is built on the CPU.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mint_tpu_torch.models import weights

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"

# Keras LayerNormalization's variable names -> Flax's.
_NORM = {"gamma": "scale", "beta": "bias"}


def _flax_key_for(tf_key: str) -> Tuple[str, ...]:
    """Map one reference TF variable path to the Flax params path.

    Raises KeyError for unmapped (non-model / optimizer) variables.
    """
    if not tf_key.endswith(_SUFFIX):
        raise KeyError(tf_key)
    path = tf_key[:-len(_SUFFIX)]
    if not path.startswith("model/"):
        raise KeyError(tf_key)
    path = path[len("model/"):]

    # Linear embeddings: {m}_linear_embedding/net/{kernel,bias}
    m = re.fullmatch(r"(\w+)_linear_embedding/net/(kernel|bias)", path)
    if m:
        return (f"{m.group(1)}_linear_embedding", "dense", m.group(2))

    # Position embeddings: Keras tracks the add_weight variable under its
    # weight name "position_embedding", not the Python attribute; both
    # spellings are taken.
    m = re.fullmatch(r"(\w+)_pos_embedding/(?:pos|position)_embedding",
                     path)
    if m:
        return (f"{m.group(1)}_pos_embedding", "pos_embedding")

    # Transformers (single-modal or cross-modal).
    m = re.fullmatch(
        r"(\w+_transformer|cross_modal_layer/transformer_layer)"
        r"/net/layer_with_weights-(\d+)/fn/(.+)", path)
    if m:
        owner = m.group(1)
        prefix = (("cross_modal_layer", "transformer")
                  if owner.startswith("cross_modal_layer") else (owner,))
        lw = int(m.group(2))
        block = f"block_{lw // 2}"
        rest = m.group(3)
        if lw % 2 == 0:  # attention block
            mm = re.fullmatch(r"norm/(gamma|beta)", rest)
            if mm:
                return prefix + (block, "norm_attn", _NORM[mm.group(1)])
            mm = re.fullmatch(r"fn/(to_qkv|to_out)/(kernel|bias)", rest)
            if mm:
                return prefix + (block, "attn", mm.group(1), mm.group(2))
        else:  # mlp block
            mm = re.fullmatch(r"norm/(gamma|beta)", rest)
            if mm:
                return prefix + (block, "norm_mlp", _NORM[mm.group(1)])
            mm = re.fullmatch(
                r"fn/net/layer_with_weights-([01])/(kernel|bias)", rest)
            if mm:
                fc = "fc1" if mm.group(1) == "0" else "fc2"
                return prefix + (block, "mlp", fc, mm.group(2))

    # Cross-modal output head.
    m = re.fullmatch(r"cross_modal_layer/cross_output_layer/(kernel|bias)",
                     path)
    if m:
        return ("cross_modal_layer", "cross_output_layer", m.group(1))

    raise KeyError(tf_key)


def _tf_key_for(path: Sequence[str]) -> str:
    """The reference TF variable path of a Flax params path: the inverse
    of :func:`_flax_key_for`, which the checks use to rename a model's
    weights to the released checkpoint's names."""
    norm = {v: k for k, v in _NORM.items()}
    *owner, leaf = path
    if len(owner) == 2 and owner[1] == "dense":
        tf = f"{owner[0]}/net/{leaf}"
    elif leaf == "pos_embedding":
        tf = f"{owner[0]}/pos_embedding"
    elif owner == ["cross_modal_layer", "cross_output_layer"]:
        tf = f"cross_modal_layer/cross_output_layer/{leaf}"
    else:
        at = next(j for j, name in enumerate(owner)
                  if name.startswith("block_"))
        stack = ("cross_modal_layer/transformer_layer"
                 if owner[:at] == ["cross_modal_layer", "transformer"]
                 else owner[0])
        i = int(owner[at][len("block_"):])
        layer, sub = owner[at + 1], owner[at + 2:]
        if layer == "norm_attn":
            rest = f"{2 * i}/fn/norm/{norm[leaf]}"
        elif layer == "norm_mlp":
            rest = f"{2 * i + 1}/fn/norm/{norm[leaf]}"
        elif layer == "attn":
            rest = f"{2 * i}/fn/fn/{sub[0]}/{leaf}"
        else:  # mlp
            fc = {"fc1": 0, "fc2": 1}[sub[0]]
            rest = (f"{2 * i + 1}/fn/fn/net/layer_with_weights-{fc}/"
                    f"{leaf}")
        tf = f"{stack}/net/layer_with_weights-{rest}"
    return f"model/{tf}{_SUFFIX}"


def tf_variables_of(model: nn.Module) -> Dict[str, np.ndarray]:
    """`model`'s weights under the reference checkpoint's TF names (f32
    arrays in the Keras [in, out] layout)."""
    tree = weights.to_numpy_tree(model)["params"]
    flat = weights._flatten(tree)
    return {_tf_key_for(path.split("/")): value
            for path, value in flat.items()}


def convert_tf_variables(tf_vars: Mapping[str, np.ndarray],
                         model: nn.Module
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """The reference's TF variables (raw key -> array) as a ``state_dict``
    for `model` (f32 CPU tensors), and a report of the TF keys left out
    (key -> "unmapped", or "extra (not in model)").  Raises ValueError
    naming any parameter of the model that the variables miss, or a
    shape that does not fit."""
    wanted = {path for path, _ in weights._leaf_names(model).values()}
    tree: Dict = {}
    report: Dict[str, str] = {}
    for key, value in tf_vars.items():
        try:
            path = _flax_key_for(key)
        except KeyError:
            report[key] = "unmapped"
            continue
        if "/".join(path) not in wanted:
            report[key] = "extra (not in model)"
            continue
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.asarray(value)
    return weights.from_jax_params(tree, model), report


def load_tf_variables(ckpt_path: str) -> Dict[str, np.ndarray]:
    """All model variables of a TF checkpoint, by raw key (needs
    tensorflow, imported here)."""
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:
        raise ImportError(
            "tensorflow is required to read the reference checkpoint; "
            "install it, or convert on a machine that has it (the "
            "converted checkpoint needs no tensorflow)") from e
    reader = py_checkpoint_reader.NewCheckpointReader(ckpt_path)
    return {key: reader.get_tensor(key)
            for key in reader.get_variable_to_shape_map()
            if key.endswith(_SUFFIX) and key.startswith("model/")}


def convert_tf_checkpoint(ckpt_path: str, model: nn.Module
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """:func:`convert_tf_variables` of the checkpoint at `ckpt_path`."""
    return convert_tf_variables(load_tf_variables(ckpt_path), model)


def write_checkpoint(state: Mapping[str, torch.Tensor], output_dir: str,
                     step: int = 0) -> None:
    """Write `state` as the parameters of step `step` of a port
    checkpoint in `output_dir` (no optimizer state)."""
    from mint_tpu_torch.train.checkpoint import CheckpointManager
    from mint_tpu_torch.train.trainer import TrainState

    manager = CheckpointManager(output_dir, max_to_keep=1)
    manager.save(step, TrainState(step=step, params=dict(state),
                                  opt_state=None), force=True)
    manager.close()


def template_model(config_path: str) -> nn.Module:
    """The config's FACT on the CPU, as a template of names and shapes."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models.fact import FACT

    pipeline = load_pipeline_config(config_path)
    return FACT(pipeline.multi_modal_model.fact_model)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tf_checkpoint", required=True,
                   help="TF checkpoint prefix (the reference's release).")
    p.add_argument("--config_path", required=True, help="Pipeline config.")
    p.add_argument("--output_dir", required=True,
                   help="Port checkpoint directory to write (step 0).")
    args = p.parse_args(argv)
    state, report = convert_tf_checkpoint(
        args.tf_checkpoint, template_model(args.config_path))
    for key, why in sorted(report.items()):
        print(f"skipped: {key} ({why})")
    write_checkpoint(state, args.output_dir)
    print(f"wrote converted checkpoint to {args.output_dir}")


if __name__ == "__main__":
    main()
