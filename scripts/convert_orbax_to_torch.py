"""A ``mint_tpu`` (JAX) training checkpoint -> a port checkpoint.

    python scripts/convert_orbax_to_torch.py --orbax_dir=<JAX model_dir> \\
        --config_path=<pipeline config> --output_dir=<port model_dir> \\
        [--step=N]

The JAX trainer saves its TrainState with Orbax
(``ocp.args.StandardSave``, ``mint_tpu/train/checkpoint.py:130``) as
``<model_dir>/<step>/default``.  This restores a step (default: the
latest) with Orbax alone, without a template, into numpy: the step, the
parameters and the optimizer state, whose Adam slot (``count``, ``mu``,
``nu``) it finds wherever optax's chain put it (after an
``EmptyState`` of the clip, or inside ``optax.MultiSteps``'
``inner_opt_state``, whose ``mini_step`` and ``acc_grads`` it carries
too).  Parameters and moments cross by the port's Flax-name bridge
(``mint_tpu_torch/models/weights.from_jax_params``), and the result is
written as ``<output_dir>/<step>/{params,opt_state}.pt`` by the port's
checkpoint writer.  The port's train CLI run with ``--model_dir`` there
then resumes at the JAX step, and the server and the evaluate CLI read
its parameters.

It needs Orbax (and so JAX), which the card's machine does not have:
convert where Orbax is, then copy the port checkpoint.  It imports
nothing of ``mint_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mint_tpu_torch.models import weights  # noqa: E402
from mint_tpu_torch.tools.convert_checkpoint import (  # noqa: E402
    template_model)
from mint_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from mint_tpu_torch.train.trainer import TrainState  # noqa: E402


def restore_orbax(orbax_dir: str, step: Optional[int] = None
                  ) -> tuple[int, Dict[str, Any]]:
    """(step, the restored TrainState tree as numpy) of `orbax_dir`'s
    checkpoint at `step` (default: the latest)."""
    import orbax.checkpoint as ocp

    steps = sorted(int(d) for d in os.listdir(orbax_dir) if d.isdigit())
    if not steps:
        raise FileNotFoundError(f"no checkpoint step in {orbax_dir}")
    step = steps[-1] if step is None else step
    tree = ocp.StandardCheckpointer().restore(
        os.path.join(os.path.abspath(orbax_dir), str(step), "default"))
    return step, _to_numpy(tree)


def _to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def _adam_slot(tree) -> Optional[Mapping]:
    """The ``scale_by_adam`` state (a mapping with count, mu and nu)
    anywhere in an optax state tree."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, list):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_slot(child)
        if found is not None:
            return found
    return None


def convert(tree: Mapping[str, Any], model) -> TrainState:
    """The port's TrainState (f32 CPU tensors) of a restored JAX
    TrainState tree: parameters, step and, where the tree has one, the
    optimizer state in the port's layout."""
    params = weights.from_jax_params(tree["params"], model)
    opt = tree.get("opt_state")
    opt_state = None
    if opt is not None:
        adam = _adam_slot(opt)
        if adam is None:
            raise ValueError("no Adam state (count, mu, nu) in the "
                             "checkpoint's optimizer state")
        opt_state = {"count": int(adam["count"]),
                     "mu": weights.from_jax_params(adam["mu"], model),
                     "nu": weights.from_jax_params(adam["nu"], model)}
        if isinstance(opt, Mapping) and "acc_grads" in opt:  # MultiSteps
            opt_state["mini_step"] = int(opt["mini_step"])
            opt_state["acc"] = weights.from_jax_params(opt["acc_grads"],
                                                       model)
    return TrainState(step=int(tree["step"]), params=params,
                      opt_state=opt_state)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--orbax_dir", required=True,
                   help="The JAX train CLI's model_dir.")
    p.add_argument("--config_path", required=True,
                   help="The run's pipeline config.")
    p.add_argument("--output_dir", required=True,
                   help="Port checkpoint directory to write.")
    p.add_argument("--step", type=int, default=None,
                   help="Step to convert (default: the latest).")
    args = p.parse_args(argv)
    step, tree = restore_orbax(args.orbax_dir, args.step)
    state = convert(tree, template_model(args.config_path))
    manager = CheckpointManager(args.output_dir, max_to_keep=5)
    manager.save(state.step, state, force=True)
    manager.close()
    print(f"wrote step {state.step} (orbax dir step {step}) to "
          f"{args.output_dir}")


if __name__ == "__main__":
    main()
