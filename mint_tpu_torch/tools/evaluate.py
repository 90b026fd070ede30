"""Continuous generation-eval CLI of the port (counterpart of
``mint_tpu/tools/evaluate.py``, the reference evaluator.py).

    python -m mint_tpu_torch.tools.evaluate \\
        --config_path=configs/fact_v5_deeper_t10_cm12.config \\
        --model_dir=/path/to/run --output_dir=outputs [--use_bfloat16]

Watches `model_dir` for checkpoints (the port's format, as the train CLI
writes them); for each one it restores the parameters only, generates the
eval set (the config's ``eval_dataset``) with the batched decoder and writes
``{output_dir}/{motion_name}_{audio_name}.npy`` clips of shape
[seed 120 + generated, 225] for ``calculate_scores``.  It stops when no new
checkpoint has appeared for ``--timeout`` seconds.

The model is f32 by default (the reference evaluates in f32); under
``--use_bfloat16`` it is cast to bf16 once, LayerNorm kept in f32, which
gives the JAX evaluator's ``compute_dtype=bf16`` forward.  f32 matmuls run
in true f32 (no TF32).  It runs on the CUDA cards unless ``--device=cpu``
is given (as the tests do); without a card the default raises.
``--data_parallelism`` (default 0: every card, as the JAX CLI's mesh)
decodes over that many replicas of the parameters, one a card, each
dispatch's clips split over them (``parallel/replicas.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence

import torch

from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.data import pipeline as data_pipeline
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.models import builder
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import layer_norm as layer_norm_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.parallel.replicas import devices_for
from mint_tpu_torch.train.checkpoint import CheckpointManager
from mint_tpu_torch.train.controller import Controller
from mint_tpu_torch.train.trainer import TrainState

log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True,
                   help="Directory the training checkpoints are in.")
    p.add_argument("--config_path", required=True,
                   help="Path to the config file.")
    p.add_argument("--eval_prefix", default="valid",
                   help="Subdirectory of model_dir for eval summaries.")
    p.add_argument("--output_dir", default="outputs",
                   help="Where to save the generated clips.")
    p.add_argument("--steps", type=int, default=1200,
                   help="Frames to generate per clip.")
    p.add_argument("--timeout", type=float, default=70000,
                   help="Seconds to keep watching for new checkpoints.")
    p.add_argument("--poll_seconds", type=float, default=10.0,
                   help="Seconds between looks for a new checkpoint.")
    p.add_argument("--use_bfloat16", action="store_true",
                   help="Decode in bfloat16 (the reference evaluates in "
                        "f32).")
    p.add_argument("--steps_bucket", type=int, default=128,
                   help="Quantise generatable lengths up to multiples of "
                        "this, so nearby audio lengths share one decode (0 "
                        "= off).  Exact: padded audio is never read by kept "
                        "frames and the overshoot is trimmed per clip.")
    p.add_argument("--decode_batch", type=int, default=0,
                   help="Max clips per decode dispatch; 0 (default) = "
                        "the evaluator's DECODE_BATCH, the cap that "
                        "generated the most frames/s over the scoring "
                        "protocol's 40 clips on one card.")
    p.add_argument("--reload_dataset_per_pass", action="store_true",
                   help="Re-read the eval tfrecords for every checkpoint "
                        "pass instead of caching the parsed corpus.")
    p.add_argument("--data_parallelism", type=int, default=0,
                   help="Decode over this many replicas, one a card (0 = "
                   "every card; 1 = one card); each dispatch's clips split "
                   "over them.  On the CPU, replicas on the CPU (0 = 1).")
    p.add_argument("--device", default="cuda",
                   help="Device to evaluate on: 'cuda' (one card, the "
                        "default) or 'cpu'.")
    # Accepted and unused, as in the reference (evaluator.py:36-41), so
    # that sweep scripts that pass them keep working.
    p.add_argument("--initial_learning_rate", type=float, default=0.1,
                   help="UNUSED FLAG.")
    p.add_argument("--weight_decay", type=float, default=None,
                   help="UNUSED FLAG.")
    return p.parse_args(argv)


class _EvalAdapter:
    """Adapts Evaluator to the Controller's evaluator protocol."""

    def __init__(self, evaluator: Evaluator):
        self._evaluator = evaluator

    def evaluate(self, state: TrainState):
        return self._evaluator.evaluate(state.params)


def evaluate(args: argparse.Namespace) -> dict:
    """Evaluate every checkpoint that appears in ``args.model_dir`` until
    none has for ``args.timeout`` s; returns the last pass's metrics."""
    # f32 is the reference's scoring semantics: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipeline = load_pipeline_config(args.config_path)
    builder.require_fact(pipeline.multi_modal_model, "the evaluate CLI")
    model = builder.build(
        pipeline.multi_modal_model, is_training=False,
        dtype=torch.bfloat16 if args.use_bfloat16 else torch.float32,
        device=args.device)
    metrics = []  # the reference's FACT.get_metrics is empty

    # A fresh single pass over the eval files per call (the reference
    # re-iterates its tf.data.Dataset each eval).
    def dataset():
        return data_pipeline.create_input(
            pipeline.eval_config, pipeline.eval_dataset, is_training=False,
            use_tpu=False)

    evaluator = Evaluator(model, dataset, metrics=metrics,
                          output_dir=args.output_dir, steps=args.steps,
                          steps_bucket=args.steps_bucket or None,
                          decode_batch=args.decode_batch or None,
                          cache_examples=not args.reload_dataset_per_pass,
                          devices=devices_for(model.device,
                                              args.data_parallelism))
    # The template of a params-only restore (no optimizer state): each
    # pass loads the checkpoint's parameters into the model.
    state = TrainState(step=0, params=model.state_dict(), opt_state=None)
    manager = CheckpointManager(args.model_dir, max_to_keep=5)
    controller = Controller(
        evaluator=_EvalAdapter(evaluator), state=state,
        checkpoint_manager=manager,
        summary_dir=os.path.join(args.model_dir, args.eval_prefix))
    try:
        results = controller.evaluate_continuously(
            timeout=args.timeout, poll_seconds=args.poll_seconds)
    finally:
        controller.close()
    # What this process launched of each hand-written kernel (0 on the
    # CPU, where the plain versions run).
    log.info("kernel launches: %s", json.dumps(
        {"attention": attention_op.launches,
         "attention_backward": attention_op.backward_launches,
         "fused_mlp": mlp_op.launches,
         "layer_norm": layer_norm_op.launches,
         "layer_norm_affine_free": layer_norm_op.affine_free_launches}))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
