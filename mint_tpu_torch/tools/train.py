"""Training CLI of the port (counterpart of ``mint_tpu/tools/train.py``).

    python -m mint_tpu_torch.tools.train \\
        --config_path=configs/fact_v5_deeper_t10_cm12.config \\
        --model_dir=/path/to/run [--use_bfloat16] [--device=cuda]

The flow is the JAX CLI's: snapshot the config into `model_dir`, build the
model (with ``compute_dtype=bf16`` under ``--use_bfloat16``: f32
parameters and Adam state), the schedule and the Trainer, initialise the
parameters from a generator seeded 0, open the input, the checkpoint
manager (keep 5) and the Controller (which restores the latest checkpoint
in `model_dir`), train one step, train to ``--steps`` (absolute: a resumed
run stops at the same budget), save and close.  Checkpoints go to
`model_dir`, metrics to ``model_dir/train/metrics.jsonl``.

As in the JAX CLI the Controller runs with ``fuse_loop``: each
``--steps_per_loop`` window's host batches (read two ahead by a
background thread) are stacked, copied to the device in one copy, and
trained by ``Trainer.train_steps``, whose steps replay a CUDA graph of the
train step on the card.  With ``--input_backend=device`` the windows are
drawn on the card instead.

It runs on one CUDA card unless ``--device=cpu`` is given (as the tests
do); without a card the default raises.  Not in the port yet: the mesh and
``--distributed`` / ``--shard_corpus``, the C++ input loader, and
``--loop_unroll`` (an XLA knob with no counterpart here).
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
from mint_tpu_torch.config.serialize import save_pipeline_config
from mint_tpu_torch.data import pipeline as data_pipeline
from mint_tpu_torch.data import tfrecord
from mint_tpu_torch.data.device_dataset import DeviceDataset
from mint_tpu_torch.data.prefetch import DevicePrefetcher
from mint_tpu_torch.models import builder
from mint_tpu_torch.models.fact import init_params
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import layer_norm as layer_norm_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.train import schedules
from mint_tpu_torch.train.checkpoint import CheckpointManager
from mint_tpu_torch.train.controller import Controller
from mint_tpu_torch.train.trainer import Trainer

log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", required=True,
                   help="Path to the config file.")
    p.add_argument("--model_dir", required=True,
                   help="Directory to write training checkpoints and logs.")
    p.add_argument("--steps", type=int, default=2400000,
                   help="Number of training steps (absolute).")
    p.add_argument("--initial_learning_rate", type=float, default=0.1,
                   help="Base rate of the exponential and cosine schedules.")
    p.add_argument("--warmup_steps", type=int, default=1000,
                   help="Number of learning rate warmup steps.")
    p.add_argument("--grad_clip_norm", type=float, default=0.0,
                   help="Clip gradients by global norm (0: off).")
    p.add_argument("--steps_per_loop", type=int, default=10,
                   help="Steps per controller loop.")
    p.add_argument("--checkpoint_interval", type=int, default=1000,
                   help="Steps between checkpoints.")
    p.add_argument("--summary_interval", type=int, default=10,
                   help="Steps between summaries.")
    p.add_argument("--use_bfloat16", action="store_true",
                   help="Run forward/backward compute in bfloat16 "
                        "(parameters and Adam state stay f32).")
    p.add_argument("--accumulate_steps", type=int, default=1,
                   help="Micro-batches to average per optimizer update.")
    p.add_argument("--input_backend", choices=("python", "device"),
                   default="python",
                   help="'python': the host pipeline, prefetched onto the "
                        "device two batches ahead; 'device': the whole "
                        "corpus resident on the device, windows drawn "
                        "there (i.i.d. windows instead of epochs).")
    p.add_argument("--device", default="cuda",
                   help="Device to train on: 'cuda' (one card, the "
                        "default) or 'cpu'.")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> None:
    pipeline = load_pipeline_config(args.config_path)
    train_config = pipeline.train_config
    # Snapshot the effective config into the model dir.
    save_pipeline_config(pipeline, args.model_dir)

    use_bf16 = args.use_bfloat16 or train_config.use_bfloat16
    model = builder.build(
        pipeline.multi_modal_model, is_training=True, device=args.device,
        compute_dtype=torch.bfloat16 if use_bf16 else None)
    schedule = schedules.from_config(
        train_config.learning_rate,
        initial_learning_rate=args.initial_learning_rate,
        warmup_steps=args.warmup_steps)
    trainer = Trainer(model, schedule, grad_clip_norm=args.grad_clip_norm,
                      accumulate_steps=args.accumulate_steps)
    params = init_params(model, torch.Generator().manual_seed(0))
    state = trainer.init_state(params)

    batches = None
    train_sampler = None
    if args.input_backend == "device":
        files = tfrecord.glob(pipeline.train_dataset.data_files)
        if not files:
            raise FileNotFoundError(
                f"no input files match "
                f"{pipeline.train_dataset.data_files!r}")
        train_sampler = DeviceDataset.from_files(
            files, pipeline.train_dataset,
            batch_size=train_config.batch_size, device=trainer.device)
        log.info("device-resident dataset: %d sequences, %.1f MB",
                 train_sampler.n_sequences, train_sampler.nbytes / 2**20)
    else:
        # The loader runs in a background thread, two batches ahead; the
        # batches stay on the host until the controller's copy of each
        # fused window.
        batches = DevicePrefetcher(
            data_pipeline.create_input(train_config, pipeline.train_dataset,
                                       is_training=True),
            lambda b: b)

    manager = CheckpointManager(
        args.model_dir, save_interval_steps=args.checkpoint_interval,
        max_to_keep=5)
    controller = Controller(
        trainer=trainer, train_iter=batches, state=state,
        steps_per_loop=args.steps_per_loop, checkpoint_manager=manager,
        summary_dir=os.path.join(args.model_dir, "train"),
        summary_interval=args.summary_interval,
        fuse_loop=True,
        train_sampler=train_sampler)
    try:
        # One step first to bring everything up, then the rest; train() is
        # absolute, so a resumed run stops at the same budget.
        controller.train(1)
        controller.train(args.steps)
        controller.save_checkpoint()
        # What this process launched of each hand-written kernel (0 on
        # the CPU, where the plain versions run).
        log.info("kernel launches: %s", json.dumps(
            {"attention": attention_op.launches,
             "fused_mlp": mlp_op.launches,
             "layer_norm": layer_norm_op.launches}))
    finally:
        controller.close()
        if batches is not None:
            batches.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    train(parse_args(argv))


if __name__ == "__main__":
    main()
