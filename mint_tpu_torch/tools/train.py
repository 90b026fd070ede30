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
train step on the card.  ``--input_backend`` picks the host batches' source
as the JAX CLI does: ``native``, the C++ loader
(``data/native_loader.py``, built with g++ at first use; raises if it
does not build), ``python``, the NumPy pipeline, or ``auto`` (the
default), the C++ loader where it builds and else, with a warning, the
Python pipeline; with ``device`` the windows are drawn on the card
instead.

It runs on one CUDA card unless ``--device=cpu`` is given (as the tests
do); without a card the default raises.

Over ranks (``--distributed``, the JAX CLI's flags): one process a rank,
started by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT`` in the environment) or by hand with
``--coordinator_address=host:port --num_processes=N --process_id=i``
(the local rank is then ``LOCAL_RANK`` where set, else the process id).
Each rank trains on ``cuda:<local rank>`` over NCCL, one rank a card (a
local rank beyond the host's cards raises), or on the CPU over gloo with
``--device=cpu``.  The ranks form a ``--data_parallelism`` x
``--tensor_parallelism`` mesh (``parallel/mesh.py``; data 0 takes every
rank the model axis leaves); each data rank reads ``batch_size / data``
examples of the config's global batch with a shuffle seeded by its data
index, the ranks of one model group the same ones.  Only rank 0 writes
the config snapshot, the metrics and the (whole, unsharded) checkpoints.
``--shard_corpus`` with ``--input_backend=device`` keeps each data
rank's share of the corpus on its device.  Not in the port:
``--loop_unroll`` (an XLA knob with no counterpart here).

    torchrun --nproc_per_node=8 -m mint_tpu_torch.tools.train \
        --config_path=... --model_dir=... --distributed \
        --tensor_parallelism=2
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.config.serialize import save_pipeline_config
from mint_tpu_torch.data import native_loader
from mint_tpu_torch.data import pipeline as data_pipeline
from mint_tpu_torch.data import tfrecord
from mint_tpu_torch.data.device_dataset import DeviceDataset
from mint_tpu_torch.data.prefetch import DevicePrefetcher
from mint_tpu_torch.models import builder
from mint_tpu_torch.models.fact import init_params
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import layer_norm as layer_norm_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.parallel import mesh as mesh_lib
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
    p.add_argument("--input_backend",
                   choices=("auto", "native", "python", "device"),
                   default="auto",
                   help="'native': the C++ reader thread "
                        "(csrc/mint_loader.cc); 'python': the NumPy "
                        "pipeline; 'auto': native where its library "
                        "builds, else python (both host loaders, "
                        "prefetched two batches ahead); 'device': the "
                        "whole corpus resident on the device, windows "
                        "drawn there (i.i.d. windows instead of "
                        "epochs).")
    p.add_argument("--device", default="cuda",
                   help="Device to train on: 'cuda' (one card, the "
                        "default; a rank's own card with --distributed) or "
                        "'cpu'.")
    p.add_argument("--data_parallelism", type=int, default=0,
                   help="Data-parallel mesh axis (0 = all ranks / tp).")
    p.add_argument("--tensor_parallelism", type=int, default=1,
                   help="Tensor-parallel mesh axis.")
    p.add_argument("--shard_corpus", action="store_true",
                   help="With --input_backend=device: each data rank keeps "
                        "its share of the corpus (sequences dealt "
                        "round-robin) and draws from it.")
    p.add_argument("--distributed", action="store_true",
                   help="Run as one rank of torch.distributed (from "
                        "torchrun's environment, else the flags below).")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0 for --distributed without "
                        "torchrun's environment.")
    p.add_argument("--num_processes", type=int, default=None,
                   help="Rank count for --distributed without torchrun.")
    p.add_argument("--process_id", type=int, default=None,
                   help="This process's rank for --distributed without "
                        "torchrun.")
    return p.parse_args(argv)


def init_distributed(args: argparse.Namespace) -> torch.device:
    """Join the process group of a --distributed run and return this
    rank's device: ``cuda:<local rank>`` over NCCL, or the CPU over gloo
    with ``--device=cpu``.  A rank that finds no card raises."""
    cpu = torch.device(args.device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("--distributed on 'cuda' (the default) but no "
                           "CUDA card is available; pass --device=cpu to "
                           "run the ranks on the CPU over gloo")
    backend = "gloo" if cpu else "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        kwargs = {"init_method": "env://"}
    else:
        if None in (args.coordinator_address, args.num_processes,
                    args.process_id):
            raise ValueError("--distributed without torchrun's environment "
                             "needs --coordinator_address, --num_processes "
                             "and --process_id")
        rank = args.process_id
        local = int(os.environ.get("LOCAL_RANK", rank))
        kwargs = {"init_method": f"tcp://{args.coordinator_address}",
                  "world_size": args.num_processes, "rank": rank}
    if cpu:
        device = torch.device("cpu")
    else:
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} needs card cuda:{local}, but this host "
                f"has {torch.cuda.device_count()} CUDA card(s); start at "
                f"most one rank a card (set LOCAL_RANK where ranks span "
                f"hosts)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, **kwargs)
    return device


def _mesh(args: argparse.Namespace) -> Optional[mesh_lib.Mesh]:
    """The run's mesh (None without --distributed)."""
    if not args.distributed:
        if args.data_parallelism > 1 or args.tensor_parallelism > 1:
            raise ValueError("--data_parallelism / --tensor_parallelism "
                             "over 1 need --distributed")
        return None
    device = init_distributed(args)
    mesh = mesh_lib.make_mesh(data=args.data_parallelism or None,
                              model=args.tensor_parallelism, device=device)
    log.info("mesh: %s over %d rank(s)", mesh.shape, dist.get_world_size())
    return mesh


def _initial_params(pipeline, model, mesh, compute_dtype):
    """The parameters, initialised from a generator seeded 0: a model
    split over a model axis takes its slice of the whole model's."""
    generator = torch.Generator().manual_seed(0)
    if mesh is None or mesh.model == 1:
        return dict(init_params(model, generator).named_parameters())
    whole = builder.build(pipeline.multi_modal_model, is_training=True,
                          device="cpu", compute_dtype=compute_dtype)
    full = dict(init_params(whole, generator).named_parameters())
    return mesh_lib.shard_state_dict(
        {k: v.detach() for k, v in full.items()}, mesh,
        mesh_lib.attention_heads(model))


def host_input(backend: str, train_config, dataset_config,
               seed: Optional[int], batch_size: int):
    """The host batches of `backend` ('auto', 'native' or 'python'):
    `batch_size` examples each, shuffled by `seed` (None: the Python
    pipeline's default, the loader's 0), as the JAX CLI's
    ``_make_input`` opens them."""
    if backend in ("auto", "native"):
        if native_loader.available():
            params = data_pipeline.get_modality_to_param_dict(
                dataset_config)
            files = tfrecord.glob(dataset_config.data_files)
            if not files:
                raise FileNotFoundError(
                    f"no input files match {dataset_config.data_files!r}")
            log.info("input: the native loader (%d shards, batch %d, "
                     "seed %d)", len(files), batch_size, seed or 0)
            return native_loader.NativeTrainLoader(
                files, batch_size=batch_size,
                motion_input_len=params["motion"]["input_length"],
                target_len=params["motion"]["target_length"],
                target_shift=params["motion"]["target_shift"],
                audio_input_len=params["audio"]["input_length"],
                motion_dim_raw=params["motion"]["feature_dim"],
                audio_dim=params["audio"]["feature_dim"],
                seed=seed or 0)
        if backend == "native":
            raise RuntimeError(f"native loader unavailable: "
                               f"{native_loader.build_error()}")
        log.warning("native loader unavailable (%s); Python pipeline",
                    native_loader.build_error())
    log.info("input: the Python pipeline (batch %d, seed %s)", batch_size,
             seed)
    return data_pipeline.create_input(
        train_config, dataset_config, is_training=True, seed=seed,
        batch_size_override=batch_size)


def train(args: argparse.Namespace) -> None:
    mesh = _mesh(args)
    if mesh is None:
        _train(args, mesh)
        return
    try:
        _train(args, mesh)
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()


def _train(args: argparse.Namespace, mesh) -> None:
    chief = mesh is None or mesh.is_chief
    device = args.device if mesh is None else mesh.device
    pipeline = load_pipeline_config(args.config_path)
    train_config = pipeline.train_config
    # Snapshot the effective config into the model dir (rank 0 only: the
    # ranks share it).
    if chief:
        save_pipeline_config(pipeline, args.model_dir)

    use_bf16 = args.use_bfloat16 or train_config.use_bfloat16
    compute_dtype = torch.bfloat16 if use_bf16 else None
    model = builder.build(
        pipeline.multi_modal_model, is_training=True, device=device,
        compute_dtype=compute_dtype, mesh=mesh)
    schedule = schedules.from_config(
        train_config.learning_rate,
        initial_learning_rate=args.initial_learning_rate,
        warmup_steps=args.warmup_steps)
    trainer = Trainer(model, schedule, grad_clip_norm=args.grad_clip_norm,
                      accumulate_steps=args.accumulate_steps, mesh=mesh)
    state = trainer.init_state(_initial_params(pipeline, model, mesh,
                                               compute_dtype))
    data = mesh.data if mesh is not None else 1
    if train_config.batch_size % data:
        raise ValueError(f"global batch_size {train_config.batch_size} is "
                         f"not divisible by the data axis size {data}")

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
            batch_size=train_config.batch_size, device=trainer.device,
            mesh=mesh, shard_over_data=args.shard_corpus)
        log.info("device-resident dataset: %d sequences, %.1f MB",
                 train_sampler.n_sequences, train_sampler.nbytes / 2**20)
    else:
        # The loader runs in a background thread, two batches ahead; the
        # batches stay on the host until the controller's copy of each
        # fused window.  Over a mesh each data rank reads its share of the
        # global batch, shuffled by a seed of its data index: the ranks of
        # one model group read the same batch.
        seed = (mesh_lib.SEED_STRIDE * mesh.data_index
                if mesh is not None else None)
        batches = DevicePrefetcher(
            host_input(args.input_backend, train_config,
                       pipeline.train_dataset, seed,
                       train_config.batch_size // data),
            lambda b: b)

    manager = CheckpointManager(
        args.model_dir, save_interval_steps=args.checkpoint_interval,
        max_to_keep=5, mesh=mesh,
        heads=mesh_lib.attention_heads(model))
    controller = Controller(
        trainer=trainer, train_iter=batches, state=state,
        steps_per_loop=args.steps_per_loop, checkpoint_manager=manager,
        summary_dir=(os.path.join(args.model_dir, "train") if chief
                     else None),
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
             "layer_norm": layer_norm_op.launches,
             "layer_norm_affine_free": layer_norm_op.affine_free_launches}))
        # The last step's phases, from the stamps in its body (null on
        # the CPU, where nothing is stamped).
        log.info("step phases (ms): %s", json.dumps(trainer.phase_ms()))
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
