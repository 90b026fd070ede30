"""One gloo rank of the port's multi-rank CPU tests.

    python tests/torch_parallel_worker.py <task> <rank> <world> <port> <dir>

Imports torch and the port only (no JAX): ``tests/test_torch_parallel.py``
computes the JAX oracle in its own process and starts one of these a
rank.  `dir` holds the inputs the parent wrote (``full.pt``: the whole
model's state_dict; ``inputs.npz``) and takes the outputs.

Tasks (the tiny FACT of ``mint_tpu_torch.parallel.dryrun``, at the
widths of ``config.json`` where the parent wrote one):

- ``forward``: a (data 1, model `world`) mesh; each rank loads its slice
  of ``full.pt`` and runs the f32 forward on ``inputs.npz``; rank 0 saves
  ``out.npy``.
- ``train``: a (data 2, model world / 2) mesh; one train step with
  clipping on rank's rows of the global batch in ``inputs.npz``; rank 0
  saves ``metrics.json``; then every rank saves the state through
  ``CheckpointManager(dir/ckpt, mesh=...)`` (whole, unsharded files).
- ``grads``: a (data 1, model `world`) mesh; the f32 loss and gradients
  of ``inputs.npz`` (with its ``target``); rank 0 saves the loss and the
  gathered (whole) gradients in ``grads.pt``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mint_tpu_torch.config import schema as S  # noqa: E402
from mint_tpu_torch.models import builder  # noqa: E402
from mint_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mint_tpu_torch.parallel.dryrun import tiny_fact_config  # noqa: E402
from mint_tpu_torch.train import (CheckpointManager, Trainer,  # noqa: E402
                                  schedules)

CLIP = 0.05
TRAIN_DATA = 2


def schedule():
    # Warmup over the first 3 updates, as tests/test_torch_train.py's.
    return schedules.manual_stepping([3], [1e-4, 1e-3], warmup=True)


def sharded_model(mesh, work):
    widths = {}
    if os.path.exists(os.path.join(work, "config.json")):
        with open(os.path.join(work, "config.json")) as f:
            widths = json.load(f)
    config = S.MultiModalModelConfig(fact_model=tiny_fact_config(**widths))
    model = builder.build(config, is_training=True, device="cpu", mesh=mesh)
    full = torch.load(os.path.join(work, "full.pt"), weights_only=True)
    model.load_state_dict(mesh_lib.shard_state_dict(
        full, mesh, mesh_lib.attention_heads(model)))
    return model


def main():
    task, rank, world, port, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(os.path.join(work, "inputs.npz")))
        if task == "forward":
            mesh = mesh_lib.make_mesh(data=1, model=world)
            model = sharded_model(mesh, work).eval()
            with torch.no_grad():
                out = model({k: torch.from_numpy(v)
                             for k, v in inputs.items()})
            if rank == 0:
                np.save(os.path.join(work, "out.npy"), out.numpy())
        elif task == "train":
            mesh = mesh_lib.make_mesh(data=TRAIN_DATA,
                                      model=world // TRAIN_DATA)
            model = sharded_model(mesh, work)
            trainer = Trainer(model, schedule(), grad_clip_norm=CLIP,
                              mesh=mesh)
            state = trainer.init_state(model)
            rows = len(inputs["target"]) // mesh.data
            mine = {k: v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
                    for k, v in inputs.items()}
            state, metrics = trainer.train_step(state, mine)
            if rank == 0:
                with open(os.path.join(work, "metrics.json"), "w") as f:
                    json.dump({k: float(v) for k, v in metrics.items()}, f)
            manager = CheckpointManager(os.path.join(work, "ckpt"),
                                        mesh=mesh)
            manager.save(state.step, state, force=True)
            manager.close()
        elif task == "grads":
            mesh = mesh_lib.make_mesh(data=1, model=world)
            model = sharded_model(mesh, work)
            loss, grads = Trainer(model, schedule(), mesh=mesh
                                  ).loss_and_grads(
                dict(model.named_parameters()), inputs)
            gathered = mesh_lib.gather_state_dicts([grads], mesh)
            if rank == 0:
                torch.save({"loss": float(loss), "grads": gathered[0]},
                           os.path.join(work, "grads.pt"))
        else:
            raise ValueError(f"unknown task {task!r}")
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()


if __name__ == "__main__":
    main()
