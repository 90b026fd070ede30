"""Where a train step's time goes on the card, for the PyTorch port.

Runs ``Trainer`` steps of the flagship FACT (seeded random weights, a
random batch resident on the card) at the config's batch of 32, in bf16
compute (f32 parameters) and in f32, and prints per dtype:

- steps/s over a few untraced steps;
- per step, from CUDA events around each phase: the forward (the two
  hand-written kernels and the model's other ops), the backward (the
  plain VJPs of both kernels and autograd's through the rest) and the
  optimizer (clip and Adam, ``torch._foreach`` ops);
- under ``torch.profiler``: wall and device-busy ms/step, the idle share,
  the hand-written kernels' time, and the kernels by total device time;
- the peak device memory.

    python scripts/torch_profile_train.py [--steps 3] [--batch 32]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
# Kernel names of csrc/attention.cu and csrc/mlp.cu.
OWN_KERNELS = ("attention_kernel", "attention_tc_kernel", "gemm_nt_kernel",
               "gemm_tc_kernel", "reduce_kernel", "reduce_tc_kernel")


def _kernel_rows(prof):
    """(device us, launches, name) of each kernel; operator rows, which
    repeat their kernels' time, are left out."""
    rows = [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def _own(key: str) -> bool:
    # The port's kernels live in an anonymous namespace (PyTorch's own
    # reductions are also called reduce_kernel).
    return any(re.search(rf"\(anonymous namespace\)::{k}[<(]", key)
               for k in OWN_KERNELS)


def run(name, batch, steps):
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.train import Trainer, schedules

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = init_params(builder.build(
        cfg, True, device="cuda",
        compute_dtype=torch.bfloat16 if name == "bf16" else None),
        torch.Generator().manual_seed(0))
    trainer = Trainer(model, schedules.constant(1e-4))
    state = trainer.init_state(model)
    rng = np.random.default_rng(0)
    shapes = {"motion_input": (batch, 120, 225), "audio_input": (batch, 240, 35),
              "target": (batch, 20, 225)}
    data = {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32)
                                ).cuda() for k, v in shapes.items()}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm-up
        state, _ = trainer.train_step(state, data)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, data)
    float(metrics["loss"])
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)

    # Phases by CUDA events: the step of Trainer.train_step, cut at the end
    # of the forward and of the backward.
    phases = np.zeros(3)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        leaves = {k: p.detach().requires_grad_()
                  for k, p in state.params.items()}
        ev[0].record()
        with torch.enable_grad():
            loss = trainer.loss(leaves, data)
            ev[1].record()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        trainer.apply_gradients(state, dict(zip(leaves, grads)))
        ev[3].record()
        torch.cuda.synchronize()
        phases += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    phases /= steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = trainer.train_step(state, data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3 / steps
    own = sum(r[0] for r in rows if _own(r[2])) / 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name} batch {batch}: {rate:.3f} steps/s ({1e3 / rate:.2f} "
          f"ms/step untraced); events per step: forward {phases[0]:.2f} ms, "
          f"backward {phases[1]:.2f} ms, optimizer {phases[2]:.2f} ms; "
          f"profiled: wall {wall:.2f} ms/step, busy {busy:.2f} ms/step, "
          f"idle share {1 - busy / wall:.3f}, hand-written kernels "
          f"{own:.2f} ms/step; peak memory {peak:.2f} GiB")
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3 / steps:9.3f} ms/step  {count // steps:5d}/step"
              f"  {key[:90]}")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=32)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for name in ("bf16", "f32"):
        run(name, args.batch, args.steps)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
