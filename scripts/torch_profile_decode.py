"""Where a decode step's time goes on the card, for the PyTorch port.

Runs the flagship FACT (seeded random weights) through
``mint_tpu_torch.infer.decoder.infer_auto_regressive`` at batch 20 (the
bench dispatch) for a few steps under ``torch.profiler`` and prints, per
dtype: wall ms/step, device busy ms/step (sum of kernel times), the
device's idle share, the kernels by total device time, and the layout
copies among them.

    python scripts/torch_profile_decode.py [--steps 4] [--batch 20]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")


def _kernel_rows(prof):
    """(device us, launches, name) of each kernel; operator rows, which
    repeat their kernels' time, are left out."""
    rows = [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def run(dtype, batch, steps):
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = init_params(builder.build(cfg, False, dtype=dtype,
                                      device="cuda"),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    inputs = {
        "motion_input": torch.from_numpy(rng.standard_normal(
            (batch, 120, 225)).astype(np.float32)).cuda(),
        "audio_input": torch.from_numpy(rng.standard_normal(
            (batch, steps + 239, 35)).astype(np.float32)).cuda(),
    }
    decoder.infer_auto_regressive(model, inputs, steps=2)  # build + warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decoder.infer_auto_regressive(model, inputs, steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3  # us -> ms
    name = str(dtype)[6:]
    print(f"{name} batch {batch}, {steps} steps (profiled): wall "
          f"{1e3 * wall / steps:.3f} ms/step, device busy "
          f"{busy / steps:.3f} ms/step, idle share "
          f"{1 - busy / (1e3 * wall):.3f}")
    for dev, count, key in rows[:12]:
        print(f"  {dev / 1e3 / steps:9.3f} ms/step  {count // steps:5d}/step"
              f"  {key[:90]}")
    # Layout copies (.contiguous() and the like) among all kernels.
    copies = [r for r in rows if "copy" in r[2].lower()]
    print(f"  copy kernels: {sum(r[1] for r in copies) // steps}/step, "
          f"{sum(r[0] for r in copies) / 1e3 / steps:.3f} ms/step"
          + "".join(f"; {r[1] // steps}/step {r[2][:60]}" for r in copies))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for dtype in (torch.bfloat16, torch.float32):
        run(dtype, args.batch, args.steps)


if __name__ == "__main__":
    main()
