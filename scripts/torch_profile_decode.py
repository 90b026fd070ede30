"""Where a decode step's time goes on the card, for the PyTorch port.

Runs the flagship FACT (seeded random weights) through
``mint_tpu_torch.infer.decoder.infer_auto_regressive`` at batch 4 (the
server's small batch) and 20 (the bench dispatch) for a few steps under
``torch.profiler``, each step a replay of the decode's CUDA graph (captured
by two decodes of the same key first), and the same steps through the
step body uncaptured, then once more untraced.  Prints, per dtype, batch
and mode: wall ms/step traced and untraced,
device busy ms/step (sum of kernel times), the device's idle share, the
kernels by total device time, the layout copies among them, and the
device time of each layer (the fused MLP, attention, the projections'
library GEMMs, LayerNorm, the rest).  ``--config NAME`` runs one of
``chip_smoke.py``'s 11b configs (``LIMIT_CONFIGS``, e.g. hidden_804) in
place of the flagship;
``--dtype`` and ``--graphed-only`` narrow the runs; ``--tree DIR`` runs
another checkout's package (e.g. the parent commit's, unpacked by ``git
archive``).

    python scripts/torch_profile_decode.py [--steps 8] [--batch 4 20]
        [--config NAME] [--dtype bf16|f32] [--graphed-only] [--tree DIR]

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


# Layers by kernel name, the first that matches: the port's MLP kernels
# (csrc/mlp.cu and mlp_routes.cu), its attention and LayerNorm kernels,
# then the library's GEMMs (the projections).
LAYERS = (("mlp", ("::gemm_tc_", "::reduce_tc_kernel", "::gemm_nt_kernel",
                   "namespace)::reduce_kernel")),
          ("attention", ("attention",)),
          ("layer_norm", ("layer_norm",)),
          ("projections", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def layer_of(name: str) -> str:
    return next((layer for layer, keys in LAYERS
                 if any(k in name for k in keys)), "other")


def model_config(name):
    from mint_tpu_torch.config.schema import load_pipeline_config

    if name is None:
        return load_pipeline_config(CONFIG).multi_modal_model
    import chip_smoke

    return chip_smoke.limit_config(**chip_smoke.LIMIT_CONFIGS[name])


def run(dtype, batch, steps, graphed, config=None):
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params

    cfg = model_config(config)
    model = init_params(builder.build(cfg, False, dtype=dtype,
                                      device="cuda"),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    inputs = {
        "motion_input": torch.from_numpy(rng.standard_normal(
            (batch, 120, 225)).astype(np.float32)).cuda(),
        "audio_input": torch.from_numpy(rng.standard_normal(
            (batch, steps + model.audio_seq_length - 1, 35)
        ).astype(np.float32)).cuda(),
    }
    def decode():
        return decoder._decode(model, inputs, steps, None,
                               decoder.DECODE_LAST_BLOCK_ROWS, graphed)

    for _ in range(2):  # build, warm up and (graphed) capture the key
        decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()  # and untraced
    decode()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3  # us -> ms
    name = (f"{config or 'flagship'} {str(dtype)[6:]} "
            f"{'graphed' if graphed else 'uncaptured'}")
    print(f"{name} batch {batch}, {steps} steps (profiled): wall "
          f"{1e3 * wall / steps:.3f} ms/step, device busy "
          f"{busy / steps:.3f} ms/step, idle share "
          f"{1 - busy / (1e3 * wall):.3f}; untraced wall "
          f"{1e3 * untraced / steps:.3f} ms/step")
    for dev, count, key in rows[:12]:
        print(f"  {dev / 1e3 / steps:9.3f} ms/step  {count // steps:5d}/step"
              f"  {key[:90]}")
    # Layout copies (.contiguous() and the like) among all kernels.
    copies = [r for r in rows if "copy" in r[2].lower()]
    print(f"  copy kernels: {sum(r[1] for r in copies) // steps}/step, "
          f"{sum(r[0] for r in copies) / 1e3 / steps:.3f} ms/step"
          + "".join(f"; {r[1] // steps}/step {r[2][:60]}" for r in copies))
    layers = {}
    for dev, count, key in rows:
        ms, n = layers.get(layer_of(key), (0.0, 0))
        layers[layer_of(key)] = (ms + dev / 1e3 / steps, n + count // steps)
    print("  layers: " + ", ".join(
        f"{layer} {ms:.3f} ms/step ({n} kernels)"
        for layer, (ms, n) in sorted(layers.items(), key=lambda x: -x[1][0])))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, nargs="+", default=[4, 20])
    p.add_argument("--config", default=None,
                   help="a chip_smoke.LIMIT_CONFIGS name (default: the "
                   "flagship)")
    p.add_argument("--dtype", choices=("bf16", "f32"), nargs="+",
                   default=["bf16", "f32"])
    p.add_argument("--graphed-only", action="store_true")
    p.add_argument("--tree", default=REPO,
                   help="the checkout whose mint_tpu_torch runs")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {os.path.abspath(args.tree)}")
    for name in args.dtype:
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for batch in args.batch:
            for graphed in (True,) if args.graphed_only else (True, False):
                run(dtype, batch, args.steps, graphed, args.config)


if __name__ == "__main__":
    main()
