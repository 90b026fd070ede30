"""Host cost of the decode path's calls, for the PyTorch port.

Under ``torch.inference_mode`` (the decoder's mode), at the batch-20
decode's shapes, with the flagship's weights (seeded random), it measures
the host's time for:

- each kernel wrapper call, per kernel, dtype and shape (inputs checked,
  launch enqueued: ``chip_smoke.py``'s ``host_us``), the bf16 LayerNorm
  kernel's where the tree has it;
- one call of a block's ``MLP`` module (the casts around the wrapper) and
  of its first ``LayerNorm``;
- one whole flagship forward (what a decode step enqueues);
- batch-20 decode frames/s (3 decodes of 32 steps), the end-to-end effect.

Each is timed in rounds (a synchronise before each round, none inside):
the median and the least round, per call.  Beside each, the Python and C
function calls the host makes in one call (``sys.setprofile``), a count
of the host's work that other tenants of the host cannot disturb.  It
prints one JSON line.

    python scripts/torch_host_overhead.py [--tree DIR]

``--tree`` names a checkout whose ``mint_tpu_torch`` is measured (default:
this one), so two commits are compared on one card in one command: unpack
the other commit into a directory the checkout's ``.gitignore`` lists and
run the two alternately (parent, change, change, parent).  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
BATCH = 20
ROUNDS = 30  # of 100 calls a shape (a forward: 4 x ROUNDS of one call)
SCALE = 800 ** -0.5


def function_calls(fn):
    """Python and C function calls made in one fn() call."""
    n = 0

    def hook(frame, event, arg):
        nonlocal n
        n += event in ("call", "c_call")

    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return n


def per_call_us(fn, calls, rounds):
    """Median and least host us per fn() call, under inference mode, over
    `rounds` rounds of `calls` calls after a warm-up, and the function
    calls one fn() call makes."""
    readings = []
    with torch.inference_mode():
        for _ in range(3):
            fn()
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            readings.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
        n_calls = function_calls(fn)
        torch.cuda.synchronize()
    return {"median_us": statistics.median(readings),
            "min_us": min(readings), "function_calls": n_calls}


def decode_rates(model, rng, steps=32, runs=3):
    """Frames/s of `runs` batch-BATCH decodes of `steps` steps (a host
    clock around each, ending in a synchronise), after a 2-step warm-up:
    what the host's cost does to decode end to end."""
    from mint_tpu_torch.infer import decoder

    inputs = {"motion_input": rng.standard_normal(
                  (BATCH, 120, 225)).astype(np.float32),
              "audio_input": rng.standard_normal(
                  (BATCH, steps + 239, 35)).astype(np.float32)}
    decoder.infer_auto_regressive(model, inputs, steps=2)
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoder.infer_auto_regressive(model, inputs, steps=steps)
        torch.cuda.synchronize()
        rates.append(BATCH * steps / (time.perf_counter() - t0))
    return {"frames_per_s": rates, "max_frames_per_s": max(rates)}


def mlp_weights(gen, dtype, h=800, f=3072, o=800):
    """W1 [H, F], b1, W2 [F, O], b2 as the model passes them: transposed
    views of nn.Linear's [out, in] weights."""
    def glorot(fan_in, fan_out):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return ((torch.rand(fan_out, fan_in, device="cuda", generator=gen)
                 * 2 - 1) * bound).to(dtype).t()
    return (glorot(h, f), torch.zeros(f, device="cuda", dtype=dtype),
            glorot(f, o), torch.zeros(o, device="cuda", dtype=dtype))


def measure(dtype):
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.ops import attention as att
    from mint_tpu_torch.ops import mlp

    name = str(dtype)[6:]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for nq, nk in ((360, 360), (48, 360), (240, 240), (120, 120)):
        q = torch.randn(BATCH, 10, nq, 80, device="cuda", generator=gen
                        ).to(dtype)
        k = torch.randn(BATCH, 10, nk, 80, device="cuda", generator=gen
                        ).to(dtype)
        v = torch.randn_like(k)
        out[f"attention_{name}_q{nq}_k{nk}"] = per_call_us(
            lambda: att.attention(q, k, v, SCALE), 100, ROUNDS)
    w1, b1, w2, b2 = mlp_weights(gen, dtype)
    for rows in (360, 48, 240, 120):
        x = torch.randn(BATCH * rows, 800, device="cuda", generator=gen
                        ).to(dtype)
        out[f"fused_mlp_{name}_x{BATCH * rows}"] = per_call_us(
            lambda: mlp.fused_mlp(x, w1, b1, w2, b2), 100, ROUNDS)
    try:
        from mint_tpu_torch.ops import layer_norm as ln
    except ImportError:  # a tree from before the bf16 LayerNorm kernel
        ln = None
    if ln is not None and dtype == torch.bfloat16:
        w = 1 + 0.05 * torch.randn(800, device="cuda", generator=gen)
        b = 0.5 * torch.randn(800, device="cuda", generator=gen)
        for rows in (360, 48, 240, 120):
            x = torch.randn(BATCH * rows, 800, device="cuda", generator=gen
                            ).to(dtype)
            out[f"layer_norm_{name}_x{BATCH * rows}"] = per_call_us(
                lambda: ln.layer_norm(x, w, b, 1e-5), 100, ROUNDS)

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = init_params(builder.build(cfg, False, dtype=dtype,
                                      device="cuda"),
                        torch.Generator().manual_seed(0))
    block = model.cross_modal_layer.transformer.block_0
    x = torch.randn(BATCH, 360, 800, device="cuda", generator=gen).to(dtype)
    out[f"mlp_module_{name}_x{BATCH * 360}"] = per_call_us(
        lambda: block.mlp(x), 100, ROUNDS)
    out[f"norm_module_{name}_x{BATCH * 360}"] = per_call_us(
        lambda: block.norm_attn(x), 100, ROUNDS)
    rng = np.random.default_rng(0)
    inputs = {
        "motion_input": torch.from_numpy(rng.standard_normal(
            (BATCH, 120, 225)).astype(np.float32)).cuda(),
        "audio_input": torch.from_numpy(rng.standard_normal(
            (BATCH, 240, 35)).astype(np.float32)).cuda(),
    }
    out[f"forward_{name}_batch{BATCH}"] = per_call_us(
        lambda: model(inputs), 1, ROUNDS * 4)
    out[f"decode_{name}_batch{BATCH}"] = decode_rates(model, rng)
    del model
    torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=REPO,
                   help="Checkout whose mint_tpu_torch is measured.")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    from mint_tpu_torch.ops import _build
    _build.library()
    readings = {}
    for dtype in (torch.bfloat16, torch.float32):
        readings.update(measure(dtype))
    print(json.dumps({"tree": os.path.relpath(tree, REPO), "card": card,
                      "torch": torch.__version__, "host": readings}))


if __name__ == "__main__":
    main()
