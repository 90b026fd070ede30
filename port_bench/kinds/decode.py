"""Offline autoregressive decode: dispatches of `batch` clips of `steps`
frames each through ``mint_tpu_torch.infer.decoder.infer_auto_regressive``,
the frames fetched to the host at the end of each dispatch, as the
evaluator does.

Cell parameters: ``batch``, ``steps`` and ``check`` (``clips`` and
``frames`` a clip that the reference recomputes, and the limit
``frame_gap``).  A traced run profiles one dispatch.

Each dispatch's inputs (a motion seed of ``motion_seq_length`` frames and
an audio track of ``steps + audio_seq_length - 1`` frames a clip, standard
normal) are drawn on the device from the run's seed and the dispatch's
index.  Set-up decodes dispatch 0, which captures the decode's graph;
the window opens when dispatch 1 is issued and closes when the first
dispatch that ends after ``--seconds`` has its frames on the host.
"""

from __future__ import annotations

import gc
import time

import torch

from lib import common, work
from lib.trace import Trace, profiled
from reference import fact as ref
from reference import precision

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def inputs(g: dict, cell: dict, seed: int, index: int, device):
    gen = common.generator(device, seed, common.STREAM_INPUTS, index)
    b, steps = cell["batch"], cell["steps"]
    motion = torch.randn(b, g["motion_seq_length"], g["motion_dim"],
                         generator=gen, device=device)
    audio = torch.randn(b, steps + g["audio_seq_length"] - 1,
                        g["audio_dim"], generator=gen, device=device)
    return {"motion_input": motion, "audio_input": audio}


def build(g: dict, seed: int, device):
    """The program's model in the configuration's precision, holding the
    run's weights."""
    from mint_tpu_torch.models import builder

    dtype = DTYPES[g["precision"]]
    model = builder.build(common.port_model_config(g), is_training=False,
                          dtype=dtype, device=device)
    params = common.make_params(g, seed, device, served=dtype)
    model.load_state_dict(params, strict=True)
    return model


def picks(cell: dict, seed: int, dispatches: int):
    """The (dispatch, clip) pairs and the steps of each that the check
    recomputes, drawn from the seed: every clip the same number of
    frames, its first and last among them."""
    gen = common.generator("cpu", seed, common.STREAM_CHECK)
    b, steps, chk = cell["batch"], cell["steps"], cell["check"]
    total = dispatches * b
    clips = torch.randperm(total, generator=gen)[:chk["clips"]].tolist()
    out = []
    for flat in sorted(clips):
        inner = torch.randperm(steps - 2, generator=gen)[:chk["frames"] - 2]
        chosen = sorted([0, steps - 1] + (inner + 1).tolist())
        out.append(((flat // b, flat % b), chosen))
    return out


def reference_frames(g, cell, seed, device, chosen, frames_of, rnd_name):
    """The reference's frame at each chosen (clip, step), fed the
    protocol's windows of the frames under test (`frames_of(dispatch,
    clip)`, [steps, dim]), with `rnd_name`'s rounding of every matmul.
    Returns (reference frames, frames under test), each [n, dim]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = common.make_params(g, seed, device,
                                served=DTYPES[g["precision"]])
    rnd = precision.ROUNDING[rnd_name]
    refs, tested = [], []
    cache = {}
    for (d, c), steps in chosen:
        if d not in cache:
            cache.clear()
            cache[d] = inputs(g, cell, seed, d + 1, device)
        x = cache[d]
        frames = frames_of(d, c).to(device).float()
        pk = [(0, t) for t in steps]
        refs.append(ref.next_frames(params, g, x["motion_input"][c:c + 1],
                                    x["audio_input"][c:c + 1],
                                    frames[None], pk, rnd))
        tested.append(frames[steps])
    return torch.cat(refs), torch.cat(tested)


def frame_gap(reference: torch.Tensor, tested: torch.Tensor) -> float:
    """The widest relative L2 gap of a frame under test from the
    reference's."""
    gaps = (torch.linalg.vector_norm(tested - reference, dim=-1)
            / torch.linalg.vector_norm(reference, dim=-1))
    return float(gaps.max())


def run(ctx) -> dict:
    from mint_tpu_torch.infer import decoder

    g, cell, device = ctx.config, ctx.cell, ctx.device
    model = build(g, ctx.seed, device)
    steps = cell["steps"]

    def dispatch(index: int) -> torch.Tensor:
        x = inputs(g, cell, ctx.seed, index, device)
        frames = decoder.infer_auto_regressive(model, x, steps=steps)
        return frames.cpu()

    dispatch(0)  # builds the kernels, captures the graph
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start
    outputs, trace = [], None
    t0 = time.perf_counter()
    if ctx.trace:
        for attempt in range(3):  # an empty device trace is taken again
            with profiled() as prof:
                t0 = time.perf_counter()
                outputs = [dispatch(1)]
            units = steps * len(outputs)
            calls = work.decode_step_calls(g, cell["batch"])
            trace = Trace.from_profile(
                prof[0], units=units,
                bounds=work.bound_seconds(calls, g["precision"]),
                flops=work.decode_step_flops(g) * cell["batch"],
                peak=work.PEAK_FLOPS[g["precision"]],
                families=ctx.families)
            if trace.kernels():
                break
            ctx.log(f"trace attempt {attempt + 1}: no device event")
    else:
        while True:
            outputs.append(dispatch(1 + len(outputs)))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window = time.perf_counter() - t0
    frames_done = len(outputs) * cell["batch"] * steps
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(int(not torch.isfinite(o[c]).all())
                 for o in outputs for c in range(o.shape[0]))
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    chosen = picks(cell, ctx.seed, len(outputs))
    reference, tested = reference_frames(
        g, cell, ctx.seed, device, chosen,
        lambda d, c: outputs[d][c], "f32")
    gap = frame_gap(reference, tested)
    return {"e2e": {"decode_frames_per_s": frames_done / window,
                    "setup_s": setup_s},
            "trace": trace, "attempted": len(outputs) * cell["batch"],
            "failed": failed, "memory_peak_bytes": peak,
            "checks": {"frame_gap": (gap, cell["check"]["frame_gap"])}}


def calibrate(ctx) -> dict:
    """One seed's readings for the limit of ``frame_gap``: the program's,
    from one dispatch at the cell's load after the warm-up, and the
    control's (the reference with every matmul in the precision below
    the configuration's) at the same clips and steps."""
    from mint_tpu_torch.infer import decoder

    g, cell, device = ctx.config, ctx.cell, ctx.device
    model = build(g, ctx.seed, device)
    outputs = []
    for index in range(2):
        x = inputs(g, cell, ctx.seed, index, device)
        outputs.append(decoder.infer_auto_regressive(
            model, x, steps=cell["steps"]).cpu())
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chosen = picks(cell, ctx.seed, 1)
    out = {}
    reference, tested = reference_frames(
        g, cell, ctx.seed, device, chosen, lambda d, c: outputs[1][c], "f32")
    out["program"] = {"frame_gap": frame_gap(reference, tested)}
    control = precision.CONTROL[g["precision"]]
    lower, _ = reference_frames(g, cell, ctx.seed, device, chosen,
                                lambda d, c: outputs[1][c], control)
    out[f"control_{control}"] = {"frame_gap": frame_gap(reference, lower)}
    return out
