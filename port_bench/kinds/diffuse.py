"""Offline long-form dance generation by diffusion: dispatches of `songs`
songs of `frames` frames each through EDGE's DDIM sampler
(``EDGEFamily.predict``, which runs ``infer.diffusion.sample``), the songs
fetched to the host at the end of each dispatch.

Cell parameters: ``songs``, ``frames`` (a song is seq_len frames plus
whole half chunks: 1200 = 15 chunks of 150, 75 apart) and ``check``
(``picks`` (dispatch, song, chunk) the reference recomputes, ``steps``
recorded steps a pick, and the limits ``x0_gap`` and ``update_gap``).  A
traced run profiles one dispatch (its music memory and every step).

Each dispatch's inputs (the songs' music features [songs, frames, F], the
chunks' initial state x_T and every step's noise z_j, standard normal)
are drawn on the device from the run's seed and the dispatch's index.
Set-up samples dispatch 0, which captures the step's graph; the window
opens when dispatch 1 is issued and closes when the first dispatch that
ends after ``--seconds`` has its songs on the host.

The check: the picks' (song, chunk) and recorded steps (the first, τ = 999,
and the last, τ = 19, among them) are drawn from the seed before the
runs, and every dispatch records them (the sampler's ``record``); after
the window each pick takes a dispatch of the window, drawn from the seed.
``x0_gap``: the widest relative L2 gap of the program's guided, clipped
x0 from the reference's (``reference/edge.py``, float32) computed from the
program's recorded state; ``update_gap``: of the program's next state
(after the stitch) from the reference's step from the program's state and
x0 (and the previous chunk's, whose second half the stitch copies).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Tuple

import torch

from lib import common, work_diffusion
from lib.trace import Trace, profiled
from reference import edge as ref
from reference import precision

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def layout(g: dict, cell: dict) -> Tuple[int, int]:
    """(chunks a song, chunks a dispatch)."""
    n, half = g["seq_len"], g["seq_len"] // 2
    if cell["frames"] < n or (cell["frames"] - n) % half:
        raise ValueError(f"{cell['frames']} frames a song: not {n} plus "
                         f"whole half chunks")
    k = (cell["frames"] - n) // half + 1
    return k, k * cell["songs"]


def inputs(g: dict, cell: dict, seed: int, index: int, device):
    """Dispatch `index`'s chunked music features [chunks, seq, F], x_T
    [chunks, seq, nfeats] and noise [steps - 1, chunks, seq, nfeats]."""
    gen = common.generator(device, seed, common.STREAM_INPUTS, index)
    n, half = g["seq_len"], g["seq_len"] // 2
    _, total = layout(g, cell)
    music = torch.randn(cell["songs"], cell["frames"],
                        g["cond_feature_dim"], generator=gen, device=device)
    cond = music.unfold(1, n, half).transpose(2, 3).reshape(
        total, n, g["cond_feature_dim"])
    x_t = torch.randn(total, n, g["nfeats"], generator=gen, device=device)
    noise = torch.randn(g["sampling_steps"] - 1, total, n, g["nfeats"],
                        generator=gen, device=device)
    return cond, x_t, noise


def make_params(g: dict, seed: int, device, served: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """The run's weights, float32 on `device`, one draw a kind of leaf:
    glorot-uniform matrices, small random biases and LayerNorm affines,
    standard normal null embeddings (EDGE's own initialisation).  Every
    leaf but the LayerNorms' is rounded to `served`."""
    spec = ref.param_spec(g)
    gen = common.generator(device, seed, common.STREAM_WEIGHTS)
    groups: Dict[str, List] = {}
    for name, shape, kind in spec:
        groups.setdefault(kind, []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for kind in ("dense", "bias", "ln_scale", "ln_bias", "embed"):
        leaves = groups.get(kind, [])
        total = sum(int(torch.Size(s).numel()) for _, s in leaves)
        if kind == "dense":
            flat = torch.rand(total, generator=gen, device=device) * 2 - 1
        else:
            flat = torch.randn(total, generator=gen, device=device)
        at = 0
        for name, shape in leaves:
            x = flat[at:at + int(torch.Size(shape).numel())].view(shape)
            at += x.numel()
            if kind == "dense":
                x = x * (6.0 / (shape[0] + shape[1])) ** 0.5
            elif kind == "bias":
                x = x * 0.02
            elif kind == "ln_scale":
                x = 1.0 + 0.1 * x
            elif kind == "ln_bias":
                x = 0.1 * x
            if not kind.startswith("ln_"):
                x = x.to(served).float()
            out[name] = x.contiguous()
    return {name: out[name] for name, _, _ in spec}


def port_model_config(g: dict):
    from mint_tpu_torch.config import schema as s

    fields = {f.name for f in dataclasses.fields(s.EDGEModelConfig)}
    return s.MultiModalModelConfig(edge_model=s.EDGEModelConfig(
        **{k: g[k] for k in fields}))


def build(g: dict, seed: int, device):
    from mint_tpu_torch.models import builder

    dtype = DTYPES[g["precision"]]
    model = builder.build(port_model_config(g), is_training=False,
                          dtype=dtype, device=device)
    model.load_state_dict(make_params(g, seed, device, served=dtype),
                          strict=True)
    return model


def picks(g: dict, cell: dict, seed: int):
    """[(song, chunk, steps)] of the check, drawn from the seed: the first
    pick's chunk any, the others' past a song's first (the stitch
    shows); each pick's steps the first and the last among them."""
    gen = common.generator("cpu", seed, common.STREAM_CHECK)
    chk, steps = cell["check"], g["sampling_steps"]
    k, _ = layout(g, cell)
    out = []
    for i in range(chk["picks"]):
        song = int(torch.randint(cell["songs"], (1,), generator=gen))
        lo = 0 if i == 0 or k == 1 else 1
        chunk = int(torch.randint(lo, k, (1,), generator=gen))
        inner = torch.randperm(steps - 2, generator=gen)[:chk["steps"] - 2]
        out.append((song, chunk, sorted([0, steps - 1]
                                        + (inner + 1).tolist())))
    return out


def record_pairs(g: dict, cell: dict, chosen) -> List[Tuple[int, int]]:
    """The (step, chunk) pairs every dispatch records: each pick's chunk
    and, past a song's first chunk, the chunk before it."""
    k, _ = layout(g, cell)
    pairs = set()
    for song, chunk, steps in chosen:
        flat = song * k + chunk
        for j in steps:
            pairs.add((j, flat))
            if chunk > 0:
                pairs.add((j, flat - 1))
    return sorted(pairs)


def dispatch_picks(seed: int, dispatches: int, n: int) -> List[int]:
    """The window's dispatch (0-based among them) each pick reads."""
    gen = common.generator("cpu", seed, common.STREAM_CHECK, 1)
    return torch.randint(dispatches, (n,), generator=gen).tolist()


def gaps(g, cell, seed, device, chosen, pairs, records, dispatch_of,
         rnd_name="f32", state_rnd="f32", fault=None):
    """(x0_gap, update_gap) of the recorded steps against the reference
    with `rnd_name`'s rounding of every matmul and `state_rnd`'s of the
    update.  `records[d]` is dispatch d's [pairs, 3, seq, nfeats];
    `dispatch_of[i]` the dispatch of pick i, 1-based as `inputs` draws it.
    `fault` (calibration only) plants one: "weight_1" (guidance weight
    1 in the reference standing for the program)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = make_params(g, seed, device, served=DTYPES[g["precision"]])
    rnd = precision.ROUNDING[rnd_name]
    srnd = precision.ROUNDING[state_rnd]
    sched = ref.schedule(g)
    k, _ = layout(g, cell)
    half = g["seq_len"] // 2
    at = {p: i for i, p in enumerate(pairs)}
    x0_gap = update_gap = 0.0
    for (song, chunk, steps), d in zip(chosen, dispatch_of):
        cond, _, noise = inputs(g, cell, seed, d, device)
        rec = records[d].to(device)
        flat = song * k + chunk
        for j in steps:
            tau, tau_next, w = sched[j]
            x_in, x0, x_out = rec[at[(j, flat)]]
            weight = 1.0 if fault == "weight_1" else w
            x0_ref = ref.guided(params, x_in[None], cond[flat:flat + 1],
                                tau, weight, g, rnd)[0]
            if fault == "weight_1":  # the faulty program against the sound
                x0, x0_ref = x0_ref, ref.guided(params, x_in[None],
                                                cond[flat:flat + 1], tau, w,
                                                g, rnd)[0]
            x0_gap = max(x0_gap, _rel(x0, x0_ref))
            z = noise[j] if j < noise.shape[0] else torch.zeros_like(x_in)
            want = ref.ddim_update(x_in, x0, z[flat], tau, tau_next, g, srnd)
            if chunk > 0 and tau_next >= 0:
                p_in, p0, _ = rec[at[(j, flat - 1)]]
                prev = ref.ddim_update(p_in, p0, z[flat - 1], tau, tau_next,
                                       g, srnd)
                want = torch.cat([prev[half:], want[half:]])
            update_gap = max(update_gap, _rel(x_out, want))
        del cond, noise
    return x0_gap, update_gap


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


def predict(model, cond, chunks, x_t, noise, pairs, rec):
    """The songs of one dispatch through the model family's generation."""
    from mint_tpu_torch.models.multi_modal import EDGEFamily

    return EDGEFamily(model).predict({
        "cond": cond, "chunks": chunks, "x_T": x_t, "noise": noise,
        "record": pairs, "record_out": rec})


def run(ctx) -> dict:
    g, cell, device = ctx.config, ctx.cell, ctx.device
    model = build(g, ctx.seed, device)
    k, total = layout(g, cell)
    chunks = [k] * cell["songs"]
    chosen = picks(g, cell, ctx.seed)
    pairs = record_pairs(g, cell, chosen)
    shape = (len(pairs), 3, g["seq_len"], g["nfeats"])

    def dispatch(index: int):
        cond, x_t, noise = inputs(g, cell, ctx.seed, index, device)
        rec = torch.empty(shape, device=device)
        songs = predict(model, cond, chunks, x_t, noise, pairs, rec)
        return torch.stack(songs).cpu(), rec.cpu()

    dispatch(0)  # builds the kernels, captures the step's graph
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start
    outputs, trace = [], None
    t0 = time.perf_counter()
    steps = g["sampling_steps"]
    if ctx.trace:
        calls = work_diffusion.step_calls(g, total, steps)
        for attempt in range(3):  # an empty device trace is taken again
            with profiled() as prof:
                t0 = time.perf_counter()
                outputs = [dispatch(1)]
            trace = Trace.from_profile(
                prof[0], units=steps * len(outputs),
                bounds=work_diffusion.bound_seconds(calls, g["precision"]),
                flops=work_diffusion.step_flops(g, total, steps),
                peak=work_diffusion.PEAK_FLOPS[g["precision"]],
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
    frames_done = sum(int(o.shape[0] * o.shape[1]) for o, _ in outputs)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(int(not torch.isfinite(o[s]).all())
                 for o, _ in outputs for s in range(o.shape[0]))
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    records = {1 + i: rec for i, (_, rec) in enumerate(outputs)}
    dispatch_of = [1 + d for d in dispatch_picks(ctx.seed, len(outputs),
                                                 len(chosen))]
    x0_gap, update_gap = gaps(g, cell, ctx.seed, device, chosen, pairs,
                              records, dispatch_of)
    chk = cell["check"]
    return {"e2e": {"decode_frames_per_s": frames_done / window,
                    "setup_s": setup_s},
            "trace": trace, "attempted": len(outputs) * cell["songs"],
            "failed": failed, "memory_peak_bytes": peak,
            "checks": {"x0_gap": (x0_gap, chk["x0_gap"]),
                       "update_gap": (update_gap, chk["update_gap"])}}


def calibrate(ctx) -> dict:
    """One seed's readings for the limits of ``x0_gap`` and
    ``update_gap``: the program's, from one dispatch after the warm-up; the
    control's (the reference's matmuls in the precision below the
    configuration's, its update's operands in TF32's) at the same picks;
    and each planted fault's: guidance weight 1, the stitch skipped (the
    recorded next states unstitched) and a recorded x0 altered (by 1% of
    its norm)."""
    g, cell, device = ctx.config, ctx.cell, ctx.device
    model = build(g, ctx.seed, device)
    k, _ = layout(g, cell)
    chunks = [k] * cell["songs"]
    chosen = picks(g, cell, ctx.seed)
    pairs = record_pairs(g, cell, chosen)
    records = {}
    for index in range(2):
        cond, x_t, noise = inputs(g, cell, ctx.seed, index, device)
        rec = torch.empty(len(pairs), 3, g["seq_len"], g["nfeats"],
                          device=device)
        predict(model, cond, chunks, x_t, noise, pairs, rec)
        records[index] = rec.cpu()
        del cond, x_t, noise
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    one = [1] * len(chosen)
    out = {"program": dict(zip(("x0_gap", "update_gap"), gaps(
        g, cell, ctx.seed, device, chosen, pairs, records, one)))}
    control = precision.CONTROL[g["precision"]]
    out[f"control_{control}"] = dict(zip(("x0_gap", "update_gap"), gaps(
        g, cell, ctx.seed, device, chosen, pairs, records, one, control,
        "tf32")))
    out["fault_weight_1"] = dict(zip(("x0_gap", "update_gap"), gaps(
        g, cell, ctx.seed, device, chosen, pairs, records, one,
        fault="weight_1")))
    half = g["seq_len"] // 2
    unstitched = {d: r.clone() for d, r in records.items()}
    at = {p: i for i, p in enumerate(pairs)}
    _, _, noise = inputs(g, cell, ctx.seed, 1, device)
    sched = ref.schedule(g)
    for song, chunk, steps in chosen:
        if chunk == 0:
            continue
        flat = song * k + chunk
        for j in steps[:-1]:  # the stitch skipped: the first half its own
            r = unstitched[1][at[(j, flat)]]
            tau, tau_next, _ = sched[j]
            own = ref.ddim_update(r[0].to(device), r[1].to(device),
                                  noise[j][flat], tau, tau_next, g)
            r[2, :half] = own[:half].cpu()
    del noise
    out["fault_unstitched"] = dict(zip(("x0_gap", "update_gap"), gaps(
        g, cell, ctx.seed, device, chosen, pairs, unstitched, one)))
    altered = {d: r.clone() for d, r in records.items()}
    altered[1][:, 1] += 0.01 * altered[1][:, 1].norm(
        dim=(-2, -1), keepdim=True) / (g["seq_len"] * g["nfeats"]) ** 0.5
    out["fault_altered_x0"] = dict(zip(("x0_gap", "update_gap"), gaps(
        g, cell, ctx.seed, device, chosen, pairs, altered, one)))
    return out
