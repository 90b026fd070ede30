"""Training: ``Trainer.train_steps_sampled`` over a card-resident corpus
(``DeviceDataset.from_sequences``), one step a call, at the
configuration's global batch.

Cell parameters: ``sequences`` and ``frames`` of the corpus (standard
normal motion and audio features drawn on the device from the seed) and
``check`` (the limit of each number compared: ``loss_gap``,
``grad_gap``, ``change_gap``; one without a limit is logged and not
compared).

Set-up builds the model, the trainer and its state and drives that state
through its first three steps (eager, captured, replayed), which the
reference follows, and two more; the window then runs that same state.
After each step the harness records a CUDA event on the step's stream;
the step times are the gaps between consecutive events.

Over a mesh of data-parallel ranks (``ctx.mesh``, one process a card)
each rank draws its share of the global batch and the trainer averages
the gradients; every rank runs the same number of steps, which set-up
fixes from the time of ``PROBE_STEPS`` more and the ranks agree on.
Rank 0 reports, judging every rank's readings.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from lib import common, work
from lib.trace import Trace, profiled
from reference import fact as ref
from reference import precision

CHECKED_STEPS = 3
WARM_STEPS = 2  # replays after the checked steps, before the window
LEAD = 2  # steps the host may run ahead of the device's last finished one
PROBE_STEPS = 5  # over ranks: the steps whose time fixes the window's
TRACE_STEPS = 24  # the steps a traced run profiles


def corpus(g: dict, cell: dict, seed: int, device):
    """[sequences, frames, motion_dim] and [..., audio_dim] features."""
    gen = common.generator(device, seed, common.STREAM_CORPUS)
    n, t = cell["sequences"], cell["frames"]
    motion = torch.randn(n, t, g["motion_dim"], generator=gen, device=device)
    audio = torch.randn(n, t, g["audio_dim"], generator=gen, device=device)
    return motion, audio


def train_seed(seed: int) -> int:
    return common.sub_seed(seed, common.STREAM_TRAIN)


def schedule_rate(g: dict, count: int) -> float:
    bounds = g["learning_rate_boundaries"]
    return float(np.float32(g["learning_rates"][
        sum(count >= b for b in bounds)]))


def build(g: dict, cell: dict, seed: int, device, mesh=None):
    """The program's model, trainer, state and dataset for the run (this
    rank's, over `mesh`)."""
    from mint_tpu_torch.data.device_dataset import DeviceDataset
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.train import Trainer, schedules

    compute = torch.bfloat16 if g["precision"] == "bf16" else None
    model = builder.build(common.port_model_config(g), is_training=True,
                          device=device, compute_dtype=compute, mesh=mesh)
    model.load_state_dict(common.make_params(g, seed, device,
                                             served=torch.float32),
                          strict=True)
    trainer = Trainer(model, schedules.manual_stepping(
        g["learning_rate_boundaries"], g["learning_rates"]),
        grad_clip_norm=g["grad_clip_norm"], mesh=mesh)
    state = trainer.init_state(model)
    motion, audio = corpus(g, cell, seed, device)
    dataset = DeviceDataset.from_sequences(
        list(motion.cpu().numpy()), list(audio.cpu().numpy()),
        g["motion_input_length"], g["target_length"], g["target_shift"],
        g["audio_input_length"], g["batch_size"], device=device, mesh=mesh)
    return model, trainer, state, dataset


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
           ) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[k] for k in names]))
    return dict(zip(names, (norms * scale).tolist()))


def program_readings(g, cell, seed, device, hooks=None, mesh=None):
    """Set-up up to the window: the program's state after the checked and
    the warm steps, and its readings of the checked ones (each step's
    loss, the first gradient's norm a leaf from Adam's first moment after
    one step, the change of each leaf over the three)."""
    t0 = time.perf_counter()
    model, trainer, state, dataset = build(g, cell, seed, device, mesh)
    built = time.perf_counter() - t0
    if hooks:
        hooks(model, trainer, dataset)
    start = {k: v.detach().to("cpu", copy=True)
             for k, v in state.params.items()}
    ts = train_seed(seed)
    losses, grad = [], None
    for step in range(CHECKED_STEPS):
        state, metrics = trainer.train_steps_sampled(state, dataset, 1, ts)
        losses.append(float(metrics["loss"]))
        if step == 0:  # mu = (1 - b1) g after one step
            grad = _norms(state.opt_state["mu"], 1.0 / (1 - ref.ADAM_B1))
    change = {}
    for k, v in state.params.items():
        change[k] = float(torch.linalg.vector_norm(
            v.detach() - start[k].to(device)))
    for _ in range(WARM_STEPS):
        state, metrics = trainer.train_steps_sampled(state, dataset, 1, ts)
    float(metrics["loss"])
    return (model, trainer, state, dataset,
            {"loss": losses, "grad": grad, "change": change,
             "seconds": (built, time.perf_counter() - t0 - built)})


#: A data rank's draws are seeded from the run's train seed plus this
#: stride times its index, as the program's card-resident dataset does.
SEED_STRIDE = 1000003


def batch_at(g, cell, seed, device, step, motion, audio):
    """The global batch of `step`: each data rank's windows, in rank
    order (see :func:`rank_batch`)."""
    ranks = g["data_parallel"]
    parts = [rank_batch(g, seed, device, step, motion, audio, r,
                        g["batch_size"] // ranks) for r in range(ranks)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def rank_batch(g, seed, device, step, motion, audio, rank, b):
    """Data rank `rank`'s `b` training windows of `step`: the traffic's
    draw, a sequence then a start within it a row, on a device generator
    seeded from the run's train seed, the rank and the step (as the
    program's card-resident dataset draws them)."""
    mask = (1 << 64) - 1
    z = ((int(train_seed(seed)) + SEED_STRIDE * rank) * 0x9E3779B97F4A7C15
         + int(step)) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    gen = torch.Generator(device=device)
    gen.manual_seed((z ^ (z >> 31)) >> 1)
    n, t = motion.shape[:2]
    span = max(g["motion_input_length"], g["target_shift"]
               + g["target_length"], g["audio_input_length"])
    counts = torch.full((n,), t - span + 1, device=device)
    idx = torch.randint(0, n, (b,), generator=gen, device=device)
    u = torch.rand((b,), generator=gen, device=device)
    cnt = counts[idx]
    start = torch.minimum((u * cnt).long(), cnt - 1)
    mspan = max(g["motion_input_length"],
                g["target_shift"] + g["target_length"])
    rows = start[:, None] + torch.arange(mspan, device=device)
    m = motion[idx[:, None], rows]
    a = audio[idx[:, None], start[:, None]
              + torch.arange(g["audio_input_length"], device=device)]
    sh = g["target_shift"]
    return {"motion_input": m[:, :g["motion_input_length"]],
            "target": m[:, sh:sh + g["target_length"]], "audio_input": a}


def reference_readings(g, cell, seed, device, rnd_name="f32",
                       rows=None) -> dict:
    """The reference's readings of the checked steps, in float32 (TF32
    off) with `rnd_name`'s rounding of every matmul; `rows` keeps part of
    each batch (a planted fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    motion, audio = corpus(g, cell, seed, device)
    batches = [batch_at(g, cell, seed, device, s, motion, audio)
               for s in range(CHECKED_STEPS)]
    p = common.make_params(g, seed, device, served=torch.float32)
    start = {k: v.clone() for k, v in p.items()}
    losses, grad, p = ref.train_steps(p, batches, g,
                                      schedule_rate(g, 0),
                                      precision.ROUNDING[rnd_name], rows)
    change = {k: float(torch.linalg.vector_norm(p[k] - start[k]))
              for k in p}
    return {"loss": losses, "grad": grad, "change": change}


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """The gaps of the program's readings from the reference's: the
    widest relative gap of a step's loss, and the worst leaf's gap of the
    first gradient's norm and of the change's, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    median = float(np.median(list(refr["grad"].values())))
    keep = [k for k, v in refr["grad"].items() if v >= 1e-3 * median]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["loss"], refr["loss"])),
            "grad_gap": common.worst_leaf_gap(prog["grad"], refr["grad"],
                                              keep),
            "change_gap": common.worst_leaf_gap(prog["change"],
                                                refr["change"], keep)}


def _gather(mesh, obj):
    """Every rank's `obj` on rank 0, in rank order (None elsewhere); a
    list of one without a mesh."""
    if mesh is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * dist.get_world_size() if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.host_group)
    return out


def _agreed_steps(trainer, state, dataset, ts, device, mesh, seconds):
    """The steps every rank runs in the window: enough, by the time of
    ``PROBE_STEPS`` more, to last `seconds`; the most any rank asks."""
    import math

    import torch.distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    for _ in range(PROBE_STEPS):
        state, metrics = trainer.train_steps_sampled(state, dataset, 1, ts)
    float(metrics["loss"])
    sync()
    each = (time.perf_counter() - t0) / PROBE_STEPS
    n = torch.tensor([math.ceil(seconds / each)], device=device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=mesh.data_group)
    return state, int(n.item())


def run(ctx) -> dict:
    g, cell, device = ctx.config, ctx.cell, ctx.device
    mesh = ctx.mesh
    cuda = device.type == "cuda"
    model, trainer, state, dataset, readings = program_readings(
        g, cell, ctx.seed, device, ctx.hooks, mesh)
    ctx.log("set-up: model, state and corpus %.3f s, then the checked and "
            "warm steps %.3f s" % readings["seconds"])
    ts = train_seed(ctx.seed)
    planned = None
    if mesh is not None and not ctx.trace:
        state, planned = _agreed_steps(trainer, state, dataset, ts, device,
                                       mesh, ctx.seconds)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start
    losses: List[torch.Tensor] = []
    times: List[float] = []
    trace = None

    def window(stop):
        nonlocal state
        events = []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        while not stop(len(losses)):
            state, metrics = trainer.train_steps_sampled(state, dataset, 1,
                                                         ts)
            losses.append(metrics["loss"])
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                if len(events) > LEAD + 1:
                    events[-LEAD - 2].synchronize()
        if cuda:
            torch.cuda.synchronize(device)
            times.extend(a.elapsed_time(b)
                         for a, b in zip(events, events[1:]))

    t0 = time.perf_counter()
    if ctx.trace:
        n = TRACE_STEPS
        for attempt in range(3):
            with profiled() as prof:
                t0 = time.perf_counter()
                window(lambda done: done >= n * (attempt + 1))
            rows = g["batch_size"] // g["data_parallel"]  # this rank's
            trace = Trace.from_profile(
                prof[0], units=n,
                bounds=work.bound_seconds(
                    work.train_forward_calls(g, rows), g["precision"]),
                flops=work.train_step_flops(g) * rows,
                peak=work.PEAK_FLOPS[g["precision"]],
                families=ctx.families)
            if trace.kernels():
                break
            ctx.log(f"trace attempt {attempt + 1}: no device event")
    elif planned is not None:
        window(lambda done: done >= planned)
    else:
        window(lambda done: time.perf_counter() - t0 >= ctx.seconds)
    elapsed = time.perf_counter() - t0
    steps = len(losses)
    failed = sum(int(not torch.isfinite(x).all()) for x in losses)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, trainer, state, dataset, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ranks = _gather(mesh, {"readings": readings, "peak": peak,
                           "failed": failed,
                           "busy_s": trace.busy_s() if trace else 0.0,
                           "window_s": trace.window_s if trace else 0.0})
    if ranks is None:  # not rank 0: rank 0 judges and reports
        return {}

    refr = reference_readings(g, cell, ctx.seed, device)
    every = [compare(r["readings"], refr) for r in ranks]
    gaps = {k: max(e[k] for e in every) for k in every[0]}
    failed = sum(r["failed"] for r in ranks)
    peak = max(r["peak"] for r in ranks)
    for k, v in gaps.items():
        if k not in cell["check"]:
            ctx.log(f"{k} (not compared): {v!r}")
    e2e = {"train_steps_per_s": steps / elapsed, "setup_s": setup_s}
    if times:
        e2e["train_step_ms_p95"] = common.percentile(times, 95)
        ctx.log("step ms: " + ", ".join(
            f"p{q} {common.percentile(times, q):.3f}" for q in (5, 50, 90, 95,
                                                              99))
            + f", max {max(times):.3f}, over {len(times)} steps")
    return {"e2e": e2e, "trace": trace, "attempted": steps,
            "failed": failed, "memory_peak_bytes": peak,
            "checks": {k: (v, cell["check"][k]) for k, v in gaps.items()
                       if k in cell["check"]},
            "busy_s": sum(r["busy_s"] for r in ranks) / len(ranks),
            "window_s": sum(r["window_s"] for r in ranks) / len(ranks)}


def calibrate(ctx) -> dict:
    """One seed's readings for the limits: the program's (its set-up
    steps), the control's (the reference with every matmul in the
    precision below the configuration's) and a planted fault's (the
    reference taking the loss over half of each batch)."""
    g, cell, device = ctx.config, ctx.cell, ctx.device
    model, trainer, state, dataset, readings = program_readings(
        g, cell, ctx.seed, device, ctx.hooks, ctx.mesh)
    del model, trainer, state, dataset
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ranks = _gather(ctx.mesh, readings)
    if ranks is None:
        return {}
    refr = reference_readings(g, cell, ctx.seed, device)
    control = precision.CONTROL[g["precision"]]
    half = slice(0, g["batch_size"] // 2)
    every = [compare(r, refr) for r in ranks]
    return {"program": {k: max(e[k] for e in every) for k in every[0]},
            f"control_{control}": compare(reference_readings(
                g, cell, ctx.seed, device, control), refr),
            "half_batch": compare(reference_readings(
                g, cell, ctx.seed, device, rows=half), refr)}
