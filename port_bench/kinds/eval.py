"""A scoring pass over a corpus: ``Evaluator.evaluate`` of the program,
passes back to back, its bucketing by generatable length, its batches of
up to ``decode_batch`` clips padded to powers of two, and its decode
graphs, one a (batch, steps) key.

Cell parameters: ``clips`` clips of ``steps`` generatable frames and
``short_clips`` clips of distinct lengths drawn in ``short_steps`` [lo,
hi] (each its own bucket), ``decode_batch`` (the evaluator's cap; absent:
its default) and ``check`` (``clips`` checked, ``frames`` a clip that the
reference recomputes, the limit ``frame_gap``).  A traced run profiles one
pass.

The corpus (each clip a motion seed of ``motion_seq_length`` frames and an
audio track of its length + ``audio_seq_length`` - 1 frames, standard
normal) is drawn from the run's seed on the device and held on the host
as the evaluator's dataset.  Set-up runs one whole pass, which captures
every key; the window opens when the next pass starts and closes when the
first pass that ends after ``--seconds`` returns.  ``decode_frames_per_s``
is the generated frames of the window's passes (the clips' own, no pad
clip's) over the window.

The frames come from a metric on the evaluator's own interface that keeps
the checked clips' outputs of each pass.  The checked clips are drawn from
the seed before the runs, one at least among the short ones; after the
window each takes a pass of the window, drawn from the seed; its frames
are teacher-forced against the reference as the decode cells' are.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from lib import common, registry, work
from lib.trace import Trace, profiled

_KINDS = os.path.dirname(os.path.abspath(__file__))
decode = registry.kind("decode", os.path.dirname(_KINDS))


def lengths(cell: dict, seed: int) -> List[int]:
    """Each clip's generatable frames: the long clips', then the short
    ones', distinct, drawn from the seed."""
    lo, hi = cell["short_steps"]
    gen = common.generator("cpu", seed, common.STREAM_CORPUS)
    short = (lo + torch.randperm(hi - lo + 1, generator=gen)
             [:cell["short_clips"]]).tolist()
    return [cell["steps"]] * cell["clips"] + short


def corpus(g: dict, cell: dict, seed: int, device) -> List[Dict]:
    """The evaluator's dataset: one example a clip, on the host."""
    gen = common.generator(device, seed, common.STREAM_INPUTS)
    out = []
    for i, n in enumerate(lengths(cell, seed)):
        motion = torch.randn(g["motion_seq_length"], g["motion_dim"],
                             generator=gen, device=device)
        audio = torch.randn(n + g["audio_seq_length"] - 1, g["audio_dim"],
                            generator=gen, device=device)
        out.append({"motion_input": motion.cpu().numpy(),
                    "audio_input": audio.cpu().numpy(),
                    "motion_name": f"clip{i}".encode(),
                    "audio_name": b"music"})
    return out


def checked(cell: dict, seed: int) -> List[int]:
    """The checked clips' indices, one at least a short clip."""
    gen = common.generator("cpu", seed, common.STREAM_CHECK)
    n_long, n = cell["clips"], cell["clips"] + cell["short_clips"]
    short = n_long + int(torch.randint(cell["short_clips"], (1,),
                                       generator=gen))
    rest = [int(c) for c in torch.randperm(n, generator=gen)
            if int(c) != short][:cell["check"]["clips"] - 1]
    return sorted([short] + rest)


class Recorder:
    """A metric on the evaluator's interface that keeps the generated
    frames of the checked clips each pass (a clip is told by its seed
    motion), and counts the clips whose frames are not finite."""

    name = "port_bench_recorder"

    def __init__(self, dataset: List[Dict], clips: List[int], seq: int):
        self.seq = seq
        self.keys = {dataset[c]["motion_input"].tobytes(): c for c in clips}
        self.passes: List[Dict[int, np.ndarray]] = []
        self.clips = self.failed = 0

    def reset_states(self) -> None:
        self.passes.append({})

    def update_state(self, inputs, pred) -> None:
        self.clips += 1
        pred = np.asarray(pred)
        self.failed += int(not np.isfinite(pred).all())
        c = self.keys.get(np.asarray(inputs["motion_input"])[0].tobytes())
        if c is not None:
            self.passes[-1][c] = pred[0, self.seq:].copy()

    def result(self) -> float:
        return 0.0


def build_evaluator(g: dict, cell: dict, seed: int, device):
    from mint_tpu_torch.eval.evaluator import Evaluator

    model = decode.build(g, seed, device)
    dataset = corpus(g, cell, seed, device)
    recorder = Recorder(dataset, checked(cell, seed),
                        g["motion_seq_length"])
    kw = ({"decode_batch": cell["decode_batch"]} if "decode_batch" in cell
          else {})
    return Evaluator(model, dataset, metrics=(recorder,), output_dir=None,
                     steps=cell["steps"], **kw), model, dataset, recorder


def reference_frames(g, seed, device, dataset, chosen, frames_of,
                     rnd_name="f32"):
    """The reference's frame at each checked (clip, step) of `chosen`,
    fed the protocol's windows of the clip's own frames
    (`frames_of(clip)`), with `rnd_name`'s rounding of every matmul; and
    the frames under test.  Each [n, dim]."""
    from reference import fact as ref
    from reference import precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = common.make_params(g, seed, device,
                                served=decode.DTYPES[g["precision"]])
    refs, tested = [], []
    for c, steps in chosen:
        frames = torch.as_tensor(frames_of(c), device=device).float()
        seeds = torch.as_tensor(dataset[c]["motion_input"], device=device)
        audio = torch.as_tensor(dataset[c]["audio_input"], device=device)
        refs.append(ref.next_frames(params, g, seeds[None], audio[None],
                                    frames[None], [(0, t) for t in steps],
                                    precision.ROUNDING[rnd_name]))
        tested.append(frames[steps])
    return torch.cat(refs), torch.cat(tested)


def frame_picks(cell: dict, seed: int, clips: List[int], n_steps: List[int]):
    """Each checked clip's frames: ``check.frames`` of its steps, its
    first and last among them."""
    gen = common.generator("cpu", seed, common.STREAM_CHECK, 2)
    out = []
    for c in clips:
        n, k = n_steps[c], cell["check"]["frames"]
        inner = torch.randperm(n - 2, generator=gen)[:k - 2]
        out.append((c, sorted([0, n - 1] + (inner + 1).tolist())))
    return out


def run(ctx) -> dict:
    g, cell, device = ctx.config, ctx.cell, ctx.device
    evaluator, model, dataset, recorder = build_evaluator(g, cell, ctx.seed,
                                                          device)
    n_steps = lengths(cell, ctx.seed)
    frames_a_pass = sum(n_steps)
    evaluator.evaluate()  # captures every key
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start
    clips_before, failed_before = recorder.clips, recorder.failed
    recorder.passes.clear()
    trace = None
    t0 = time.perf_counter()
    if ctx.trace:
        for attempt in range(3):  # an empty device trace is taken again
            recorder.passes.clear()
            with profiled() as prof:
                t0 = time.perf_counter()
                evaluator.evaluate()
            trace = Trace.from_profile(
                prof[0], units=frames_a_pass, bounds={},
                flops=work.decode_step_flops(g),
                peak=work.PEAK_FLOPS[g["precision"]],
                families=ctx.families)
            if trace.kernels():
                break
            ctx.log(f"trace attempt {attempt + 1}: no device event")
    else:
        while True:
            evaluator.evaluate()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window = time.perf_counter() - t0
    passes = len(recorder.passes)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del evaluator, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    clips = checked(cell, ctx.seed)
    which = common.generator("cpu", ctx.seed, common.STREAM_CHECK, 1)
    pass_of = dict(zip(clips, torch.randint(passes, (len(clips),),
                                            generator=which).tolist()))
    gap = decode.frame_gap(*reference_frames(
        g, ctx.seed, device, dataset,
        frame_picks(cell, ctx.seed, clips, n_steps),
        lambda c: recorder.passes[pass_of[c]][c]))
    return {"e2e": {"decode_frames_per_s": passes * frames_a_pass / window,
                    "setup_s": setup_s},
            "trace": trace,
            "attempted": recorder.clips - clips_before,
            "failed": recorder.failed - failed_before,
            "memory_peak_bytes": peak,
            "checks": {"frame_gap": (gap, cell["check"]["frame_gap"])}}


def calibrate(ctx) -> dict:
    """One seed's readings for the limit of ``frame_gap``: the program's,
    from the pass after the set-up's, and the control's (the reference
    with every matmul in the precision below the configuration's) at the
    same clips and frames."""
    from reference import precision

    g, cell, device = ctx.config, ctx.cell, ctx.device
    evaluator, model, dataset, recorder = build_evaluator(g, cell, ctx.seed,
                                                          device)
    n_steps = lengths(cell, ctx.seed)
    for _ in range(2):
        evaluator.evaluate()
    del evaluator, model
    gc.collect()
    chosen = frame_picks(cell, ctx.seed, checked(cell, ctx.seed), n_steps)

    def last(c):
        return recorder.passes[-1][c]
    reference, tested = reference_frames(g, ctx.seed, device, dataset,
                                         chosen, last)
    control = precision.CONTROL[g["precision"]]
    lower, _ = reference_frames(g, ctx.seed, device, dataset, chosen, last,
                                control)
    return {"program": {"frame_gap": decode.frame_gap(reference, tested)},
            f"control_{control}": {"frame_gap": decode.frame_gap(reference,
                                                                 lower)}}
