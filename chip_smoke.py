"""Drive the PyTorch port's serving, training, scoring and music-in paths,
and its paths across ranks and replicas, once on one CUDA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU):

1. card and build: the card's name and power limit, torch/CUDA versions,
   and the build of ``mint_tpu_torch/csrc/*.cu`` for sm_90a;
2. each kernel against its plain PyTorch version on the card, at FACT's
   shapes in f32 and bf16 (and two more f32 head dims; attention also on
   the model's strided q/k/v views; the bf16 LayerNorm, which takes f32
   parameters, in bf16 only, with them and in its affine-free form), with
   the tolerance stated; each kernel's time at the batch-20 decode's
   shapes beside the plain version's, its bound and, for attention, that
   of PyTorch's own fused attention call, for the affine-free LayerNorm
   that of ``layer_norm`` (timed in ``time_kernels`` as yardsticks only);
   the bf16 attention backward kernels (``csrc/attention_bwd.cu``)
   against ``attention_backward_reference`` on the model's views at the
   training calls (q[32,10,N,80], a dp4 rank's q[8,10,N,80] and the
   tensor-parallel ranks' q[32,5,N,80] and q[32,3,N,80]; N = 360, 240,
   120) within 2 bf16 ulps of each gradient's peak, two calls equal bit
   for bit, and timed at the training shapes beside the plain VJP they
   replaced, their bound and PyTorch's attention backward;
3. the slice: the flagship FACT (configs/fact_v5_deeper_t10_cm12.config,
   full width and depth, weights from a torch.Generator seeded 0) behind
   the port's GenerationService and HTTP server, warmed up on both length
   buckets (which captures their decode graphs), answers concurrent
   requests in the two buckets, in f32 and in bf16, capturing nothing
   more; the kernels' launch counts, through each graph's capture and
   replays, must equal 16 blocks x decode steps (the bf16 LayerNorm
   kernel: 32 LayerNorms x decode steps in bf16, none in f32);
4. the same f32 weights on the card (kernels, graphed) and on the CPU
   (plain versions, computed in a thread during phase 3): one forward and
   a 60-step decode, compared (the first 3 frames held to a tolerance, the
   drift over 60 recorded);
5. batch-20 decode frames/s in bf16 and f32, for the record; (b) the
   decode's CUDA graph against the same step body uncaptured, at batch 4
   and 20 over 60 steps in f32 and bf16: the frames equal bit for bit,
   the launches through capture and replays the body's, and frames/s of
   both;
6. the training path: (a) the flagship f32 at batch 2, one forward and
   backward on the card (kernels, through their autograd Functions) and on
   the CPU (plain versions) with the same weights and batch: the losses and
   every parameter's gradient compared, and 16 launches of each kernel per
   forward; the same in bf16 compute (f32 parameters): every gradient there
   and finite, and 16 calls of the attention backward kernels (every
   count of a bf16 training run below holds them to 16 a step too); (b) the port's train CLI as a subprocess on the full
   flagship at the config's batch of 32, in f32 and with
   ``--use_bfloat16``, on a synthetic AIST-shaped corpus it reads from
   ``<tmp>/data`` through the config's own ``data_files``, with the host
   pipeline and, in bf16, once more with ``--input_backend=device`` (the
   corpus resident on the card, windows drawn there), the three runs at
   once, each in a directory of its own: it trains, checkpoints and
   writes finite, falling losses, and a second invocation resumes from
   its checkpoint; (c) train steps/s at batch 32 in bf16 and
   f32, each step a replay of the train step's graph; (d) training
   through the graph against the same step body uncaptured, at batch 32
   in f32 and bf16 compute, two fused windows with a checkpoint restore
   between: every parameter and moment equal bit for bit.
7. the scoring path, from phase 6's f32 checkpoint: (a) a synthetic eval
   corpus (``*_tfrecord-testval*``: the protocol's 40 clips of 1200 steps,
   three in a 384-step bucket that a partial batch pads, one too short to
   decode); (b) the port's evaluate CLI as a subprocess on the full
   flagship in f32 at the default decode batch (the 1200-step bucket
   dispatches a full batch of it, then the rest): one clip per decodable
   clip, 16 launches of each f32 kernel per decode step, its first bucket
   against a direct decode of the restored weights on the card; (c) the
   same CLI with ``--use_bfloat16`` on the 384-step bucket;
   (d) the extract_features CLI on a synthetic AIST++ annotation
   directory (beside (c)); (e) the calculate_scores CLI on (b)'s clips
   (FID_k, FID_g, Beat Alignment, finite); (f) the same scores on the card
   and on the CPU;
   then the f32 decode batch sweep and the protocol's generated frames/s
   it gives at each cap, which set the evaluator's default, and the
   kernels timed at the eval's shapes.
8. the music-in path, in phase 7's directory: (a) four synthetic 48 kHz
   stereo WAVs named as AIST++ music (a click track at the name's tempo
   over a chord, 24.5-30 s) and an AIST++ layout of eight sequences over
   them; (b) the port's preprocessing CLI on the card and on the CPU, each
   one's seconds of music extracted per second; (c) the card's features
   against the CPU's (continuous columns within 1e-4 of their peak, the
   tuning and the onset and beat one-hot columns equal, the beat interval
   3600 / BPM within 1.5 frames); (d) the card's tfrecords through the
   train pipeline into one batch; (e) one 1200-step clip a track from the
   card's features, co-batched by GenerationService from phase 6's f32
   checkpoint, 16 launches of each f32 kernel a decode step; (f) a clip's
   BVH (bvh_export) and GIF (visualize, where matplotlib is installed);
   (g) calculate_scores on the clips with Beat Alignment from (b)'s cache.

9. across ranks and replicas, and checkpoints in, in phase 7's directory:
   (a) both kernels at a tensor-parallel rank's shapes (model = 2: 5
   heads of q[B,5,N,80]; the MLP at F = 1536 with no output bias, which
   the ranks add after their sum) against their plain versions in f32
   and bf16, and timed at batch 32 beside their bounds and, for
   attention, PyTorch's fused attention call; the same at a model = 4
   rank's uneven heads (q[32,3,N,80] and q[32,2,N,80]; F = 768); (b) the
   flagship at full
   width and depth split over 2 gloo ranks on cuda:0 (``chip_smoke.py --tp-rank R ...``, one process
   each; uncaptured) against the single-rank port: f32 loss and every
   gradient, one train step, bf16 compute, and each rank's launches a
   forward and, in bf16, its 16 attention backward kernel calls; (c) the train CLI with ``--distributed --num_processes=1``
   (NCCL, its collectives captured in the step's graph) against the CLI
   without it, bf16 at batch 32 on the card-resident corpus over 21
   steps: the checkpoints equal bit for bit, and the steps/s of both and
   of the host pipeline; (d) the evaluator and the server over 2
   replicas on cuda:0 against one replica; (e) the flagship's weights
   under the reference TF checkpoint's names through the pure converter,
   served from the written checkpoint: the same forward bit for bit.
10. the last modules, in phase 7's directory: (a) the train CLI with
   ``--input_backend=native`` (the C++ loader, built with g++ from
   ``mint_tpu_torch/csrc/mint_loader.cc``) in bf16 at batch 32 on phase
   6's corpus (run among phase 6's train CLIs): trains, checkpoints and
   resumes, 16 launches a step; with
   ``--input_backend=auto`` over 9c's steps: it picks the native loader,
   and its synchronized steps/s stand beside 9c's host pipeline and
   card-resident corpus; one batch of each host loader timed on the host;
   (b) the LayerNorm-affine fold: the flagship's f32 weights (LayerNorm
   affines moved off 1 and 0) folded, one forward and a 60-step decode
   against the unfolded model in f32 (2e-4 over the forward and the first
   frames) and bf16 (within twice the unfolded bf16 decode's distance
   from f32), 16 launches a step of each TPU kernel's port and 32
   affine-free LayerNorms in bf16, batch-20 frames/s folded against
   unfolded in both dtypes, and ``Evaluator(fold_ln=True)`` in bf16 on
   phase 7's 384-step bucket from the f32 train CLI's checkpoint.
11. configs past the kernels' old limits: (a) each kernel against its
   plain version at shapes it once refused, at phase 2's tolerance for
   its dtype, timed beside its plain version, its bound and, where one
   PyTorch call computes it, that call: bf16 attention streaming K past
   shared memory (q[20,10,1320,80], q[20,8,720,128]), both dtypes at
   head dims 130, 256, 50, 67 and 64 (q[20,H,360,D], the model's fused
   QKV views, read in place) and at 65540 (batch, head) pairs
   (q[6554,10,48,80] against 120 keys), bf16 on views of rows TMA cannot
   step over (84 elements apart, over 80 columns), and heads past the
   widths of the resident-Q kernels (the scores-once kernels, each score
   once a call through a workspace: q[20,4,360,D] at D = 520 (and 264 in
   f32), and q[2,4,360,D], the model's views: f32 D = 1032 and 2048, bf16
   1360 and 2048); one bf16 call on the
   model's views at D = 50, 67, 130, 1360 and 2048 making the device
   kernels ops.attention.device_kernels names (one at 50, 67 and 130;
   the three scores-once kernels at 1360 and 2048) and no copy, as
   torch.profiler records it; the MLP at F = 3070
   (f32) and 3080 (bf16) and at H = O = 804, and in bf16 at F = 3070, O =
   801, x on a base 2 bytes past 16 and H = O = 804 at M = 960 (split
   K): every operand read where it lies, one bf16 call at H = 804 and F
   = 3080 making its two GEMM kernels (and the reduce of a split pass)
   and no copy, as torch.profiler records it; the bf16 LayerNorm at
   x[7200,1040], [7200,1041] and [7200,2048], with parameters and
   affine-free; (b) each config the kernels once refused (the flagship
   with one geometry field changed: tests/test_torch_ops.py's
   LIMIT_CASES, a 720-key D = 128 config and hidden 804 over 12 heads)
   at full width and depth, built on the card in f32 and bf16 (the CPU's
   side of each, computed from phase 11's start in a thread beside the
   card's work): a decode of 8 steps at batch 4 through its CUDA graph
   against the CPU's (timed again for the configs of LIMIT_TIMED once
   the CPU is done), one
   train step's loss and gradients against the CPU's (bf16 compute for
   training), the launch counts of both; (c) 4 gloo ranks on cuda:0 over
   a 2-head tiny config (a model axis wider than the heads: each head
   gathered from a group of 2 ranks) against one rank: loss, gradients,
   one train step (``chip_smoke.py --wide-rank R ...``, one process
   each).
12. the product loop: ``scripts/torch_e2e_run.py --smoke`` as a
   subprocess, which drives the port's CLIs as a user chains them on the
   full flagship: a synthetic AIST++ corpus (2 musics, 4 + 2 sequences),
   preprocessing of both splits, bf16 training SIGKILLed 1 s after its
   first interval checkpoint (step >= 50) and resumed in a new process to
   100 steps, the evaluate CLI (120-frame clips) in f32 and bf16,
   extract_features and calculate_scores of both sets of clips: the kill
   interrupted a live run, the resumed run restored the killed run's
   newest whole step and ended at the budget (launching each kernel 16
   times a step, and 32 LayerNorms), the clips exist and both score sets
   are finite.
13. EDGE (``mint_tpu_torch/config/edge_jukebox.config``), at the shapes of
   port_bench's diffuse_edge_bf16_s8 (a DDIM step's 36000 rows of 512):
   (a) ``csrc/film.cu``'s FiLM residual against ``film_reference`` (bit
   for bit) and its rotation with LayerNorm (the normed rows within one
   bf16 rounding of ``layer_norm_reference``, their rotation and the call
   that writes no normed rows bit-equal to ``rotary_reference``) and
   without (the memory's rows, and the time tokens from position 150,
   bit for bit); the bf16 fused MLP with erf-GELU on each route that
   applies a GELU (TMA at EDGE's x[36000,512] -> 1024 -> 512, split at 240
   rows, tma_pairs at hidden 804, staged loads, tma_phases at F = 3070)
   within 2 bf16 ulps of ``mlp_reference(..., "erf")`` and nearer it than
   the tanh formula; attention at EDGE's shapes; each timed beside its
   plain version and its bound; (b) the published model (bf16, seeded
   weights) through ``builder.build`` and ``EDGEFamily.predict``: a
   3-chunk dispatch graphed against its steps uncaptured, bit for bit,
   then one dispatch of the cell's 8 songs of 15 chunks after set-up:
   its launches of every kernel (``edge_expected_launches``) and
   frames/s.  ``python3 chip_smoke.py --edge`` runs phases 1 and 13
   alone.

Phase 2 also checks and times both kernels at the training shapes
(batch 32), and checks them at the eval's (the batches phase 7 dispatches
and the evaluator's default).  Before the last lines, one line a phase
gives its seconds.  The last lines are one JSON object describing the kernels
(EDGE's: their rows at the diffuse cell's shapes and their launches a
dispatch),
the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": ...}``.
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
SCALE = 800 ** -0.5  # FACT's attention scale: the full model dim
DISPATCH = 20        # bench.py's decode batch per dispatch
THROUGHPUT_STEPS = 32
SWEEP_STEPS = 16     # the decode sweep's steps at each batch
TRAIN_BATCH = 32     # the flagship config's train batch_size
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def log(*args):
    print(*args, flush=True)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up.
    The launches queue up behind a 20 ms sleep on the card, so they run
    back to back and the host's time to launch them is not in the reading
    (for calls of a few tens of microseconds it would be)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # ~20 ms at the H100's ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernels against their plain versions ------------------------

def _qkv(layout, b, h, nq, nk, d, dtype, gen):
    """q [b, h, nq, d], k and v [b, h, nk, d].  "contiguous": three
    tensors of their own; "rows<st>": views of the first d columns of rows
    st wide; "fused": the model's layout, strided views of one
    [b, nk, 3, h, d] buffer (the fused QKV projection's output, as
    models/layers.py makes them), q cut to its first nq rows."""
    if layout == "contiguous":
        return [torch.randn(b, h, n, d, device="cuda", generator=gen)
                .to(dtype) for n in (nq, nk, nk)]
    if layout.startswith("rows"):
        return [torch.randn(b, h, n, int(layout[4:]), device="cuda",
                            generator=gen).to(dtype)[..., :d]
                for n in (nq, nk, nk)]
    buf = torch.randn(b, nk, 3, h, d, device="cuda", generator=gen)
    q, k, v = buf.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)
    return q[:, :, :nq], k, v


def check_attention(att, gen):
    """Worst error per dtype name."""
    worst = {"f32": 0.0, "bf16": 0.0}
    cases = [(2, 10, 120, 120, 80), (2, 10, 240, 240, 80),
             (2, 10, 360, 360, 80), (2, 10, 48, 360, 80),
             (1, 2, 37, 37, 16)] + [
        (TRAIN_BATCH, 10, n, n, 80) for n in (360, 240, 120)]
    # The f32 kernel takes any D <= 128 on its instances of D rounded up
    # to 8: one not a multiple of 4 (4-byte copies) and one over 80.
    f32_cases = [(1, 2, 37, 37, 18), (1, 3, 70, 50, 100)]
    # The model's own layout at FACT's shapes: strided views in.
    fused = [(2, 10, 360, 360, 80), (2, 10, 48, 360, 80),
             (DISPATCH, 10, 360, 360, 80), (DISPATCH, 10, 48, 360, 80),
             (TRAIN_BATCH, 10, 360, 360, 80)] + [
        (b, 10, nq, nk, 80) for b in eval_batches()
        for nq, nk in ((360, 360), (240, 240), (120, 120), (48, 360))]
    for dtype in (torch.float32, torch.bfloat16):
        for layout, (b, h, nq, nk, d) in (
                [("contiguous", c) for c in cases + (
                    f32_cases if dtype == torch.float32 else [])]
                + [("fused", c) for c in fused]):
            q, k, v = _qkv(layout, b, h, nq, nk, d, dtype, gen)
            got = att.attention(q, k, v, SCALE)
            torch.cuda.synchronize()
            want = att.attention_reference(q, k, v, SCALE)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            if dtype == torch.float32:
                tol, why = 1e-5, "f32 reduction order over D and Nk"
            else:
                tol = 2 * bf16_ulp(peak)
                why = ("2 bf16 ulps at the output's peak: both round to "
                       "bf16, and P's rounding may flip at a tie")
            # [B, H, Nq, D] view of [B, Nq, H, D] storage: the model merges
            # the heads with a view.
            ok = (err <= tol and got.shape == want.shape
                  and got.transpose(1, 2).is_contiguous())
            log(f"attention {str(dtype)[6:]:8s} {layout:10s} q[{b},{h},{nq},"
                f"{d}] k[{b},{h},{nk},{d}]: max_abs_err {err:.3e} tol "
                f"{tol:.3e} ({why}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"attention kernel disagrees: {err}")
            worst[DTYPES[dtype]] = max(worst[DTYPES[dtype]], err)
    return worst


def _fused_grad(gen, b, n, h, d):
    """q, k and v on the model's fused-QKV views (_qkv's "fused") and the
    output's gradient as the model hands it back: the merged heads'
    [B, N, H * D] gradient as a [B, H, N, D] view; bf16."""
    q, k, v = _qkv("fused", b, h, n, n, d, torch.bfloat16, gen)
    do = torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16()
    return q, k, v, do.view(b, n, h, d).transpose(1, 2)


def check_attention_backward(att, gen):
    """The bf16 backward kernels (csrc/attention_bwd.cu, through
    ops.attention._backward_call) against attention_backward_reference on
    the model's views at the flagship's training calls: q[32,10,N,80] on
    one card, q[8,10,N,80] on a dp4 rank, and a tensor-parallel rank's
    heads, q[32,5,N,80] (model = 2) and q[32,3,N,80] (model = 4), N = 360,
    240, 120; within 2 bf16 ulps of each gradient's peak (both round P and
    dS to bf16 where the formula does and each gradient once, their f32
    sums in other orders, so one of those roundings may flip); then two
    calls at q[32,10,360,80] equal bit for bit.  Returns the worst error
    at the full heads and at a rank's, in ulps of the gradient's peak."""
    worst = {"train": 0.0, "tensor_parallel": 0.0}
    for b, h in ((TRAIN_BATCH, 10), (TRAIN_BATCH // 4, 10),
                 (TRAIN_BATCH, 5), (TRAIN_BATCH, 3)):
        for n in (360, 240, 120):
            q, k, v, do = _fused_grad(gen, b, n, h, 80)
            if att.backward_kernels(q, k, v) != att.BACKWARD_KERNELS:
                raise AssertionError(f"q[{b},{h},{n},80]: the backward "
                                     f"kernels do not take the model's views")
            got = att._backward_call(q, k, v, do, SCALE)
            torch.cuda.synchronize()
            want = att.attention_backward_reference(q, k, v, do, SCALE)
            ulps = []
            for g, w in zip(got, want):
                err = (g.float() - w.float()).abs().max().item()
                ulps.append(err / bf16_ulp(w.float().abs().max().item()))
            ok = (max(ulps) <= 2 and all(
                g.dtype == torch.bfloat16 and g.shape == w.shape
                and bool(torch.isfinite(g).all()) for g, w in zip(got, want)))
            log(f"attention backward bf16 fused q[{b},{h},{n},80]: dq, dk, dv"
                f" {', '.join(f'{u:.2f}' for u in ulps)} ulps of each "
                f"gradient's peak (tol 2: P and dS rounded to bf16 as the "
                f"formula does, f32 sums in another order) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"attention backward kernels disagree "
                                     f"at q[{b},{h},{n},80]: {ulps} ulps")
            key = "train" if h == 10 else "tensor_parallel"
            worst[key] = max(worst[key], *ulps)
            del got, want
    q, k, v, do = _fused_grad(gen, TRAIN_BATCH, 360, 10, 80)
    first = att._backward_call(q, k, v, do, SCALE)
    second = att._backward_call(q, k, v, do, SCALE)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"attention backward bf16 q[{TRAIN_BATCH},10,360,80]: two calls "
        f"equal bit for bit: {same}")
    if not same:
        raise AssertionError("the attention backward kernels are not "
                             "deterministic")
    return worst


def mlp_weights(gen, dtype, h=800, f=3072, o=800):
    """W1 [H, F], b1, W2 [F, O], b2 as the model passes them: transposed
    views of nn.Linear's [out, in] weights."""
    def glorot(fan_in, fan_out):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return ((torch.rand(fan_out, fan_in, device="cuda", generator=gen)
                 * 2 - 1) * bound).to(dtype).t()
    w1, w2 = glorot(h, f), glorot(f, o)
    b1 = torch.randn(f, device="cuda", generator=gen) * 0.02
    b2 = torch.randn(o, device="cuda", generator=gen) * 0.02
    return w1, b1.to(dtype), w2, b2.to(dtype)


def mlp_input(gen, m, h, dtype, layout="contiguous"):
    """x [m, h] on the card: contiguous, or ("x_off2") on a base 2 bytes
    past a 16-byte step, or ("x_rows") a view of rows h + 1 apart."""
    if layout == "x_off2":
        flat = torch.randn(m * h + 8, device="cuda", generator=gen)
        return flat.to(dtype)[1:1 + m * h].view(m, h)
    if layout == "x_rows":
        return torch.randn(m, h + 1, device="cuda",
                           generator=gen).to(dtype)[:, :h]
    return torch.randn(m, h, device="cuda", generator=gen).to(dtype)


def check_mlp(mlp, gen):
    """Worst error per dtype name."""
    worst = {"f32": 0.0, "bf16": 0.0}
    # Also at the batch-20 decode's M: in f32 the cross and audio blocks'
    # fc1 (M = 7200, 4800) take the 144-row GEMM instance; in both dtypes
    # the last block's fc2 (M = 960) is split over K, and at batch 1
    # (M = 360) both bf16 passes are.  And at the batch-32 training M
    # (11520, 7680, 3840), which the kernels plan by M and the SM count,
    # and at the eval's (phase 7).
    rows = [2 * 360, 2 * 48, 257, 3, 360, DISPATCH * 360, DISPATCH * 240,
            DISPATCH * 48, TRAIN_BATCH * 360, TRAIN_BATCH * 240,
            TRAIN_BATCH * 120] + [b * n for b in eval_batches()
                                  for n in (360, 240, 120, 48)]
    for dtype in (torch.float32, torch.bfloat16):
        w1, b1, w2, b2 = mlp_weights(gen, dtype)
        for m in rows:
            x = torch.randn(m, 800, device="cuda", generator=gen).to(dtype)
            got = mlp.fused_mlp(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            want = mlp.mlp_reference(x, w1, b1, w2, b2)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            if dtype == torch.float32:
                tol = 1e-5 * max(1.0, peak)
                why = "f32 summation order over H=800 and F=3072 terms"
            else:
                tol = 2 * bf16_ulp(peak)
                why = ("2 bf16 ulps at the output's peak: both round the "
                       "activation and the output to bf16")
            ok = err <= tol and got.shape == want.shape
            log(f"fused_mlp {str(dtype)[6:]:8s} x[{m},800] W1[800,3072] "
                f"W2[3072,800]: max_abs_err {err:.3e} tol {tol:.3e} "
                f"({why}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused MLP kernel disagrees: {err}")
            worst[DTYPES[dtype]] = max(worst[DTYPES[dtype]], err)
    return worst


def ln_params(gen, cols=800):
    """f32 LayerNorm scale and bias no bf16 value holds: scales near 1,
    biases of order 1 (as a trained checkpoint's)."""
    w = 1 + 0.05 * torch.randn(cols, device="cuda", generator=gen)
    return w, 0.5 * torch.randn(cols, device="cuda", generator=gen)


def check_layer_norm(ln, gen):
    """Worst error of the bf16 LayerNorm kernel against its plain version,
    with f32 parameters and in its affine-free form (the folded model's,
    phase 10), at the decode's, training's and eval's rows and three
    other widths: (with parameters, affine-free)."""
    rows = [(m, 800) for m in [2 * 360, 2 * 48, 3, 257]
            + [DISPATCH * n for n in (360, 240, 120, 48)]
            + [TRAIN_BATCH * n for n in (360, 240, 120)]
            + [b * n for b in eval_batches() for n in (360, 240, 120, 48)]]
    worst = [0.0, 0.0]
    for m, cols in rows + [(5, 64), (3, 1024), (4, 2)]:
        x = (torch.randn(m, cols, device="cuda", generator=gen) * 2
             + 0.5).bfloat16()
        for form, (w, b) in enumerate((ln_params(gen, cols), (None, None))):
            got = ln.layer_norm(x, w, b, 1e-5)
            torch.cuda.synchronize()
            want = ln.layer_norm_reference(x, w, b, 1e-5)
            err = (got.float() - want.float()).abs()
            # 1 bf16 ulp of each output (floored at the ulp of 2^-8, below
            # which the two sides' f32 sums, not bf16, rule): both take f32
            # statistics in another order and round once.
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -8))) - 7)
            ulps = (err / ulp).max().item()
            ok = (ulps <= 1.0 and got.shape == want.shape
                  and got.dtype == x.dtype)
            what = "f32 scale/bias" if w is not None else "affine-free"
            log(f"layer_norm bf16 x[{m},{cols}] {what}: max_abs_err "
                f"{err.max().item():.3e}, {ulps:.2f} ulps of the output (tol"
                f" 1 bf16 ulp: f32 statistics in another order, one "
                f"rounding) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"layer_norm kernel ({what}) disagrees:"
                                     f" {ulps} ulps")
            worst[form] = max(worst[form], err.max().item())
    return tuple(worst)


def reset_launches():
    """Every kernel's launch count to 0."""
    from mint_tpu_torch.ops import attention, layer_norm, mlp
    attention.launches = mlp.launches = layer_norm.launches = 0
    attention.backward_launches = layer_norm.affine_free_launches = 0


def launch_counts():
    """Every kernel's launches since the last :func:`reset_launches` (the
    attention backward kernels': their calls, two launches each)."""
    from mint_tpu_torch.ops import attention, layer_norm, mlp
    return {"attention": attention.launches,
            "attention_backward": attention.backward_launches,
            "fused_mlp": mlp.launches, "layer_norm": layer_norm.launches,
            "layer_norm_affine_free": layer_norm.affine_free_launches}


def expected_launches(forwards: int, bf16: bool, folded: bool = False,
                      backwards: int = 0):
    """Launches of `forwards` flagship forwards: 16 blocks of attention and
    MLP each, and in bf16 two LayerNorms a block, in the affine-free form
    where the model's LayerNorm affines are folded (phase 10); and of the
    `backwards` of them that were differentiated, in bf16 compute 16
    calls of the attention backward kernels each (f32 differentiates the
    plain formula)."""
    norms = 32 * forwards if bf16 else 0
    return {"attention": 16 * forwards,
            "attention_backward": 16 * backwards if bf16 else 0,
            "fused_mlp": 16 * forwards,
            "layer_norm": 0 if folded else norms,
            "layer_norm_affine_free": norms if folded else 0}


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one fn() call in us: what it costs the host to
    check its inputs and enqueue its launches (the queue holds them all,
    so the loop never waits for the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / iters


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 on
# the tensor cores, f32 on the FMA pipes (the f32 kernels' exact-f32
# route), TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak: str):
    """Least time (ms) the card could take: the larger of the flops over
    the peak rate and the bytes (each input read once, each output
    written once) over HBM's rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def attention_work(b, h, nq, nk, d, elem):
    """(flops, bytes) of attention: Q.K^T and P.V, q/k/v in, out out."""
    return 4.0 * b * h * nq * nk * d, elem * b * h * d * (2 * nq + 2 * nk)


def attention_backward_work(b, h, nq, nk, d):
    """(flops, bytes) of the attention backward: the five products Q.K^T,
    dO.V^T, P^T.dO, dS.K and dS^T.Q; q, k, v and dO read once, dq, dk and
    dv written once (bf16)."""
    return 10.0 * b * h * nq * nk * d, 2 * b * h * d * (3 * nq + 4 * nk)


def mlp_work(m, h, f, o, elem):
    """(flops, bytes) of the fused MLP: x, W1, b1, W2, b2 in, out out."""
    return (2.0 * m * (h * f + f * o),
            elem * (m * h + h * f + f + f * o + o + m * o))


def time_kernels(att, mlp, ln, gen, card, batch, attn_shapes, mlp_rows,
                 host=True, heads=10, width=3072, backward=False):
    """Kernel, plain version and, for attention, one PyTorch call
    (F.scaled_dot_product_attention, the yardstick: the port never calls
    it) at `batch` and the given shapes (attention's (Nq, Nk), the MLP's
    and the bf16 LayerNorm's rows per sample), with each one's bound and,
    if `host`, the host's cost of a call.  `heads` and `width` are the
    attention's heads and the MLP's hidden width (a tensor-parallel
    rank's: 5 and 1536 at model = 2); the bf16 LayerNorm, never split, is
    timed at the full ones only.  With `backward`, the bf16 attention
    backward kernels too, on the model's views at each Nq = Nk, beside the
    plain VJP they replaced and the PyTorch call's backward.  Returns
    {(kernel, dtype name): {Nq or rows: row}} for the summary line."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def backend_of(q, k, v):
        """The backend PyTorch's dispatcher picks for these inputs."""
        try:
            return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=SCALE))
        except (AttributeError, RuntimeError, TypeError, ValueError):
            return None

    def time_backward(nq):
        """The "attention_backward" row at q[batch,heads,nq,80]."""
        q, k, v, do = _fused_grad(gen, batch, nq, heads, 80)

        def plain_vjp():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(
                att.attention_formula(*leaves, SCALE), leaves, do)

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=SCALE)
        t_k = cuda_ms(lambda: att._backward_call(q, k, v, do, SCALE))
        t_p = cuda_ms(plain_vjp)
        t_l = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                  retain_graph=True))
        backend = backend_of(*leaves)
        b_ms, b_by = bound(*attention_backward_work(batch, heads, nq, nq,
                                                    80), "bf16")
        shape = f"q[{batch},{heads},{nq},80]"
        log(f"time attention_backward bf16 {shape} (the model's views): "
            f"kernels {t_k:.4f} ms, plain VJP {t_p:.4f} ms, SDPA backward "
            f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({card})")
        return {"shape": shape, "ms": t_k, "plain_ms": t_p,
                "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                "library": f"scaled_dot_product_attention backward "
                           f"{backend.name if backend else 'unknown'}"}

    summary = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = DTYPES[dtype]
        elem = torch.empty((), dtype=dtype).element_size()
        for nq, nk in attn_shapes:
            q = torch.randn(batch, heads, nq, 80, device="cuda",
                            generator=gen).to(dtype)
            k = torch.randn(batch, heads, nk, 80, device="cuda",
                            generator=gen).to(dtype)
            v = torch.randn_like(k)
            t_k = cuda_ms(lambda: att.attention(q, k, v, SCALE))
            t_p = cuda_ms(lambda: att.attention_reference(q, k, v, SCALE))
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=SCALE))
            backend = backend_of(q, k, v)
            named = ""
            if backend is not None:
                with sdpa_kernel(backend):
                    t_b = cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=SCALE))
                named = f" (under sdpa_kernel({backend.name}) {t_b:.4f})"
            flops, nbytes = attention_work(batch, heads, nq, nk, 80, elem)
            b_ms, b_by = bound(flops, nbytes, name)
            row = {"shape": f"q[{batch},{heads},{nq},80] k[{batch},{heads},"
                            f"{nk},80]", "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                   "library": f"scaled_dot_product_attention "
                              f"{backend.name if backend else 'unknown'}"}
            extra = ""
            if dtype == torch.float32:
                # The tensor cores' floor for f32 by a 3xTF32 split (for
                # the log only: the kernel runs on the FMA pipes).
                extra = (f", 3xTF32 floor "
                         f"{1e3 * 3 * flops / PEAK_FLOPS['tf32']:.4f} ms")
            hosted = ""
            if host:
                row["host_us"] = host_us(
                    lambda: att.attention(q, k, v, SCALE))
                hosted = f"; host {row['host_us']:.1f} us a call"
            log(f"time attention {name} {row['shape']}: kernel {t_k:.4f} ms,"
                f" plain {t_p:.4f} ms, SDPA {t_l:.4f} ms{named}, bound "
                f"{b_ms:.4f} ms ({b_by}){extra}{hosted} ({card})")
            summary.setdefault(("attention", name), {})[nq] = row
            if backward and dtype == torch.bfloat16 and nq == nk:
                summary.setdefault(("attention_backward", name), {})[nq] = (
                    time_backward(nq))
        w1, b1, w2, b2 = mlp_weights(gen, dtype, f=width)
        for rows in mlp_rows:
            m = batch * rows
            x = torch.randn(m, 800, device="cuda", generator=gen).to(dtype)
            t_k = cuda_ms(lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
            t_p = cuda_ms(lambda: mlp.mlp_reference(x, w1, b1, w2, b2))
            b_ms, b_by = bound(*mlp_work(m, 800, width, 800, elem), name)
            shape = f"x[{m},800]" + (f" F={width}" if width != 3072 else "")
            row = {"shape": shape, "ms": t_k, "plain_ms": t_p,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            hosted = ""
            if host:
                row["host_us"] = host_us(
                    lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
                hosted = f"; host {row['host_us']:.1f} us a call"
            log(f"time fused_mlp {name} {shape}: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no "
                f"single library call{hosted} ({card})")
            summary.setdefault(("fused_mlp", name), {})[rows] = row
    # The LayerNorm kernel takes bf16 rows with f32 parameters.  No single
    # PyTorch call computes that on the card: layer_norm refuses the mixed
    # dtypes, so the plain version casts in and out (three launches).  Its
    # affine-free form (the folded model's) has one: layer_norm of the
    # bf16 rows with no parameters, statistics in f32 and the output
    # rounded to bf16 once, the same function.
    w, b = ln_params(gen)
    for rows in (mlp_rows if (heads, width) == (10, 3072) else ()):
        m = batch * rows
        x = torch.randn(m, 800, device="cuda", generator=gen).bfloat16()
        for key, params in (("layer_norm", (w, b)),
                            ("layer_norm_affine_free", (None, None))):
            t_k = cuda_ms(lambda: ln.layer_norm(x, *params, 1e-5))
            t_p = cuda_ms(lambda: ln.layer_norm_reference(x, *params, 1e-5))
            t_l = (None if params[0] is not None else cuda_ms(
                lambda: F.layer_norm(x, (800,), eps=1e-5)))
            # Read x (and the scale and bias) once, write the output once;
            # about 8 f32 operations an element (sum, deviation, square,
            # scale; the affine's two more are of the same order).
            b_ms, b_by = bound(8.0 * m * 800, 2 * 2 * m * 800 + (
                2 * 4 * 800 if params[0] is not None else 0), "f32")
            row = {"shape": f"x[{m},800]", "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by}
            if t_l is not None:
                row["library"] = "layer_norm (bf16, no parameters)"
            hosted = ""
            if host:
                row["host_us"] = host_us(
                    lambda: ln.layer_norm(x, *params, 1e-5))
                hosted = f"; host {row['host_us']:.1f} us a call"
            what = ("f32 scale/bias, no single library call"
                    if t_l is None else f"affine-free, library layer_norm "
                                        f"{t_l:.4f} ms")
            log(f"time layer_norm bf16 x[{m},800] {what}: kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                f"{hosted} ({card})")
            summary.setdefault((key, "bf16"), {})[rows] = row
    return summary


# -- phase 3: the server ---------------------------------------------------

def flagship(dtype, device, compute_dtype=None, is_training=False):
    """The flagship FACT with the weights of a CPU generator seeded 0 (the
    same on every device)."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = builder.build(cfg, is_training=is_training, dtype=dtype,
                          device=device, compute_dtype=compute_dtype)
    return init_params(model, torch.Generator().manual_seed(0))


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return buf.getvalue()


def _post(url: str, body: bytes) -> np.ndarray:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def serve_requests(model, dtype_name):
    """Concurrent HTTP requests: three that co-batch in the 128-steps
    bucket and one in the 256-steps bucket.  Returns each kernel's launches
    in this run and the server's decode steps."""
    from mint_tpu_torch.serving import GenerationService, serve

    from mint_tpu_torch.utils import graphs

    service = GenerationService(model, batch_window_ms=500.0, max_batch=8,
                                default_steps=128, steps_bucket=128)
    # The server's warm-up of both buckets (3 co-batched requests, padded
    # to 4, of 128 steps; one of 256) captures their decode graphs, so the
    # requests below capture nothing.
    warm = service.warmup(steps=128, batch=3) + service.warmup(steps=256)
    cache = graphs.of(model)
    warm_captures = cache.captures
    before = service.stats_snapshot()
    server = serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(1)
    audio_seq = model.audio_seq_length
    # (frames the audio allows, requested steps) -> steps' = min of them.
    asks = [(64, 128), (100, 128), (128, 128), (300, 140)]
    bodies = [_npy(rng.standard_normal((n + audio_seq - 1, 35)) * 0.5)
              for n, _ in asks]
    seed = _npy(rng.standard_normal((model.motion_seq_length, 225)) * 0.1)
    results = [None] * len(asks)
    errors = []

    def call(i):
        try:
            body = bodies[i] + (seed if i == 0 else b"")
            results[i] = _post(f"{url}/generate?steps={asks[i][1]}", body)
        except Exception as e:  # re-raised below
            errors.append(e)

    try:
        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(asks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"requests failed: {errors}")
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = {k: v - before[k] for k, v in json.loads(r.read())
                     .items()}
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    for (n, steps), out in zip(asks, results):
        want = (min(n, steps), 225)
        if out.shape != want or not np.isfinite(out).all():
            raise AssertionError(f"bad result {out.shape} (want {want}), "
                                 f"finite={np.isfinite(out).all()}")
    n_blocks = sum(len(list(m.children())) for m in (
        model.motion_transformer, model.audio_transformer,
        model.cross_modal_layer.transformer))
    if n_blocks != 16:
        raise AssertionError(f"the flagship has {n_blocks} blocks, not 16")
    expect = expected_launches(stats["decode_steps"], dtype_name == "bf16")
    log(f"server {dtype_name}: warm-up of both buckets {warm:.1f} s, "
        f"{warm_captures} graph(s) captured; {len(asks)} requests answered "
        f"in {seconds:.3f} s with {cache.captures - warm_captures} more "
        f"captures; shapes {[r.shape for r in results]} all finite; stats "
        f"of the requests {stats}; healthz {health['status']} "
        f"({cache.summary()})")
    if (stats["requests"] != len(asks) or stats["batches"] != 2
            or stats["decode_steps"] != 128 + 256):
        raise AssertionError(f"requests did not co-batch as expected: "
                             f"{stats}")
    if warm_captures != 2 or cache.captures != warm_captures:
        raise AssertionError(f"server {dtype_name}: {warm_captures} graphs "
                             f"captured by the warm-up (want 2), "
                             f"{cache.captures - warm_captures} by the "
                             f"requests (want 0)")
    log(f"server {dtype_name}: launches {launches} == {expect} (16 blocks, "
        f"32 LayerNorms in bf16, x {stats['decode_steps']} decode steps)")
    if launches != expect:
        raise AssertionError(f"server {dtype_name}: launches {launches}, "
                             f"expected {expect}")
    return launches, stats["decode_steps"]


# -- phase 4: card against CPU --------------------------------------------

CARD_VS_CPU_STEPS = 60  # phase 4's decode, card against CPU


def _card_vs_cpu_inputs():
    rng = np.random.default_rng(2)
    motion = rng.standard_normal((1, 120, 225)).astype(np.float32) * 0.1
    audio = rng.standard_normal((1, 240, 35)).astype(np.float32) * 0.5
    decode_audio = rng.standard_normal(
        (1, CARD_VS_CPU_STEPS + 239, 35)).astype(np.float32) * .5
    return motion, audio, decode_audio


def cpu_reference(state):
    """Phase 4's CPU side, from the card model's weights `state` (on the
    host): the flagship's f32 forward and 60-step decode on the CPU.  It
    touches no CUDA, so it runs in a thread beside phase 3's server."""
    from mint_tpu_torch.infer import decoder

    model_cpu = flagship(torch.float32, "cpu")
    model_cpu.load_state_dict(state)
    motion, audio, decode_audio = _card_vs_cpu_inputs()
    with torch.inference_mode():
        forward = model_cpu({"motion_input": torch.from_numpy(motion),
                             "audio_input": torch.from_numpy(audio)})
    decode = decoder.infer_auto_regressive(
        model_cpu, {"motion_input": motion, "audio_input": decode_audio},
        steps=CARD_VS_CPU_STEPS)
    return forward, decode


def card_vs_cpu(model_cuda, reference):
    """Phase 4: the card's forward and decode against the CPU's
    (`reference`, a Future of cpu_reference)."""
    from mint_tpu_torch.infer import decoder

    motion, audio, decode_audio = _card_vs_cpu_inputs()
    with torch.inference_mode():
        got = model_cuda({"motion_input": torch.from_numpy(motion).cuda(),
                          "audio_input": torch.from_numpy(audio).cuda()})
    want, want_decode = reference.result()
    err = (got.cpu() - want).abs().max().item()
    tol = 1e-4
    log(f"forward f32 batch 1 card vs CPU: out {tuple(got.shape)}, max_abs_err"
        f" {err:.3e} (peak {want.abs().max().item():.3e}) tol {tol:.0e} "
        "(f32 through 16 blocks; every matmul and LayerNorm sums in another "
        "order on the card)")
    if not err <= tol:
        raise AssertionError(f"card and CPU forwards disagree: {err}")

    # One 60-step decode: its first 3 frames are held to the tolerance;
    # the drift over all 60 is recorded.  The f32 attention and MLP kernels
    # stay exact f32 on the FMA pipes (no TF32), so the drift comes from
    # summation order only: every sum runs in another order than the CPU's.
    steps, held = CARD_VS_CPU_STEPS, 3
    inputs = {"motion_input": motion, "audio_input": decode_audio}
    got = decoder.infer_auto_regressive(model_cuda, inputs, steps=steps)
    want = want_decode
    per_step = (got.cpu() - want).abs().amax(dim=(0, 2))
    err = per_step[:held].max().item()
    tol = 1e-3
    log(f"decode f32 batch 1, {held} steps, card vs CPU: max_abs_err "
        f"{err:.3e} tol {tol:.0e} (the forward's tolerance, amplified by "
        "feeding each frame back)")
    if not err <= tol:
        raise AssertionError(f"card and CPU decodes disagree: {err}")
    marks = [s for s in (1, 3, 10, 30, 60) if s <= steps]
    log(f"decode f32 batch 1, {steps} steps, card vs CPU drift: max_abs_err "
        f"{per_step.max().item():.3e} over {steps} steps (peak frame value "
        f"{want.abs().max().item():.3e}); max up to step "
        + ", ".join(f"{s}: {per_step[:s].max().item():.3e}" for s in marks))


# -- phase 5: throughput ----------------------------------------------------

def throughput(model, dtype_name, card):
    from mint_tpu_torch.infer import decoder

    rng = np.random.default_rng(0)
    audio_len = THROUGHPUT_STEPS + model.audio_seq_length - 1
    inputs = {
        "motion_input": torch.from_numpy(rng.standard_normal(
            (DISPATCH, 120, 225)).astype(np.float32)).cuda(),
        "audio_input": torch.from_numpy(rng.standard_normal(
            (DISPATCH, audio_len, 35)).astype(np.float32)).cuda(),
    }
    # Warm-up, and the capture of this key's decode graph (the key holds
    # the audio the steps read: the warm-up takes as many steps).
    decoder.infer_auto_regressive(model, inputs, steps=THROUGHPUT_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decoder.infer_auto_regressive(model, inputs,
                                        steps=THROUGHPUT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise AssertionError("throughput decode produced non-finite frames")
    rate = DISPATCH * THROUGHPUT_STEPS / seconds
    log(f"decode {dtype_name} batch {DISPATCH} x {THROUGHPUT_STEPS} steps: "
        f"{seconds:.4f} s, {rate:.2f} frames/s, "
        f"{1000 * seconds / THROUGHPUT_STEPS:.3f} ms/step ({card})")
    return rate


# -- phase 5b: the decode's graph against its uncaptured body ---------------

GRAPH_STEPS = 60          # decode steps compared, graph against body
GRAPH_BATCHES = (4, 20)   # the server's small batch and bench.py's


def decode_graphs(models, card):
    """The flagship's decode at each batch of GRAPH_BATCHES over
    GRAPH_STEPS steps, in each model's dtype: the step body uncaptured on
    fresh static tensors, then through infer_auto_regressive (the model's
    cached graph for the key: eager at its first step, captured at its
    second, replayed after), then again (every step a replay).  The frames
    must be equal bit for bit, and the launches counted through capture
    and replays must be the body's.  Returns {(dtype, batch): {"graphed":
    frames/s, "uncaptured": frames/s}} of the timed calls, and {(kernel,
    dtype): launches a step} of the batch-20 call whose every step is a
    replay."""
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.utils import graphs

    rates, per_step = {}, {}
    for model, name in models:
        bf16 = name == "bf16"
        for b in GRAPH_BATCHES:
            rng = np.random.default_rng(b)
            inputs = {"motion_input": torch.from_numpy(rng.standard_normal(
                          (b, 120, 225)).astype(np.float32) * 0.5).cuda(),
                      "audio_input": torch.from_numpy(rng.standard_normal(
                          (b, GRAPH_STEPS + 239, 35)).astype(np.float32)
                          * 0.5).cuda()}
            runs, counts = [], []
            for graphed in (False, True, True):
                cache = graphs.of(model)
                captures, seconds0 = cache.captures, cache.seconds
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = decoder._decode(model, inputs, GRAPH_STEPS, None,
                                      decoder.DECODE_LAST_BLOCK_ROWS,
                                      graphed=graphed)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                runs.append((out, seconds, cache.captures - captures,
                             cache.seconds - seconds0))
                counts.append(launch_counts())
            (body, t_body, _, _), (first, t_first, n_cap, t_cap), \
                (again, t_again, n_again, _) = runs
            same = torch.equal(body, first) and torch.equal(body, again)
            expect = expected_launches(GRAPH_STEPS, bf16)
            rates[name, b] = {"uncaptured": b * GRAPH_STEPS / t_body,
                              "graphed": b * GRAPH_STEPS / t_again}
            if b == DISPATCH:
                for kernel, n in counts[2].items():
                    per_step[kernel, name] = n / GRAPH_STEPS
            log(f"decode graph {name} batch {b} x {GRAPH_STEPS} steps: "
                f"graphed frames equal to the uncaptured body's bit for bit:"
                f" {same}; launches uncaptured {counts[0]}, graphed (first "
                f"call: 1 eager step, capture, {GRAPH_STEPS - 1} replays) "
                f"{counts[1]}, again ({GRAPH_STEPS} replays) {counts[2]}, "
                f"want {expect}; captures {n_cap} in {t_cap:.3f} s, then "
                f"{n_again}; uncaptured {t_body:.4f} s "
                f"{rates[name, b]['uncaptured']:.2f} frames/s, graphed first"
                f" call {t_first:.4f} s, again {t_again:.4f} s "
                f"{rates[name, b]['graphed']:.2f} frames/s "
                f"({graphs.of(model).summary()}) ({card})")
            if (not same or any(c != expect for c in counts) or n_cap != 1
                    or n_again != 0):
                raise AssertionError(f"decode graph {name} batch {b}: equal "
                                     f"{same}, launches {counts}, captures "
                                     f"{n_cap}, {n_again}")
    return rates, per_step


# -- phase 6: training ------------------------------------------------------

def train_batch(b, device, seed):
    """A training batch of the flagship's shapes from numpy: motion and
    audio windows and a 20-frame target."""
    rng = np.random.default_rng(seed)
    shapes = {"motion_input": (b, 120, 225), "audio_input": (b, 240, 35),
              "target": (b, 20, 225)}
    return {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32)
                                * 0.5).to(device)
            for k, v in shapes.items()}


def train_gradients():
    """One forward and backward of the flagship through Trainer on the card
    and on the CPU with the same weights and batch: in f32 every gradient
    compared, in bf16 compute every gradient present and finite; 16
    launches of each kernel per forward."""
    from mint_tpu_torch.train import Trainer, schedules

    def grads(model, batch):
        trainer = Trainer(model, schedules.constant(0.0))
        params = trainer.init_state(model).params
        reset_launches()
        loss, g = trainer.loss_and_grads(params, batch)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        counts = launch_counts()
        if set(g) != set(params):
            raise AssertionError(f"parameters without a gradient: "
                                 f"{sorted(set(params) - set(g))}")
        return float(loss), g, counts

    batch = train_batch(2, "cpu", seed=3)
    card = flagship(torch.float32, "cuda", is_training=True)
    loss, g_card, counts = grads(card, {k: v.cuda() for k, v in
                                        batch.items()})
    loss_cpu, g_cpu, _ = grads(flagship(torch.float32, "cpu",
                                        is_training=True), batch)
    rel = abs(loss - loss_cpu) / abs(loss_cpu)
    worst_name, worst = None, 0.0
    for name, want in g_cpu.items():
        peak = want.abs().max().item()
        err = (g_card[name].cpu() - want).abs().max().item()
        ratio = err / peak if peak > 0 else err
        if ratio > worst:
            worst_name, worst = name, ratio
    log(f"train f32 batch 2 card vs CPU: loss {loss:.6f} vs {loss_cpu:.6f} "
        f"(rel {rel:.2e}, tol 1e-5); all {len(g_card)} parameters have a "
        f"gradient on the card; worst gradient error {worst:.2e} of its "
        f"leaf's peak ({worst_name}; tol 1e-4: f32 sums in another order "
        f"through 16 blocks and back); launches per forward {counts}")
    if not rel <= 1e-5 or not worst <= 1e-4:
        raise AssertionError("card and CPU gradients disagree")
    expect = expected_launches(1, bf16=False)
    if counts != expect:
        raise AssertionError(f"launches per forward {counts}, want {expect}")
    del card, g_card
    torch.cuda.empty_cache()

    mixed = flagship(torch.float32, "cuda", compute_dtype=torch.bfloat16,
                     is_training=True)
    loss16, g16, counts16 = grads(mixed, {k: v.cuda()
                                          for k, v in batch.items()})
    bad = [k for k, v in g16.items()
           if v.dtype != torch.float32 or not torch.isfinite(v).all()]
    # Against the CPU's f32 gradients: all of them as one vector, and each
    # leaf on its own, so that a fault in one family of leaves (one bf16
    # GEMM of a backward) cannot hide behind the large leaves' norm.
    sq_err = {k: float(((g16[k].cpu() - g) ** 2).sum())
              for k, g in g_cpu.items()}
    sq_ref = {k: float((g ** 2).sum()) for k, g in g_cpu.items()}
    rel16 = math.sqrt(sum(sq_err.values()) / sum(sq_ref.values()))
    per_leaf = {k: math.sqrt(sq_err[k] / sq_ref[k]) if sq_ref[k] > 0
                else math.sqrt(sq_err[k]) for k in g_cpu}
    worst16 = max(per_leaf, key=per_leaf.get)
    median16 = float(np.median(list(per_leaf.values())))
    log(f"train bf16 compute (f32 parameters) batch 2 on the card: loss "
        f"{loss16:.6f}, all {len(g16)} gradients present, f32 and finite: "
        f"{not bad}; against the CPU's f32 gradients: relative L2 of all "
        f"{rel16:.3e}, of each leaf median {median16:.3e}, worst "
        f"{per_leaf[worst16]:.3e} ({worst16}) (tol 0.1 for all and for "
        f"each leaf: bf16 rounding, 8 significant bits, through 16 blocks "
        f"and back; a wrong GEMM gives an error of order 1); launches per "
        f"forward {counts16}")
    if (bad or counts16 != expected_launches(1, bf16=True, backwards=1)
            or not math.isfinite(loss16)
            or not rel16 <= 0.1 or not per_leaf[worst16] <= 0.1):
        raise AssertionError(f"bf16 training gradients: bad {bad}, "
                             f"relative L2 {rel16}, worst leaf {worst16} "
                             f"{per_leaf[worst16]}, launches {counts16}")
    del mixed, g16
    torch.cuda.empty_cache()


STEPS_PER_LOOP = 10  # the train CLI's default --steps_per_loop


def train_graphs(card):
    """Training through the step's graph against the uncaptured body, on
    the full flagship at batch 32: f32, and bf16 compute with two
    micro-batches a update (both bodies), each with a clip that bites and a
    warm-up schedule, 2 x STEPS_PER_LOOP steps from one state as two
    fused windows (Trainer.train_steps).  Between the windows the graphed
    side's state is saved and restored (new tensors: its graphs are
    dropped and captured anew); the uncaptured side runs on.  Every
    parameter and moment must be equal bit for bit, and the launches
    counted through captures and replays 16 a step (32 LayerNorms in
    bf16)."""
    from mint_tpu_torch.train import CheckpointManager, Trainer, schedules
    from mint_tpu_torch.utils import graphs

    for name in ("f32", "bf16"):
        bf16 = name == "bf16"
        model = flagship(torch.float32, "cuda", is_training=True,
                         compute_dtype=torch.bfloat16 if bf16 else None)
        k = 2 if bf16 else 1
        sides = []
        for graphed in (True, False):
            trainer = Trainer(model, schedules.manual_stepping(
                [4], [1e-4, 1e-3], warmup=True), grad_clip_norm=0.5,
                accumulate_steps=k)
            trainer._graphed = graphed
            sides.append([trainer, trainer.init_state(model)])
        windows = [sides[0][0].stack_batches(
            [{k2: v.numpy() for k2, v in train_batch(
                TRAIN_BATCH, "cpu", seed=100 * w + i).items()}
             for i in range(STEPS_PER_LOOP)]) for w in range(2)]
        cache = graphs.of(model)
        captures, t_cap = cache.captures, cache.seconds
        counts = {}
        with tempfile.TemporaryDirectory() as tmp:
            for w, stacked in enumerate(windows):
                for graphed, side in zip((True, False), sides):
                    reset_launches()
                    t0 = time.perf_counter()
                    side[1], metrics = side[0].train_steps(side[1], stacked)
                    loss = float(metrics["loss"])
                    torch.cuda.synchronize()
                    counts[w, graphed] = (launch_counts(), loss,
                                          time.perf_counter() - t0)
                if w == 0:  # save and restore the graphed side
                    manager = CheckpointManager(tmp)
                    manager.save(STEPS_PER_LOOP, sides[0][1], force=True)
                    restored = manager.restore(sides[0][1])
                    moved = all(t.data_ptr() != sides[0][1].params[key]
                                .data_ptr()
                                for key, t in restored.params.items())
                    sides[0][1] = restored
        n_cap = cache.captures - captures
        (_, a), (_, b) = sides
        trees = [("params", a.params, b.params),
                 ("mu", a.opt_state["mu"], b.opt_state["mu"]),
                 ("nu", a.opt_state["nu"], b.opt_state["nu"])]
        unequal = [f"{t}/{key}" for t, x, y in trees for key in x
                   if not torch.equal(x[key], y[key])]
        expect = expected_launches(STEPS_PER_LOOP, bf16,
                                   backwards=STEPS_PER_LOOP)
        bodies = 2 if k > 1 else 1
        micro = " (2 micro-batches an update)" if k > 1 else ""
        log(f"train graph {name}{micro} batch {TRAIN_BATCH}, 2 x "
            f"{STEPS_PER_LOOP} steps, restored between (new tensors: "
            f"{moved}): parameters and moments equal "
            f"to the uncaptured body's bit for bit: {not unequal} "
            f"({len(trees[0][1]) * 3} tensors; unequal {unequal[:4]}); step "
            f"counts {a.step} and {b.step}, Adam counts "
            f"{a.opt_state['count']} and {b.opt_state['count']}; losses "
            + ", ".join(f"window {w} {'graphed' if g else 'uncaptured'} "
                        f"{c[1]:.6f} in {c[2]:.2f} s, launches {c[0]}"
                        for (w, g), c in counts.items())
            + f"; want {expect} a window; {n_cap} captures in "
            f"{cache.seconds - t_cap:.3f} s ({cache.summary()}) ({card})")
        if (unequal or not moved or a.step != b.step
                or a.opt_state["count"] != b.opt_state["count"]
                or any(c[0] != expect for c in counts.values())
                or n_cap != 2 * bodies):
            raise AssertionError(f"train graph {name}: unequal {unequal[:8]}"
                                 f", launches {counts}, captures {n_cap}")
        del model, sides, a, b, restored, manager
        torch.cuda.empty_cache()


def write_corpus(data_dir, n_seq=32, length=300, shards=2):
    """A synthetic AIST-shaped corpus (219-dim motion, 35-dim audio, one
    sequence per Example) from np.random.default_rng(0), named as the
    flagship config's ``data_files`` expect.  Every motion frame is one
    fixed pose plus noise (std 0.1), so there is something to learn: the
    loss falls within a few steps."""
    from mint_tpu_torch.data.example import encode_example
    from mint_tpu_torch.data.tfrecord import TFRecordWriter

    rng = np.random.default_rng(0)
    pose = rng.standard_normal(219)
    os.makedirs(data_dir, exist_ok=True)
    for shard in range(shards):
        path = os.path.join(data_dir, f"aist_tfrecord-train-"
                                      f"{shard:05d}-of-{shards:05d}")
        with TFRecordWriter(path) as w:
            for i in range(shard, n_seq, shards):
                motion = (pose + 0.1 * rng.standard_normal((length, 219))
                          ).astype(np.float32)
                audio = rng.standard_normal((length, 35)).astype(np.float32)
                w.write(encode_example({
                    "motion_sequence": motion.ravel(),
                    "motion_sequence_shape": np.asarray(motion.shape,
                                                        np.int64),
                    "motion_name": [f"gSY_sBM_cAll_d01_m{i:03d}_ch01"],
                    "audio_sequence": audio.ravel(),
                    "audio_sequence_shape": np.asarray(audio.shape,
                                                       np.int64),
                    "audio_name": [f"m{i:03d}"],
                }))


def run_module(module, args, cwd):
    """``python -m module args`` from `cwd` with the repo on the path;
    returns its stdout, stderr and wall seconds, raising if it fails."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr, seconds


def logged_launches(stderr, what):
    """The kernel launch counts a CLI logged ("kernel launches: {...}")."""
    found = re.findall(r"kernel launches: (\{.*\})", stderr)
    if not found:
        raise AssertionError(f"the {what} reported no kernel launches")
    return json.loads(found[-1])


def run_train_cli(work, model_dir, steps, bf16, backend):
    """One invocation of the port's train CLI with `backend` as its
    ``--input_backend``, run from `work` (where the config's relative
    data_files finds ./data); returns its launch counts and stderr."""
    args = [f"--config_path={CONFIG}", f"--model_dir={model_dir}",
            f"--steps={steps}", "--steps_per_loop=2",
            "--checkpoint_interval=3", "--summary_interval=1",
            f"--input_backend={backend}"]
    if bf16:
        args.append("--use_bfloat16")
    _, err, seconds = run_module("mint_tpu_torch.tools.train", args, work)
    return logged_launches(err, "train CLI"), err, seconds


#: The line each input backend of the train CLI logs (and no other does).
BACKEND_LOG = {"python": "input: the Python pipeline",
               "native": "input: the native loader",
               "device": "device-resident dataset"}


def train_cli(work, name, backend, run="run"):
    """The train CLI on the full flagship at batch 32 with input from
    `backend` ("python": the host pipeline; "native": the C++ loader;
    "device": the corpus resident on the card, windows drawn there): 4
    steps, then a second invocation that resumes at 4 and runs to 6, in
    the model_dir `work`/`run`.  Returns the first invocation's launch
    counts."""
    bf16 = name == "bf16"
    name = f"{name}, {backend} input"
    model_dir = os.path.join(work, run)

    def rows():
        with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def ckpts():
        return sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())

    counts, err, seconds = run_train_cli(work, model_dir, 4, bf16, backend)
    if [b for b, line in BACKEND_LOG.items() if line in err] != [backend]:
        raise AssertionError(f"train CLI {name}: input backend not used")
    first = rows()
    # Saves at step 1, then when 3 steps have elapsed (never, by step 4),
    # then the final forced save.
    if ckpts() != [1, 4] or [r["step"] for r in first] != [1, 3, 4]:
        raise AssertionError(f"train CLI {name}: checkpoints {ckpts()}, "
                             f"summaries at {[r['step'] for r in first]}")
    expect = expected_launches(4, bf16, backwards=4)
    if counts != expect:
        raise AssertionError(f"train CLI {name}: launches {counts}, want "
                             f"{expect} (16 a step, and 32 LayerNorms and "
                             f"16 attention backwards in bf16)")
    counts2, err2, seconds2 = run_train_cli(work, model_dir, 6, bf16,
                                            backend)
    every = rows()
    losses = [r["loss"] for r in every]
    resumed = "restored checkpoint at step 4" in err2
    log(f"train CLI {name} batch {TRAIN_BATCH}: steps 0-4 in {seconds:.1f} "
        f"s, launches {counts}; resumed at step 4: {resumed}, steps 4-6 in "
        f"{seconds2:.1f} s, launches {counts2}; checkpoints {ckpts()}; "
        f"losses by step {[(r['step'], round(r['loss'], 5)) for r in every]}"
        f"; steps_per_sec by step (metrics.jsonl) "
        f"{[(r['step'], r['steps_per_sec']) for r in every]}")
    if (not resumed or ckpts() != [1, 4, 6]
            or [r["step"] for r in every] != [1, 3, 4, 6]
            or counts2 != expected_launches(2, bf16, backwards=2)):
        raise AssertionError(f"train CLI {name} did not resume as expected")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train CLI {name}: losses {losses}")
    return counts


def train_rate(name, card, steps, mesh=None):
    """Train steps/s of Trainer.train_step at batch 32 on a batch resident
    on the card, after two warm-up steps (the first eager, the second the
    capture of the step's graph): each timed step a replay; with the
    launches of the timed steps and the peak device memory.  `mesh`: a
    world of one rank (phase 9c)."""
    from mint_tpu_torch.train import Trainer, schedules

    model = flagship(torch.float32, "cuda", is_training=True,
                     compute_dtype=torch.bfloat16 if name == "bf16" else None)
    trainer = Trainer(model, schedules.constant(1e-4), mesh=mesh)
    if mesh is not None:
        name = f"{name} (a world of one NCCL rank)"
    state = trainer.init_state(model)
    batch = train_batch(TRAIN_BATCH, "cuda", seed=4)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {name} batch {TRAIN_BATCH} x {steps} steps: {seconds:.4f} s, "
        f"{steps / seconds:.3f} steps/s, {1000 * seconds / steps:.2f} "
        f"ms/step, peak memory {peak:.2f} GiB, loss {loss:.5f}, launches "
        f"{counts} ({card})")
    if counts != expected_launches(steps, name.startswith("bf16"),
                                   backwards=steps) \
            or not math.isfinite(loss):
        raise AssertionError(f"train {name}: launches {counts}, loss {loss}")
    del model, trainer, state
    torch.cuda.empty_cache()
    return steps / seconds


# -- phase 7: the scoring path ----------------------------------------------

SEED_FRAMES = 120    # the flagship's motion window: the saved clips' seed
EVAL_BUCKET = 128    # the evaluate CLI's default --steps_bucket
SWEEP_BATCHES = (8, 16, 32, 64)
PROTOCOL_CLIPS = 40  # the scoring protocol: 40 clips of 1200 steps


def eval_clips():
    """(motion name, audio name, audio frames) of the synthetic eval
    corpus: the protocol's 40 of 1439 frames (1200 steps each: a full
    batch at the default cap of 32, then 8), three whose 300, 290 and 270
    steps share the 384-step bucket (a partial batch of 3, padded to 4),
    and one of 200 frames, which cannot fill the 240-frame audio window
    and is skipped."""
    steps = [1200] * PROTOCOL_CLIPS + [300, 290, 270] + [200 - 239]
    return [(f"gBR_sBM_cAll_d04_mBR{i}_ch{i:02d}", f"mBR{i}", n + 239)
            for i, n in enumerate(steps)]


def true_steps(audio_frames):
    return max(0, min(1200, audio_frames - 240 + 1))


def write_eval_corpus(data_dir, audio_dir):
    """The clips of :func:`eval_clips` as ``*_tfrecord-testval*`` shards
    (shard 0: the full-length clips and the short one; shard 1: the
    384-step bucket), one per Example, from np.random.default_rng(1): 150
    frames of 219-dim motion and 35-dim audio whose column 34 marks a beat
    every 30 frames at a phase of its own.  Each clip's audio features also
    go to ``audio_dir/{audio name}.npy``, the scorer's audio cache.
    Returns {motion name: audio features}."""
    from mint_tpu_torch.data.example import encode_example
    from mint_tpu_torch.data.tfrecord import TFRecordWriter

    rng = np.random.default_rng(1)
    os.makedirs(audio_dir, exist_ok=True)
    audio_of = {}
    clips = eval_clips()
    shards = [[c for c in clips if true_steps(c[2]) in (0, 1200)],
              [c for c in clips if 0 < true_steps(c[2]) < 1200]]
    for k, shard in enumerate(shards):
        path = os.path.join(data_dir, f"aist_tfrecord-testval-{k:05d}-of-"
                                      f"{len(shards):05d}")
        with TFRecordWriter(path) as w:
            for i, (motion_name, audio_name, n) in enumerate(shard):
                motion = rng.standard_normal((150, 219)).astype(np.float32)
                audio = rng.standard_normal((n, 35)).astype(np.float32)
                audio[:, 34] = (np.arange(n) + 7 * i) % 30 == 0
                np.save(os.path.join(audio_dir, f"{audio_name}.npy"), audio)
                audio_of[motion_name] = audio
                w.write(encode_example({
                    "motion_sequence": motion.ravel(),
                    "motion_sequence_shape": np.asarray(motion.shape,
                                                        np.int64),
                    "motion_name": [motion_name],
                    "audio_sequence": audio.ravel(),
                    "audio_sequence_shape": np.asarray(audio.shape,
                                                       np.int64),
                    "audio_name": [audio_name],
                }))
    return audio_of


def write_annotations(anno_dir, n_seq=80, frames=300):
    """An AIST++-layout annotation directory from np.random.default_rng(2):
    ``splits/crossmodal_{train,val,test}.txt`` (60 / 10 / 10 sequences and
    two more on ``ignore_list.txt``) and ``motions/*.pkl`` holding
    ``smpl_poses`` [T, 72], ``smpl_scaling`` [1] and ``smpl_trans`` [T, 3]
    (scaled units).  Poses are random walks, half of them with jumps, of
    a size of their own per sequence, and the translation moves at a speed
    of its own, so that every kinetic and geometric feature varies over the
    set (FID z-normalises by its spread)."""
    import pickle

    rng = np.random.default_rng(2)
    names = [f"g{g}_sBM_cAll_d{i % 30:02d}_m{g}{i % 6}_ch{i:02d}"
             for i, g in zip(range(n_seq + 2), ["BR", "PO", "LO", "MH"] * 99)]
    os.makedirs(os.path.join(anno_dir, "splits"))
    os.makedirs(os.path.join(anno_dir, "motions"))
    parts = {"train": names[:60], "val": names[60:70],
             "test": names[70:n_seq + 2]}
    for part, seqs in parts.items():
        with open(os.path.join(anno_dir, "splits",
                               f"crossmodal_{part}.txt"), "w") as f:
            f.write("\n".join(seqs))
    with open(os.path.join(anno_dir, "ignore_list.txt"), "w") as f:
        f.write("\n".join(names[n_seq:]))
    for i, name in enumerate(names):
        # Step sizes log-uniform over two decades; every other sequence
        # also jumps from frame to frame, as a random model's output does.
        walk = 10 ** rng.uniform(-3, -1) * rng.standard_normal((frames, 72))
        jumps = (i % 2) * 10 ** rng.uniform(-2, 0) * rng.standard_normal(
            (frames, 72))
        scaling = rng.uniform(80.0, 100.0, 1)
        speed = 10 ** rng.uniform(-1.5, 0.7)
        trans = (speed * rng.standard_normal((frames, 3))).cumsum(0) \
            + [0.0, scaling[0], 0.0]
        with open(os.path.join(anno_dir, "motions", f"{name}.pkl"),
                  "wb") as f:
            pickle.dump({"smpl_poses": walk.cumsum(0) + jumps,
                         "smpl_scaling": scaling, "smpl_trans": trans}, f)
    return names[:n_seq]


def dispatch_plan(clips, decode_batch):
    """(clips, pad clips, steps) of each decode dispatch the evaluator owes
    `clips`: buckets of true steps rounded up to EVAL_BUCKET (at most
    1200), at most `decode_batch` clips a dispatch, a partial one padded
    to the next power of two."""
    buckets = {}
    for _, _, n in clips:
        steps = true_steps(n)
        if steps:
            key = min(-(-steps // EVAL_BUCKET) * EVAL_BUCKET, 1200)
            buckets[key] = buckets.get(key, 0) + 1
    plan = []
    for steps, count in sorted(buckets.items()):
        for i in range(0, count, decode_batch):
            k = min(decode_batch, count - i)
            pad = min(1 << (k - 1).bit_length(), max(decode_batch, k)) - k
            plan.append((k, pad, steps))
    return plan


def eval_batches():
    """The decode batches phase 7's eval passes dispatch (power-of-two
    padded), and the evaluator's default, at which its kernels are timed:
    phase 2 checks the kernels at each."""
    from mint_tpu_torch.eval.evaluator import DECODE_BATCH

    return sorted({n + pad for n, pad, _ in dispatch_plan(eval_clips(),
                                                          DECODE_BATCH)}
                  | {DECODE_BATCH})


def run_eval_cli(cwd, model_dir, out_dir, bf16):
    """The port's evaluate CLI on the full flagship from `cwd` (whose
    ./data holds the config's ``*_tfrecord-testval*``): one pass over the
    latest checkpoint in `model_dir` at the default decode batch.  Returns
    its launch counts, its dispatches as (clips, pad clips, steps), the
    seconds of each (decode and copy to the host), the pass's line (clips,
    buckets, frames, wall seconds, generated frames / s) and the CLI's
    wall seconds."""
    args = [f"--config_path={CONFIG}", f"--model_dir={model_dir}",
            f"--output_dir={out_dir}", "--timeout=1", "--poll_seconds=0.5"]
    if bf16:
        args.append("--use_bfloat16")
    _, err, seconds = run_module("mint_tpu_torch.tools.evaluate", args, cwd)
    found = re.findall(r"decode batch=(\d+)\(\+(\d+) pad\) steps=(\d+): "
                       r"([\d.]+) s", err)
    dispatches = [(int(n), int(pad), int(steps)) for n, pad, steps, _ in
                  found]
    dispatch_seconds = [float(t) for *_, t in found]
    log(f"evaluate CLI: seconds per dispatch (decode and copy to the host) "
        f"{list(zip(dispatches, dispatch_seconds))}")
    passes = re.findall(r"eval pass done: (\d+) clip\(s\), (\d+) bucket\(s\)"
                        r", (\d+) frames generated in ([\d.]+) s wall, "
                        r"([\d.]+) frames/s", err)
    if len(passes) != 1:
        raise AssertionError(f"evaluate CLI: {len(passes)} passes, want 1:"
                             f"\n{err[-3000:]}")
    return (logged_launches(err, "evaluate CLI"), dispatches,
            dispatch_seconds, passes[0], seconds)


def check_clips(out_dir, clips, what):
    """One finite .npy of [120 + true steps, 225] per decodable clip."""
    want = {f"{m}_{a}.npy": true_steps(n) for m, a, n in clips
            if true_steps(n) > 0}
    got = sorted(os.listdir(out_dir))
    if got != sorted(want):
        raise AssertionError(f"{what}: clips {got}, want {sorted(want)}")
    for name, n in want.items():
        clip = np.load(os.path.join(out_dir, name))
        if clip.shape != (SEED_FRAMES + n, 225) or not np.isfinite(
                clip).all():
            raise AssertionError(f"{what}: {name} {clip.shape}, finite "
                                 f"{np.isfinite(clip).all()}")
    return want


def check_eval_launches(counts, dispatches, want_steps, name):
    """16 launches of attention and MLP per decode step, and in bf16 32 of
    the LayerNorm, pad rows included."""
    steps = sum(s for _, _, s in dispatches)
    expect = expected_launches(steps, name == "bf16")
    log(f"evaluate CLI {name}: dispatches (clips, pad, steps) {dispatches};"
        f" launches {counts} == {expect} ({steps} decode steps)")
    if steps != want_steps or counts != expect:
        raise AssertionError(f"evaluate CLI {name}: {steps} decode steps "
                             f"(want {want_steps}), launches {counts}, want "
                             f"{expect}")


def decode_sweep(model, card):
    """f32 decode frames/s of the flagship at each batch of SWEEP_BATCHES,
    SWEEP_STEPS steps replaying the decode's graph after a warm-up decode
    of as many steps that captures it (the key holds the audio the steps
    read), inputs from np.random.default_rng(0)."""
    from mint_tpu_torch.infer import decoder

    rng = np.random.default_rng(0)
    audio_len = SWEEP_STEPS + model.audio_seq_length - 1
    rates = {}
    for b in SWEEP_BATCHES:
        inputs = {"motion_input": torch.from_numpy(rng.standard_normal(
                      (b, 120, 225)).astype(np.float32)).cuda(),
                  "audio_input": torch.from_numpy(rng.standard_normal(
                      (b, audio_len, 35)).astype(np.float32)).cuda()}
        # Warm-up, and the capture of this key's decode graph.
        decoder.infer_auto_regressive(model, inputs, steps=SWEEP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decoder.infer_auto_regressive(model, inputs,
                                            steps=SWEEP_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not torch.isfinite(out).all():
            raise AssertionError(f"decode sweep batch {b}: non-finite")
        rates[b] = b * SWEEP_STEPS / seconds
        log(f"decode sweep f32 batch {b} x {SWEEP_STEPS} steps: "
            f"{seconds:.4f} s, {rates[b]:.2f} frames/s, "
            f"{1000 * seconds / SWEEP_STEPS:.3f} ms/step ({card})")
    best = max(rates, key=rates.get)
    log(f"decode sweep f32: fastest batch per frame {best} "
        f"({rates[best]:.2f} frames/s) ({card})")
    return rates


def protocol_rates(rates):
    """Generated frames/s over the protocol's 40 clips of 1200 steps at
    each cap of SWEEP_BATCHES: the dispatches the evaluator makes (full
    batches of the cap, the rest padded to a power of two), each at the
    sweep's rate for its padded batch; pad rows generate nothing."""
    clips = [("m", "a", 1200 + 239)] * PROTOCOL_CLIPS
    out = {}
    for cap in SWEEP_BATCHES:
        plan = dispatch_plan(clips, cap)
        seconds = sum((k + pad) * steps / rates[k + pad]
                      for k, pad, steps in plan)
        out[cap] = sum(k * steps for k, _, steps in plan) / seconds
    return out


def scoring_path(att, mlp, ln, gen, work, run_dir, card):
    """Phase 7: the eval corpus decoded by the evaluate CLI from the f32
    train CLI's checkpoint in `run_dir` (f32 in full, bf16 on the 384-step
    bucket), checked against a direct decode; ground-truth features by the
    extract_features CLI; FID_k, FID_g and Beat Alignment by the
    calculate_scores CLI, and the same scores on the card and on the CPU;
    the f32 decode batch sweep and the kernels at the eval's shapes.
    Returns ({(kernel, dtype): eval launches}, kernel rows)."""
    from mint_tpu_torch.eval import evaluator as ev_lib
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.tools import calculate_scores
    from mint_tpu_torch.train.checkpoint import CheckpointManager

    clips = eval_clips()
    audio_dir = os.path.join(work, "audio")
    audio_of = write_eval_corpus(os.path.join(work, "data"), audio_dir)
    short = [c for c in clips if 0 < true_steps(c[2]) < 1200]

    # (b) f32, every clip.
    out32 = os.path.join(work, "out_f32")
    counts32, disp32, secs32, pass32, wall32 = run_eval_cli(
        work, run_dir, out32, bf16=False)
    want = check_clips(out32, clips, "evaluate CLI f32")
    plan = dispatch_plan(clips, ev_lib.DECODE_BATCH)
    check_eval_launches(counts32, disp32, sum(s for _, _, s in plan), "f32")
    if sorted(disp32) != sorted(plan):
        raise AssertionError(f"evaluate CLI f32 dispatches {disp32}, want "
                             f"{plan}")
    log(f"evaluate CLI f32: {pass32[0]} clips in {pass32[1]} buckets, "
        f"{pass32[2]} frames generated in {pass32[3]} s of the pass's wall "
        f"time: {pass32[4]} frames/s, dispatched as (clips, pad, steps) "
        f"{plan} at the default cap {ev_lib.DECODE_BATCH} (the CLI's whole "
        f"run {wall32:.1f} s) ({card})")
    full = [d for d in disp32 if d[2] == 1200]
    seconds_full = sum(t for d, t in zip(disp32, secs32) if d[2] == 1200)
    log(f"evaluate CLI f32, the protocol's {PROTOCOL_CLIPS} clips of 1200 "
        f"steps alone: {PROTOCOL_CLIPS * 1200} frames in {seconds_full:.3f} "
        f"s of decode and copy ({full}): "
        f"{PROTOCOL_CLIPS * 1200 / seconds_full:.2f} generated frames/s "
        f"({card})")

    # The first bucket against a direct decode on the card from the same
    # restored weights.
    model = flagship(torch.float32, "cuda")
    model.load_state_dict(CheckpointManager(run_dir).restore_params(
        model.state_dict()))
    saved = [np.load(os.path.join(out32, f"{m}_{a}.npy")) for m, a, _ in
             short]
    n_max = max(true_steps(n) for _, _, n in short)
    audio = np.stack([np.pad(audio_of[m][:n_max + 239],
                             [[0, n_max + 239 - min(n, n_max + 239)], [0, 0]])
                      for m, _, n in short])
    direct = decoder.infer_auto_regressive(
        model, {"motion_input": np.stack([c[:SEED_FRAMES] for c in saved]),
                "audio_input": audio}, steps=n_max).cpu().numpy()
    held, worst, drift = 3, 0.0, 0.0
    for clip, row, (_, _, n) in zip(saved, direct, short):
        diff = np.abs(clip[SEED_FRAMES:] - row[:true_steps(n)]).max(axis=1)
        worst = max(worst, diff[:held].max())
        drift = max(drift, diff.max())
    log(f"evaluate CLI f32 vs a direct decode of its first bucket "
        f"({len(short)} clips at batch {len(short)}, the CLI's at "
        f"{len(short) + 1}): max_abs_err over the first {held} frames "
        f"{worst:.3e} tol 1e-3 (the card-vs-CPU decode tolerance: f32 sums "
        f"in another order at another batch); over all {n_max} frames "
        f"{drift:.3e}")
    if not worst <= 1e-3:
        raise AssertionError(f"evaluate CLI and direct decode disagree: "
                             f"{worst}")

    # (c) bf16, the 384-step bucket: its shard alone in a ./data of its own.
    short_dir = os.path.join(work, "short")
    os.makedirs(os.path.join(short_dir, "data"))
    shutil.copy(os.path.join(work, "data",
                             "aist_tfrecord-testval-00001-of-00002"),
                os.path.join(short_dir, "data",
                             "aist_tfrecord-testval-00000-of-00001"))
    # (d)'s extract_features CLI runs beside this one (its rate is logged,
    # not held to anything).
    anno = os.path.join(work, "anno")
    names = write_annotations(anno)
    feat = os.path.join(work, "features")
    with ThreadPoolExecutor(1) as pool:
        features = pool.submit(run_module,
                               "mint_tpu_torch.tools.extract_features",
                               [f"--anno_dir={anno}", f"--save_dir={feat}"],
                               work)
        out16 = os.path.join(work, "out_bf16")
        counts16, disp16, _, pass16, wall16 = run_eval_cli(
            short_dir, run_dir, out16, bf16=True)
        _, _, wall_feat = features.result()
    check_clips(out16, short, "evaluate CLI bf16")
    plan16 = dispatch_plan(short, ev_lib.DECODE_BATCH)
    check_eval_launches(counts16, disp16, sum(s for _, _, s in plan16),
                        "bf16")
    gap = max(np.abs(np.load(os.path.join(out16, f"{m}_{a}.npy"))
                     - np.load(os.path.join(out32, f"{m}_{a}.npy"))).max()
              for m, a, _ in short)
    log(f"evaluate CLI bf16: {pass16[0]} clips, {pass16[2]} frames generated"
        f" in {pass16[3]} s of the pass's wall time: {pass16[4]} frames/s "
        f"(the CLI's whole run {wall16:.1f} s); largest difference from the "
        f"f32 clips {gap:.3e} ({card})")

    # (d) ground-truth features (run beside (c)'s bf16 CLI).
    made = sorted(os.listdir(feat))
    if made != sorted(f"{n}_{k}.npy" for n in names
                      for k in ("kinetic", "manual")):
        raise AssertionError(f"extract_features wrote {len(made)} files")
    log(f"extract_features: {len(names)} sequences on the card in "
        f"{wall_feat:.1f} s")

    # (e) the scores, by the CLI.
    glob32 = os.path.join(out32, "*.npy")
    out, _, wall_cli = run_module(
        "mint_tpu_torch.tools.calculate_scores",
        [f"--result_files={glob32}", f"--feature_dir={feat}",
         f"--audio_cache_dir={audio_dir}"], work)
    fids = re.findall(r"Evaluation: FID_k: (\S+), FID_g: (\S+)", out)
    beats = re.findall(r"Beat Alignment Score: (\S+) over (\d+) clips", out)
    if not fids or not beats:
        raise AssertionError(f"calculate_scores printed:\n{out}")
    printed = [float(x) for x in (*fids[0], beats[0][0])]
    if not all(math.isfinite(x) for x in printed) or \
            int(beats[0][1]) != len(want):
        raise AssertionError(f"calculate_scores printed {fids} {beats}")
    log(f"calculate_scores CLI on the card: FID_k {printed[0]}, FID_g "
        f"{printed[1]}, Beat Alignment {printed[2]} over {beats[0][1]} "
        f"clips, in {wall_cli:.1f} s of wall time (the process included)")

    # (f) the card against the CPU.
    smpl_model = calculate_scores.load_model("")
    fk_worst = 0.0
    for name in want:
        motion = np.load(os.path.join(out32, name))[None, SEED_FRAMES:]
        fk_worst = max(fk_worst, float(np.abs(
            calculate_scores.joints_of(motion, smpl_model, "cuda")
            - calculate_scores.joints_of(motion, smpl_model, "cpu")).max()))
    walls, scores = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scores[device] = calculate_scores.scores(
            glob32, feat, audio_cache_dir=audio_dir, device=device)
        walls[device] = time.perf_counter() - t0
    rel = {k: abs(scores["cuda"][k] - scores["cpu"][k])
           / max(abs(scores["cpu"][k]), 1e-30)
           for k in ("fid_k", "fid_g", "beat_align")}
    log(f"scores card vs CPU: card {scores['cuda']}, CPU {scores['cpu']}; "
        f"relative differences {rel} (tol 1e-4: f32 FK in another order, "
        f"SVD by cuSOLVER against LAPACK); worst joint difference of FK "
        f"{fk_worst:.3e} m over {len(want)} clips; scoring wall time "
        f"{walls['cuda']:.3f} s (card) vs {walls['cpu']:.3f} s (CPU), "
        f"in-process ({card})")
    if not all(v <= 1e-4 for v in rel.values()):
        raise AssertionError(f"card and CPU scores disagree: {rel}")
    if abs(scores["cuda"]["fid_k"] - printed[0]) > 1e-3 * max(
            1.0, abs(printed[0])):
        raise AssertionError("the CLI's FID_k is not the in-process one")

    # The decode batch sweep, what it gives over the protocol at each cap
    # (the evaluator's DECODE_BATCH is the cap of the most), and the
    # kernels at the eval's shapes.
    plan_rates = protocol_rates(decode_sweep(model, card))
    best = max(plan_rates, key=plan_rates.get)
    log(f"decode sweep f32 over the protocol's {PROTOCOL_CLIPS} clips of "
        f"1200 steps: generated frames/s by cap "
        + ", ".join(f"{c}: {r:.2f}" for c, r in plan_rates.items())
        + f"; the most at cap {best}; the evaluator's DECODE_BATCH is "
        f"{ev_lib.DECODE_BATCH} ({card})")
    del model
    torch.cuda.empty_cache()
    times = time_kernels(att, mlp, ln, gen, card, ev_lib.DECODE_BATCH,
                         ((360, 360), (240, 240), (120, 120), (48, 360)),
                         (360, 240, 120, 48), host=False)
    launches = {}
    for dt, counts in (("f32", counts32), ("bf16", counts16)):
        for k, n in counts.items():
            launches[k, dt] = n
    return launches, times


# -- phase 8: the music-in path ---------------------------------------------

# AIST++ music names (tempo_from_name: 100, 125, 130 and 80 BPM) and their
# lengths in seconds: each at least 24 s, whose 1441 feature frames cover
# the 1439 audio frames of one 1200-step clip.
MUSIC = (("mBR2", 26.0), ("mHO3", 24.5), ("mPO5", 28.0), ("mJB0", 30.0))
WAV_RATE = 48000     # AIST's music: 48 kHz stereo 16-bit
MUSIC_STEPS = 1200
# The card's features against the CPU's, both the port's: the envelope and
# the MFCCs within 1e-5 of their block's peak (cuFFT and the CPU's FFT
# differ in the last bits, which the dB scale magnifies in the quietest
# bins; the CPU tests hold the port to the JAX package at the same 1e-5),
# CENS within 1e-5 (unit-norm rows); the tuning and the onset and beat
# one-hot columns exactly.
MUSIC_TOL = {"envelope": 1e-5, "mfcc": 1e-5, "cens": 1e-5}


def write_music(music_dir, anno_dir, frames_of):
    """The MUSIC tracks as 48 kHz stereo 16-bit WAVs, from
    np.random.default_rng(3): a noise-burst click on every beat of the
    name's tempo over a sustained chord of its own (root, fifth, octave),
    the channels differing by a little noise; and an AIST++ annotation
    layout of two train sequences a track (``splits/crossmodal_train.txt``,
    ``motions/*.pkl`` of random-walk poses, one frame a feature frame)."""
    import pickle
    import wave

    from mint_tpu_torch.audio.frontend import tempo_from_name

    rng = np.random.default_rng(3)
    os.makedirs(music_dir)
    os.makedirs(os.path.join(anno_dir, "splits"))
    os.makedirs(os.path.join(anno_dir, "motions"))
    names = []
    for i, (name, seconds) in enumerate(MUSIC):
        bpm = tempo_from_name(name)
        n = int(seconds * WAV_RATE)
        t = np.arange(n) / WAV_RATE
        root = 110.0 * 2 ** (3 * i / 12)
        y = sum(0.08 * np.sin(2 * np.pi * root * k * t) for k in (1, 1.5, 2))
        for beat in range(int(seconds * bpm / 60) + 1):
            s = int(round(beat * 60 * WAV_RATE / bpm))
            m = min(480, n - s)
            if m > 0:
                y[s:s + m] += np.exp(-np.arange(m) / 90.0) * rng.choice(
                    [-1.0, 1.0], m)
        y = 0.5 * y / np.abs(y).max()
        noise = rng.uniform(-1e-3, 1e-3, n)
        pcm = (np.stack([y + noise, y - noise], -1) * 32767).astype("<i2")
        with wave.open(os.path.join(music_dir, f"{name}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(WAV_RATE)
            w.writeframes(pcm.tobytes())
        frames = frames_of(seconds)
        for ch in (1, 2):
            seq = f"g{name[1:3]}_sBM_cAll_d{10 + i:02d}_{name}_ch{ch:02d}"
            names.append(seq)
            scaling = rng.uniform(80.0, 100.0, 1)
            with open(os.path.join(anno_dir, "motions", f"{seq}.pkl"),
                      "wb") as f:
                pickle.dump({
                    "smpl_poses": (0.02 * rng.standard_normal(
                        (frames, 72))).cumsum(0),
                    "smpl_scaling": scaling,
                    "smpl_trans": (0.5 * rng.standard_normal(
                        (frames, 3))).cumsum(0) + [0.0, scaling[0], 0.0]},
                    f)
    with open(os.path.join(anno_dir, "splits", "crossmodal_train.txt"),
              "w") as f:
        f.write("\n".join(names))
    return names


def run_preprocessing(work, music_dir, anno_dir, out, device, card):
    """The port's preprocessing CLI as a subprocess on `device` (train
    split, fresh cache, extraction inline); returns its per-track lines
    and its total (tracks, s of music, s of extraction, s of music per
    s)."""
    args = [f"--anno_dir={anno_dir}", f"--audio_dir={music_dir}",
            f"--audio_cache_dir={out}/cache", "--split=train",
            f"--tfrecord_path={out}/data/aist_tfrecord", "--n_shards=2",
            "--audio_workers=0", f"--device={device}"]
    _, err, wall = run_module("mint_tpu_torch.tools.preprocessing", args,
                              work)
    tracks = re.findall(r"audio features of (\w+): (\d+) frames, ([\d.]+) s "
                        r"of music in ([\d.]+) s", err)
    total = re.findall(r"audio features: (\d+) tracks, ([\d.]+) s of music "
                       r"in ([\d.]+) s of extraction on (\w+): ([\d.]+) s "
                       r"of music per s", err)
    if len(tracks) != len(MUSIC) or len(total) != 1 or \
            total[0][3] != device:
        raise AssertionError(f"preprocessing CLI on {device} logged:\n"
                             f"{err[-3000:]}")
    log(f"preprocessing CLI on {device}: {total[0][0]} tracks, "
        f"{total[0][1]} s of music extracted in {total[0][2]} s: "
        f"{total[0][4]} s of music per s (each track: "
        + ", ".join(f"{n} {m} s in {s} s" for n, _, m, s in tracks)
        + f"); the CLI's whole run {wall:.1f} s ({card})")
    return tracks, total[0]


def audio_stages(path, bpm, card):
    """Where a track's extraction time goes, on the card and on the CPU:
    host seconds of each stage of ``extract_audio_features`` (each ends
    with its result on the host) in two calls, the first of which builds
    the CQT basis for the track's tuning on the host (in a fresh process
    the card's first call, and the CPU's first call finds it built); and
    the WAV read and the resampling, which run on the host either way."""
    from mint_tpu_torch.audio import beat, cqt, onset, spectral
    from mint_tpu_torch.audio.frontend import HOP_LENGTH, SR
    from mint_tpu_torch.audio.resample import resample
    from mint_tpu_torch.audio.wav import read_wav

    def clock(times, name, t0):
        times[name] = round(time.perf_counter() - t0, 4)
        return time.perf_counter()

    host = {}
    t = time.perf_counter()
    y48, rate = read_wav(path)
    t = clock(host, "read_wav", t)
    y = resample(y48, rate, SR)
    clock(host, "resample", t)
    stages = {}
    for device in ("cuda", "cpu"):
        calls = []
        for _ in range(2):
            times = {}
            t = time.perf_counter()
            yd = torch.from_numpy(y).to(device)
            env = spectral.onset_strength(yd, SR).cpu().numpy()
            spectral.mfcc(yd, SR, n_mfcc=20).cpu().numpy()
            t = clock(times, "onset_strength+mfcc", t)
            tuning = cqt.estimate_tuning(y, SR, device=device)
            t = clock(times, "tuning", t)
            chroma = cqt.fold_cq_to_chroma(cqt.cqt_magnitude(
                y, SR, tuning=tuning, device=device), 7, 12, 36)
            t = clock(times, "cqt", t)
            cqt.cens_from_chroma(chroma)
            onset.onset_detect(env, SR, HOP_LENGTH)
            beat.beat_track(env, SR, HOP_LENGTH, start_bpm=bpm,
                            tightness=100.0)
            clock(times, "cens+peaks+beats", t)
            calls.append(times)
        stages[device] = calls
    log(f"audio stages of {os.path.basename(path)} ({len(y) / SR:.1f} s), "
        f"seconds, first call / second: card {stages['cuda'][0]} / "
        f"{stages['cuda'][1]} (sums {sum(stages['cuda'][0].values()):.4f}"
        f" / {sum(stages['cuda'][1].values()):.4f}), CPU "
        f"{stages['cpu'][0]} / {stages['cpu'][1]} (sums "
        f"{sum(stages['cpu'][0].values()):.4f} / "
        f"{sum(stages['cpu'][1].values()):.4f}); on the host either way "
        f"{host} ({card})")


def music_path(work, run_dir, card):
    """Phase 8: music in, dance out, on the card.  (a) MUSIC as WAVs and an
    AIST++ layout over them; (b) the preprocessing CLI on the card and on
    the CPU; (c) the card's features against the CPU's; (d) the card's
    tfrecords through the port's train pipeline into one batch; (e) one
    1200-step clip a track, co-batched by GenerationService from the f32
    train CLI's checkpoint in `run_dir`, 16 launches of each f32 kernel a
    decode step; (f) a clip's BVH by bvh_export and its GIF by visualize;
    (g) calculate_scores on the clips, Beat Alignment from (b)'s cache."""
    import glob as globlib
    import pickle

    from mint_tpu_torch.audio import cqt
    from mint_tpu_torch.audio.frontend import FPS, SR, tempo_from_name
    from mint_tpu_torch.audio.resample import load
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.data.pipeline import create_input
    from mint_tpu_torch.serving import GenerationService
    from mint_tpu_torch.tools import bvh_export, visualize
    from mint_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    music_dir = os.path.join(work, "music")
    anno = os.path.join(work, "music_anno")
    seqs = write_music(music_dir, anno, lambda s: int(s * FPS) + 1)

    # (b) extraction on the card, then on the CPU.
    outs = {d: os.path.join(work, f"music_{d}") for d in ("cuda", "cpu")}
    rates = {d: run_preprocessing(work, music_dir, anno, outs[d], d, card)[1]
             for d in ("cuda", "cpu")}

    # (c) the card's features against the CPU's.
    feats = {}
    worst = {k: 0.0 for k in MUSIC_TOL}
    for name, seconds in MUSIC:
        card_f, cpu_f = (np.load(os.path.join(outs[d], "cache", f"{name}.npy"))
                         for d in ("cuda", "cpu"))
        feats[name] = card_f
        want_frames = int(seconds * SR) // 512 + 1
        if card_f.shape != (want_frames, 35) or cpu_f.shape != card_f.shape \
                or not np.isfinite(card_f).all():
            raise AssertionError(f"{name}: features {card_f.shape} / "
                                 f"{cpu_f.shape}, want ({want_frames}, 35)")
        cols = np.abs(card_f - cpu_f).max(axis=0)
        errs = {"envelope": cols[0] / np.abs(cpu_f[:, 0]).max(),
                "mfcc": cols[1:21].max() / np.abs(cpu_f[:, 1:21]).max(),
                "cens": cols[21:33].max()}
        for k, v in errs.items():
            worst[k] = max(worst[k], float(v))
        y, _ = load(os.path.join(music_dir, f"{name}.wav"), sr=SR)
        tuning = {d: cqt.estimate_tuning(y, SR, device=d)
                  for d in ("cuda", "cpu")}
        bpm = tempo_from_name(name)
        beats = np.flatnonzero(card_f[:, 34])
        interval = float(np.median(np.diff(beats))) if len(beats) > 1 \
            else float("nan")
        log(f"music {name} ({bpm} BPM, {seconds} s): card vs CPU max error "
            f"by column {np.array2string(cols, precision=2)}; envelope "
            f"{errs['envelope']:.3e}, MFCC {errs['mfcc']:.3e} of their peaks,"
            f" CENS {errs['cens']:.3e}; tuning {tuning['cuda']} / "
            f"{tuning['cpu']}; {int(card_f[:, 33].sum())} onset peaks, "
            f"{len(beats)} beats, median interval {interval} frames (3600 / "
            f"BPM = {3600 / bpm:.2f})")
        for col, what in ((33, "onset peak"), (34, "beat")):
            differ = np.flatnonzero(card_f[:, col] != cpu_f[:, col])
            if len(differ):
                raise AssertionError(f"{name}: {what} one-hot differs card "
                                     f"vs CPU at frames {differ.tolist()}")
        if tuning["cuda"] != tuning["cpu"] or any(
                errs[k] > MUSIC_TOL[k] for k in MUSIC_TOL):
            raise AssertionError(f"{name}: card vs CPU {errs}, tuning "
                                 f"{tuning} (tolerances {MUSIC_TOL})")
        if not abs(interval - 3600 / bpm) <= 1.5:
            raise AssertionError(f"{name}: beat interval {interval}, want "
                                 f"{3600 / bpm:.2f} +- 1.5")
    audio_stages(os.path.join(music_dir, f"{MUSIC[0][0]}.wav"),
                 tempo_from_name(MUSIC[0][0]), card)
    log(f"music card vs CPU, worst over {len(MUSIC)} tracks: envelope "
        f"{worst['envelope']:.3e}, MFCC {worst['mfcc']:.3e} of their peaks, "
        f"CENS {worst['cens']:.3e} (tolerances {MUSIC_TOL}); tuning and "
        f"one-hot columns equal; extraction {rates['cuda'][4]} s of music "
        f"per s on the card, {rates['cpu'][4]} on the CPU ({card})")

    # (d) the card's records through the train pipeline.
    pipeline = load_pipeline_config(CONFIG)
    files = sorted(globlib.glob(os.path.join(outs["cuda"], "data",
                                             "aist_tfrecord-train-*")))
    batch = next(create_input(pipeline.train_config, pipeline.train_dataset,
                              is_training=True, seed=0, data_files=files,
                              prefetch=False))
    shapes = {k: v.shape for k, v in batch.items()
              if k in ("motion_input", "audio_input", "target")}
    if shapes != {"motion_input": (TRAIN_BATCH, 120, 225),
                  "audio_input": (TRAIN_BATCH, 240, 35),
                  "target": (TRAIN_BATCH, 20, 225)} or not all(
                      np.isfinite(batch[k]).all() for k in shapes):
        raise AssertionError(f"train batch from the card's tfrecords: "
                             f"{shapes}")
    log(f"train pipeline over the card's {len(files)} tfrecord shards "
        f"({len(seqs)} sequences): one batch {shapes}")

    # (e) one clip a track from the card's features, co-batched.
    model = flagship(torch.float32, "cuda")
    model.load_state_dict(CheckpointManager(run_dir).restore_params(
        model.state_dict()))
    service = GenerationService(model, batch_window_ms=2000.0,
                                max_batch=len(MUSIC))
    clips, errors = {}, []

    def call(i, name):
        try:
            clips[name] = service.generate(
                feats[name], seed=batch["motion_input"][i],
                steps=MUSIC_STEPS)
        except Exception as e:  # re-raised below
            errors.append(e)

    try:
        before = service.stats_snapshot()
        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i, name))
                   for i, (name, _) in enumerate(MUSIC)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        stats = {k: v - before[k] for k, v in
                 service.stats_snapshot().items()}
    finally:
        service.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"music decode failed: {errors}")
    expect = expected_launches(stats["decode_steps"], bf16=False)
    log(f"music decode f32: {len(clips)} clips of {MUSIC_STEPS} steps from "
        f"the card's features in {stats['batches']} batch(es), "
        f"{stats['decode_steps']} decode steps (the server's bucket) in "
        f"{seconds:.2f} s; launches {launches} == {expect} ({card})")
    if stats["batches"] != 1 or launches != expect or any(
            c.shape != (MUSIC_STEPS, 225) or not np.isfinite(c).all()
            for c in clips.values()):
        raise AssertionError(f"music decode: stats {stats}, launches "
                             f"{launches}, clips "
                             f"{[c.shape for c in clips.values()]}")
    out_dir = os.path.join(work, "music_out")
    os.makedirs(out_dir)
    for i, (name, _) in enumerate(MUSIC):
        motion = np.concatenate([batch["motion_input"][i], clips[name]])
        np.save(os.path.join(out_dir, f"{seqs[2 * i]}_{name}.npy"), motion)
    del model
    torch.cuda.empty_cache()

    # (f) the first clip's BVH and GIF.
    first = os.path.join(out_dir, f"{seqs[0]}_{MUSIC[0][0]}.npy")
    motion = np.load(first)
    pkl = os.path.join(work, "music_clip.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"pred_motion": motion[:, 9:].reshape(-1, 24, 9),
                     "pred_trans": motion[:, 6:9]}, f)
    bvh = os.path.join(work, "music_clip.bvh")
    t0 = time.perf_counter()
    bvh_export.main([f"--motion_pkl={pkl}", f"--output={bvh}"])
    with open(bvh) as f:
        text = f.read()
    rows = text.split("Frame Time:")[1].strip().splitlines()[1:]
    values = np.array([[float(v) for v in r.split()] for r in rows])
    if f"Frames: {len(motion)}" not in text or values.shape != (
            len(motion), 75) or not np.isfinite(values).all():
        raise AssertionError(f"bvh_export: {values.shape}")
    log(f"bvh_export on the card: {len(rows)} frames x 75 channels in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log("visualize: matplotlib is not installed on this machine; the "
            "GIF (a host tool, no device path) is not rendered")
    else:
        gif = os.path.join(work, "music_clip.gif")
        t0 = time.perf_counter()
        visualize.main([f"--motion_npy={first}", f"--output={gif}",
                        "--stride=30"])
        log(f"visualize on the card: {os.path.getsize(gif)} bytes of GIF, "
            f"{len(motion[::30])} frames, in {time.perf_counter() - t0:.2f} s")

    # (g) the scores, Beat Alignment from the card's audio cache.
    out, _, wall = run_module(
        "mint_tpu_torch.tools.calculate_scores",
        [f"--result_files={os.path.join(out_dir, '*.npy')}",
         f"--feature_dir={os.path.join(work, 'features')}",
         f"--audio_cache_dir={os.path.join(outs['cuda'], 'cache')}"], work)
    fids = re.findall(r"Evaluation: FID_k: (\S+), FID_g: (\S+)", out)
    beats = re.findall(r"Beat Alignment Score: (\S+) over (\d+) clips", out)
    if not fids or not beats:
        raise AssertionError(f"calculate_scores printed:\n{out}")
    printed = [float(x) for x in (*fids[0], beats[0][0])]
    if not all(math.isfinite(x) for x in printed) or \
            int(beats[0][1]) != len(MUSIC):
        raise AssertionError(f"calculate_scores printed {fids} {beats}")
    log(f"calculate_scores on the music clips: FID_k {printed[0]}, FID_g "
        f"{printed[1]}, Beat Alignment {printed[2]} over {beats[0][1]} clips"
        f" (the CLI's whole run {wall:.1f} s)")
    log(f"phase 8 (music in, dance out) in "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 9: across ranks and replicas, and checkpoints in --------------

TP = 2           # the model axis of phase 9's ranks: 5 heads, F = 1536
TP_BATCH = 4     # phase 9b's batch (each rank's; one model group)
WS1_STEPS = 61   # phase 9c's CLI steps: the first, then six windows of 10
WS1_FROM = 21    # 9c's synchronized rates run from this step's record
UNEVEN_HEADS = (3, 2)  # a model = 4 rank's heads of the flagship's 10


def check_shard_kernels(att, mlp, gen, heads=(10 // TP,), width=3072 // TP,
                        batches=(TP_BATCH, TRAIN_BATCH)):
    """Both kernels at a tensor-parallel rank's shapes (model = 2: 5 heads
    of q[B,5,N,80]; the MLP's F = 1536, its output bias left to the sum
    over the model group, so the kernel gets none; model = 4: 3 or 2 of
    the 10 heads, F = 768) against their plain versions, f32 and bf16, at
    `batches` (phase 9b's and training's).  Returns the worst error per
    (kernel, dtype name)."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = DTYPES[dtype]
        for b, h in [(b, h) for b in batches for h in heads]:
            for n in (360, 240, 120):
                q, k, v = _qkv("fused", b, h, n, n, 80, dtype, gen)
                got = att.attention(q, k, v, SCALE)
                torch.cuda.synchronize()
                want = att.attention_reference(q, k, v, SCALE)
                err = (got.float() - want.float()).abs().max().item()
                tol = (1e-5 if dtype == torch.float32
                       else 2 * bf16_ulp(want.float().abs().max().item()))
                log(f"attention {name} shard q[{b},{h},{n},80]: max_abs_err "
                    f"{err:.3e} tol {tol:.3e} "
                    f"{'ok' if err <= tol else 'FAIL'}")
                if not err <= tol:
                    raise AssertionError(f"attention at a rank's shape: {err}")
                worst["attention", name] = max(
                    worst.get(("attention", name), 0.0), err)
        w1, b1, w2, _ = mlp_weights(gen, dtype, f=width)
        for m in sorted({b * n for b in batches for n in (360, 240, 120)},
                        reverse=True):
            x = torch.randn(m, 800, device="cuda", generator=gen).to(dtype)
            got = mlp.fused_mlp(x, w1, b1, w2, None)
            torch.cuda.synchronize()
            want = mlp.mlp_reference(x, w1, b1, w2, torch.zeros(
                800, dtype=dtype, device="cuda"))
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            tol = (1e-5 * max(1.0, peak) if dtype == torch.float32
                   else 2 * bf16_ulp(peak))
            log(f"fused_mlp {name} shard x[{m},800] W1[800,{width}] "
                f"W2[{width},800], no b2: max_abs_err {err:.3e} tol {tol:.3e} "
                f"{'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"fused MLP at a rank's shape: {err}")
            worst["fused_mlp", name] = max(
                worst.get(("fused_mlp", name), 0.0), err)
    return worst


def tp_rank(rank: int, port: int, work: str) -> None:
    """One of phase 9b's two gloo ranks on cuda:0 (``chip_smoke.py
    --tp-rank R --tp-port P --tp-work DIR``): a (data 1, model 2) mesh,
    the flagship's slice of this rank loaded from ``full.pt``, the loss
    and gradients of ``batch.pt`` in f32 and in bf16 compute, each
    forward's launches, one f32 train step clipped at ``clip.pt``'s norm
    and the loss after it; rank 0 saves the gathered gradients, the
    stepped parameters and Adam moments, and the numbers in
    ``rank0.pt``."""
    import torch.distributed as dist
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.parallel import mesh as mesh_lib
    from mint_tpu_torch.train import Trainer, schedules

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(data=1, model=TP, device="cuda:0")
        cfg = load_pipeline_config(CONFIG).multi_modal_model
        full = torch.load(os.path.join(work, "full.pt"), weights_only=True)
        batch = {k: v.cuda() for k, v in torch.load(
            os.path.join(work, "batch.pt"), weights_only=True).items()}
        clip = torch.load(os.path.join(work, "clip.pt"),
                          weights_only=True)["clip"]
        out = {}
        for name, compute in (("f32", None), ("bf16", torch.bfloat16)):
            model = builder.build(cfg, is_training=True, device="cuda:0",
                                  compute_dtype=compute, mesh=mesh)
            model.load_state_dict(mesh_lib.shard_state_dict(
                full, mesh, mesh_lib.attention_heads(model)))
            trainer = Trainer(model, schedules.constant(1e-4),
                              grad_clip_norm=clip, mesh=mesh)
            state = trainer.init_state(model)
            with torch.no_grad():
                reset_launches()
                trainer.loss(state.params, batch)
                torch.cuda.synchronize()
                counts = launch_counts()
            reset_launches()
            loss, grads = trainer.loss_and_grads(state.params, batch)
            torch.cuda.synchronize()
            backwards = launch_counts()["attention_backward"]
            gathered = mesh_lib.gather_state_dicts([grads], mesh)
            out[name] = {"loss": float(loss), "launches": counts,
                         "backward_launches": backwards,
                         "grads": gathered[0] if gathered else None}
            if name == "f32":
                state, _ = trainer.train_step(state, batch)
                with torch.no_grad():
                    out["loss_after"] = float(trainer.loss(state.params,
                                                           batch))
                opt = state.opt_state
                out["stepped"] = mesh_lib.gather_state_dicts(
                    [state.params, opt["mu"], opt["nu"]], mesh)
            del model, trainer, state
            torch.cuda.empty_cache()
        if rank == 0:
            torch.save(out, os.path.join(work, "rank0.pt"))
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()


def tensor_parallel_step(work, card):
    """9b: the flagship at full width and depth split over 2 gloo ranks on
    cuda:0 (model = 2: 5 heads and F = 1536 a rank; uncaptured: gloo's
    collectives are not captured) against the single-rank port on the
    card, same weights and batch: f32 loss 1e-5 relative, gradients 1e-4
    of each leaf's peak; one train step clipped at half the one-rank
    gradient norm (so that the clip, whose norm sums over the model group,
    bites): the loss after it 1e-5 relative, the parameters within 2e-5
    and their update within 1e-3 relative L2 (Adam's first step moves a
    parameter by at most the rate, 1e-4: a step that updated nothing or
    the wrong way misses both), both Adam moments 1e-4 of each leaf's
    peak (the first carries the clip's factor); bf16 compute loss 1e-2 relative, gradients 0.1 relative L2 a leaf
    (each rank's kernel rounds its partial fc2 / to_out sum to bf16 before
    the sum over the ranks, where one device rounds once); 16 launches of
    each kernel per forward per rank (32 LayerNorms in bf16)."""
    from mint_tpu_torch.parallel.dryrun import free_port, run_ranks
    from mint_tpu_torch.train import Trainer, schedules

    t_phase = time.perf_counter()
    tp_dir = os.path.join(work, "tp")
    os.makedirs(tp_dir)
    model = flagship(torch.float32, "cpu", is_training=True)
    torch.save(model.state_dict(), os.path.join(tp_dir, "full.pt"))
    batch = train_batch(TP_BATCH, "cpu", seed=9)
    torch.save(batch, os.path.join(tp_dir, "batch.pt"))
    cuda_batch = {k: v.cuda() for k, v in batch.items()}
    one = flagship(torch.float32, "cuda", is_training=True)
    _, grads = Trainer(one, schedules.constant(1e-4)).loss_and_grads(
        dict(one.named_parameters()), cuda_batch)
    clip = 0.5 * torch.linalg.vector_norm(
        torch.stack([g.norm() for g in grads.values()])).item()
    torch.save({"clip": clip}, os.path.join(tp_dir, "clip.pt"))
    del one, grads
    port = free_port()
    run_ranks(lambda r: [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                         "--tp-rank", str(r), "--tp-port", str(port),
                         "--tp-work", tp_dir], TP, timeout=600)
    got = torch.load(os.path.join(tp_dir, "rank0.pt"), weights_only=True)

    result = {}
    for name, compute in (("f32", None), ("bf16", torch.bfloat16)):
        one = flagship(torch.float32, "cuda", is_training=True,
                       compute_dtype=compute)
        trainer = Trainer(one, schedules.constant(1e-4), grad_clip_norm=clip)
        state = trainer.init_state(one)
        loss, grads = trainer.loss_and_grads(state.params, cuda_batch)
        loss = float(loss)
        mine = got[name]
        rel = abs(mine["loss"] - loss) / abs(loss)
        per_leaf = {}
        for k, want in grads.items():
            have = mine["grads"][k].cuda()
            if name == "f32":
                peak = want.abs().max().item()
                per_leaf[k] = (have - want).abs().max().item() / peak
            else:
                per_leaf[k] = ((have - want).norm()
                               / want.norm().clamp_min(1e-30)).item()
        worst = max(per_leaf, key=per_leaf.get)
        expect = expected_launches(1, bf16=name == "bf16")
        want_bwd = 16 if name == "bf16" else 0
        loss_tol, grad_tol = (1e-5, 1e-4) if name == "f32" else (1e-2, 0.1)
        what = ("of each leaf's peak" if name == "f32"
                else "relative L2 of each leaf")
        log(f"tensor parallel {name} flagship batch {TP_BATCH}, 2 gloo "
            f"ranks (model = 2) on cuda:0 vs one rank: loss {mine['loss']:.6f}"
            f" vs {loss:.6f} (rel {rel:.2e}, tol {loss_tol:.0e}); worst "
            f"gradient {per_leaf[worst]:.3e} {what} ({worst}; tol "
            f"{grad_tol:.0e}); launches per forward of rank 0 "
            f"{mine['launches']}, want {expect}; attention backward kernel "
            f"calls of its backward {mine['backward_launches']}, want "
            f"{want_bwd} ({card})")
        if (not rel <= loss_tol or not per_leaf[worst] <= grad_tol
                or mine["launches"] != expect
                or mine["backward_launches"] != want_bwd):
            raise AssertionError(f"tensor parallel {name}: loss rel {rel}, "
                                 f"{worst} {per_leaf[worst]}, launches "
                                 f"{mine['launches']}")
        result[name] = {"loss_rel": rel, "worst_grad": per_leaf[worst],
                        "launches": mine["launches"],
                        "backward_launches": mine["backward_launches"]}
        if name == "f32":
            init = {k: v.clone() for k, v in state.params.items()}
            state, _ = trainer.train_step(state, cuda_batch)
            with torch.no_grad():
                after = float(trainer.loss(state.params, cuda_batch))
            step_rel = abs(got["loss_after"] - after) / abs(after)
            params, mu, nu = got["stepped"]
            moved = max((params[k].cuda() - v).abs().max().item()
                        for k, v in state.params.items())
            upd = torch.cat([(v - init[k]).reshape(-1)
                             for k, v in state.params.items()])
            upd_err = torch.cat([(params[k].cuda() - v).reshape(-1)
                                 for k, v in state.params.items()])
            upd_rel = (upd_err.norm() / upd.norm()).item()
            opt = state.opt_state
            moments = max(
                ((have[k].cuda() - v).abs().max()
                 / v.abs().max().clamp_min(1e-30)).item()
                for have, m in ((mu, "mu"), (nu, "nu"))
                for k, v in opt[m].items())
            log(f"tensor parallel f32 train step clipped at {clip:.4g} (half"
                f" the one-rank gradient norm): loss after it rel "
                f"{step_rel:.2e} (tol 1e-5); parameters max_abs_err "
                f"{moved:.3e} (tol 2e-5), update relative L2 error "
                f"{upd_rel:.3e} (tol 1e-3); Adam moments {moments:.3e} of "
                f"their leaf's peak (tol 1e-4)")
            if (not step_rel <= 1e-5 or not moved <= 2e-5
                    or not upd_rel <= 1e-3 or not moments <= 1e-4):
                raise AssertionError(f"tensor parallel train step: "
                                     f"{step_rel}, {moved}, {upd_rel}, "
                                     f"{moments}")
            result["step"] = {"loss_rel": step_rel, "max_abs_err": moved,
                              "update_rel_l2": upd_rel, "moments": moments}
        del one, trainer, state, grads
        torch.cuda.empty_cache()
    log(f"phase 9b (tensor parallel) in {time.perf_counter() - t_phase:.1f} "
        f"s")
    return result


def distributed_world_of_one(work, card):
    """9c: the train CLI with ``--distributed --num_processes=1`` (NCCL,
    a world of one: every gradient and the loss all-reduced, and the
    collectives captured in the step's graph) against the CLI without it,
    bf16 at batch 32 with the card-resident corpus (the same windows
    both ways) and a clip, 61 steps (the first, then six fused windows
    of 10): the final checkpoints equal bit for bit.  Both runs' steps/s,
    and the host pipeline's over the same steps (the native loader's
    question), two ways: the CLI's own timer by step (it times the host's
    enqueueing, which may run a window ahead of the card), and
    synchronized (``_synced_rate``); then Trainer.train_step's steps/s
    in a world of one, timed as phase 6c times one device."""
    from mint_tpu_torch.parallel.dryrun import free_port

    t_phase = time.perf_counter()
    rates = {}
    runs = {"plain": [], "distributed": [
        "--distributed", f"--coordinator_address=127.0.0.1:{free_port()}",
        "--num_processes=1", "--process_id=0"]}
    for name, extra in runs.items():
        model_dir = os.path.join(work, f"ws1_{name}")
        _, err, seconds = run_module("mint_tpu_torch.tools.train", [
            f"--config_path={CONFIG}", f"--model_dir={model_dir}",
            f"--steps={WS1_STEPS}", "--use_bfloat16", "--grad_clip_norm=1.0",
            "--input_backend=device", "--summary_interval=10", *extra],
            work)
        if (name == "distributed") != ("mesh: {'data': 1, 'model': 1}"
                                       in err):
            raise AssertionError(f"train CLI {name}: mesh log missing")
        rates[name] = _cli_rates(model_dir)
        rates[name + "_synced"] = _synced_rate(model_dir)
        counts = logged_launches(err, f"train CLI {name}")
        expect = expected_launches(WS1_STEPS, bf16=True, backwards=WS1_STEPS)
        log(f"train CLI bf16 {name} (device input) batch {TRAIN_BATCH} x "
            f"{WS1_STEPS} steps in {seconds:.1f} s; steps_per_sec by step "
            f"{rates[name]}; synchronized {rates[name + '_synced']!r} "
            f"steps/s over steps {WS1_FROM}-{WS1_STEPS - 10}; launches "
            f"{counts}, want {expect} ({card})")
        if counts != expect:
            raise AssertionError(f"train CLI {name}: launches {counts}")
    files = {}
    for name in runs:
        path = os.path.join(work, f"ws1_{name}", str(WS1_STEPS))
        files[name] = [torch.load(os.path.join(path, f), weights_only=True)
                       for f in ("params.pt", "opt_state.pt")]
    (p0, o0), (p1, o1) = files["plain"], files["distributed"]
    same = (all(torch.equal(p0[k], p1[k]) for k in p0)
            and all(torch.equal(o0["opt_state"][t][k], o1["opt_state"][t][k])
                    for t in ("mu", "nu") for k in p0)
            and o0["step"] == o1["step"] == WS1_STEPS)
    log(f"train CLI bf16 --distributed --num_processes=1 (NCCL, graphed) "
        f"vs without, step {WS1_STEPS}: parameters and both moments equal "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError("a world of one does not train as one device")
    # The native loader's question: the host pipeline at the same steps.
    model_dir = os.path.join(work, "ws1_python")
    _, err, seconds = run_module("mint_tpu_torch.tools.train", [
        f"--config_path={CONFIG}", f"--model_dir={model_dir}",
        f"--steps={WS1_STEPS}", "--use_bfloat16", "--grad_clip_norm=1.0",
        "--input_backend=python", "--summary_interval=10"], work)
    rates["python"] = _cli_rates(model_dir)
    rates["python_synced"] = _synced_rate(model_dir)
    log(f"train CLI bf16 plain (python input) batch {TRAIN_BATCH} x "
        f"{WS1_STEPS} steps in {seconds:.1f} s; steps_per_sec by step "
        f"{rates['python']}; synchronized {rates['python_synced']!r} "
        f"steps/s over steps {WS1_FROM}-{WS1_STEPS - 10} ({card})")
    log(f"native loader's question, bf16 batch {TRAIN_BATCH}, synchronized"
        f" steps/s: host pipeline {rates['python_synced']!r}, card-resident"
        f" corpus {rates['plain_synced']!r}: the host pipeline at "
        f"{rates['python_synced'] / rates['plain_synced']!r} of the card's"
        f" rate ({card})")
    rates["step_world_of_one"] = world_of_one_rate(card)
    log(f"phase 9c (world of one) in {time.perf_counter() - t_phase:.1f} s")
    return rates


def world_of_one_rate(card):
    """Trainer.train_step's bf16 steps/s at batch 32 on a mesh of one NCCL
    rank (this process), each timed step a replay of a graph that holds
    the all-reduce: the distributed path's cost on one card, beside
    phase 6c's one-device rate."""
    import torch.distributed as dist
    from mint_tpu_torch.parallel import mesh as mesh_lib
    from mint_tpu_torch.parallel.dryrun import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_mesh(1, 1, device="cuda:0")
        rate = train_rate("bf16", card, steps=10, mesh=mesh)
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()
    return rate


def _cli_rates(model_dir):
    """{step: steps_per_sec} of a train CLI run's metrics.jsonl."""
    with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
        return {r["step"]: r["steps_per_sec"]
                for r in map(json.loads, f)}


def _synced_rate(model_dir):
    """Steps/s between the records of steps WS1_FROM and WS1_STEPS - 10
    of metrics.jsonl, by their wall-clock ``time``.  The controller
    writes a record after reading its loop's loss, which blocks until
    the card has run that loop (and the one queued after it), so the
    time between two records is the time the steps between them took,
    whether the card or the host bounds them.  The last record is left
    out: nothing is queued after its loop."""
    with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
        times = {r["step"]: r["time"] for r in map(json.loads, f)}
    last = WS1_STEPS - 10
    return (last - WS1_FROM) / (times[last] - times[WS1_FROM])


def replica_decode(card):
    """9d: the flagship f32 decode over 2 replicas on cuda:0, by the
    evaluator (4 clips, 3 steps, two passes: the first captures each
    replica's graph one after the other, the second replays both
    concurrently) and by the server (3 co-batched requests padded to 4,
    2 rows a replica), against one replica: frames within 1e-3, 16
    launches of each kernel a step per replica."""
    from mint_tpu_torch.eval.evaluator import Evaluator
    from mint_tpu_torch.serving.server import GenerationService

    t_phase = time.perf_counter()
    steps = 3
    model = flagship(torch.float32, "cuda")
    rng = np.random.default_rng(11)
    clips = [{"motion_input": rng.standard_normal((1, 120, 225)).astype(
                  np.float32) * 0.5,
              "audio_input": rng.standard_normal((1, steps + 239, 35)).astype(
                  np.float32) * 0.5,
              "motion_name": [f"clip{i}".encode()], "audio_name": [b"a"]}
             for i in range(4)]
    with tempfile.TemporaryDirectory() as out:
        frames = {}
        for n in (1, 2):
            evaluator = Evaluator(model, clips, steps=steps, decode_batch=4,
                                  output_dir=os.path.join(out, str(n)),
                                  devices=["cuda:0"] * n)
            for rounds in range(2):
                reset_launches()
                evaluator.evaluate()
                torch.cuda.synchronize()
                counts = launch_counts()
                expect = expected_launches(steps * n, bf16=False)
                log(f"evaluator over {n} replica(s) on cuda:0, pass "
                    f"{rounds + 1}: launches {counts}, want {expect} (16 a "
                    f"step a replica); {evaluator.replicas.summary()}")
                if counts != expect:
                    raise AssertionError(f"evaluator launches {counts}")
            frames[n] = [np.load(os.path.join(out, str(n), f"clip{i}_a.npy"))
                         for i in range(4)]
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(frames[1], frames[2]))
    log(f"evaluator 2 replicas vs 1: max_abs_err {err:.3e} over {steps} "
        f"steps (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"evaluator replicas disagree: {err}")

    audios = [rng.standard_normal((steps + 239, 35)).astype(np.float32)
              * 0.5 for _ in range(3)]
    results = {}
    for n in (1, 2):
        service = GenerationService(model, batch_window_ms=2000,
                                    max_batch=4, steps_bucket=steps,
                                    devices=["cuda:0"] * n)
        try:
            outs = [None] * 3
            reset_launches()

            def ask(i):
                outs[i] = service.generate(audios[i], steps=steps)

            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
            counts = launch_counts()
            stats = service.stats_snapshot()
        finally:
            service.close()
        expect = expected_launches(steps * n, bf16=False)
        log(f"server over {n} replica(s) on cuda:0: stats {stats}, "
            f"launches {counts}, want {expect}")
        if (counts != expect or stats["replicas"] != n
                or stats["batches"] != 1 or any(o is None for o in outs)):
            raise AssertionError(f"server replicas {n}: {stats} {counts}")
        results[n] = outs
    err = max(float(np.abs(a - b).max())
              for a, b in zip(results[1], results[2]))
    log(f"server 2 replicas vs 1: max_abs_err {err:.3e} (tol 1e-3); phase "
        f"9d in {time.perf_counter() - t_phase:.1f} s ({card})")
    if not err <= 1e-3:
        raise AssertionError(f"server replicas disagree: {err}")
    del model
    torch.cuda.empty_cache()


def reference_names(work):
    """9e: the flagship's f32 weights renamed to the reference TF
    checkpoint's names, through the pure converter (no tensorflow), written
    as a port checkpoint and served by the server's load_model: its
    forward on the card equals the source weights' bit for bit."""
    from mint_tpu_torch.serving import server
    from mint_tpu_torch.tools import convert_checkpoint as cc

    source = flagship(torch.float32, "cuda")
    tf_vars = cc.tf_variables_of(source)
    state, report = cc.convert_tf_variables(tf_vars, source)
    out = os.path.join(work, "from_tf")
    cc.write_checkpoint(state, out)
    served = server.load_model(server._parser().parse_args(
        [f"--config_path={CONFIG}", f"--checkpoint_dir={out}"]))
    rng = np.random.default_rng(12)
    inputs = {"motion_input": torch.from_numpy(rng.standard_normal(
                  (2, 120, 225)).astype(np.float32)).cuda(),
              "audio_input": torch.from_numpy(rng.standard_normal(
                  (2, 240, 35)).astype(np.float32)).cuda()}
    with torch.inference_mode():
        same = torch.equal(source(inputs), served(inputs))
    log(f"reference TF names: {len(tf_vars)} variables converted without "
        f"tensorflow (skipped {len(report)}), served from {out}: forward "
        f"equal to the source weights' bit for bit: {same}")
    if not same or report:
        raise AssertionError("the converted checkpoint serves another model")
    del source, served
    torch.cuda.empty_cache()


def across_ranks(att, mlp, ln, gen, work, card):
    """Phase 9: the kernels at a tensor-parallel rank's shapes (a), the
    tensor-parallel train step (b), a world of one over NCCL (c), decode
    over replicas (d), the reference-name converter (e).  Returns the
    shard-shape errors and times, and (b)'s launches a forward a rank."""
    t_phase = time.perf_counter()
    errs = check_shard_kernels(att, mlp, gen)
    times = time_kernels(att, mlp, ln, gen, card, TRAIN_BATCH,
                         ((360, 360), (240, 240), (120, 120)),
                         (360, 240, 120), host=False, heads=10 // TP,
                         width=3072 // TP)
    # Uneven heads (model = 4: ranks of 3, 3, 2 and 2 heads, F = 768).
    uneven_errs = check_shard_kernels(att, mlp, gen, heads=UNEVEN_HEADS,
                                      width=3072 // 4,
                                      batches=(TRAIN_BATCH,))
    uneven_times = {}
    for h in UNEVEN_HEADS:  # the MLP's F = 768 once
        for key, rows in time_kernels(
                att, mlp, ln, gen, card, TRAIN_BATCH,
                ((360, 360), (240, 240), (120, 120)),
                (360, 240, 120) if h == UNEVEN_HEADS[0] else (),
                host=False, heads=h, width=3072 // 4).items():
            label = f"{h} heads" if key[0] == "attention" else "F=768"
            uneven_times.setdefault(key, {})[label] = rows
    tp = tensor_parallel_step(work, card)
    rates = distributed_world_of_one(work, card)
    replica_decode(card)
    reference_names(work)
    log(f"phase 9 (across ranks and replicas, checkpoints in) in "
        f"{time.perf_counter() - t_phase:.1f} s; the train CLI's "
        f"steps_per_sec by step: a world of one {rates['distributed']}, one "
        f"device {rates['plain']}, one device with the host pipeline "
        f"{rates['python']}; synchronized: a world of one "
        f"{rates['distributed_synced']!r}, one device "
        f"{rates['plain_synced']!r}, the host pipeline "
        f"{rates['python_synced']!r} ({card})")
    return errs, times, dict(tp, rates=rates, uneven_errs=uneven_errs,
                             uneven_times=uneven_times)


# -- phase 10: the last modules --------------------------------------------

FOLD_STEPS = 60  # 10b's decode, folded against unfolded
HELD = 3         # its first frames, held to a tolerance (the rest recorded)


def native_input(work, counts, rates, card):
    """10a: the train CLI with the C++ loader: ``--input_backend=native``
    trains, checkpoints and resumes (bf16, batch 32: run in phase 6's pool
    of train CLIs, its launch `counts`); ``auto`` picks the native loader
    (its log line) in a run over 9c's steps, whose synchronized steps/s
    stand beside 9c's host pipeline and card-resident corpus; and one batch
    of each host loader timed on the host.  Returns the train CLI's launch
    counts and the rates."""
    import copy

    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.data import native_loader
    from mint_tpu_torch.data import pipeline as data_pipeline
    from mint_tpu_torch.data import tfrecord

    t0 = time.perf_counter()
    model_dir = os.path.join(work, "ws1_auto")
    _, err, seconds = run_module("mint_tpu_torch.tools.train", [
        f"--config_path={CONFIG}", f"--model_dir={model_dir}",
        f"--steps={WS1_STEPS}", "--use_bfloat16", "--grad_clip_norm=1.0",
        "--input_backend=auto", "--summary_interval=10"], work)
    chosen = [b for b, line in BACKEND_LOG.items() if line in err]
    native = {"cli": _cli_rates(model_dir),
              "synced": _synced_rate(model_dir)}
    expect = expected_launches(WS1_STEPS, bf16=True, backwards=WS1_STEPS)
    got = logged_launches(err, "train CLI auto")
    log(f"train CLI bf16 --input_backend=auto chose {chosen} "
        f"({native_loader.library_path()}); batch {TRAIN_BATCH} x "
        f"{WS1_STEPS} steps in {seconds:.1f} s; steps_per_sec by step "
        f"{native['cli']}; synchronized {native['synced']!r} steps/s over "
        f"steps {WS1_FROM}-{WS1_STEPS - 10}; launches {got} ({card})")
    if chosen != ["native"] or got != expect:
        raise AssertionError(f"train CLI auto: chose {chosen}, launches "
                             f"{got}, want native and {expect}")
    log(f"native loader's question, bf16 batch {TRAIN_BATCH}, synchronized "
        f"steps/s over steps {WS1_FROM}-{WS1_STEPS - 10}: native loader "
        f"{native['synced']!r}, host pipeline {rates['python_synced']!r}, "
        f"card-resident corpus {rates['plain_synced']!r}; native at "
        f"{native['synced'] / rates['plain_synced']!r} of the card-resident"
        f" rate, python at "
        f"{rates['python_synced'] / rates['plain_synced']!r} ({card})")

    # One batch of each host loader, timed on the host, at batch 32 of the
    # flagship's windows over phase 6's corpus (each a reader thread ahead
    # of the caller: the steady rate of 40 batches after the first).
    pipe = load_pipeline_config(CONFIG)
    dataset = copy.deepcopy(pipe.train_dataset)
    dataset.data_files = os.path.join(work, dataset.data_files)
    params = data_pipeline.get_modality_to_param_dict(dataset)
    loaders = {
        "native": native_loader.NativeTrainLoader(
            tfrecord.glob(dataset.data_files), batch_size=TRAIN_BATCH,
            motion_input_len=params["motion"]["input_length"],
            target_len=params["motion"]["target_length"],
            target_shift=params["motion"]["target_shift"],
            audio_input_len=params["audio"]["input_length"],
            motion_dim_raw=params["motion"]["feature_dim"],
            audio_dim=params["audio"]["feature_dim"]),
        "python": data_pipeline.create_input(pipe.train_config, dataset,
                                             is_training=True)}
    host_ms = {}
    for name, loader in loaders.items():
        t1 = time.perf_counter()
        first = next(loader)
        t_first = time.perf_counter() - t1
        t1 = time.perf_counter()
        for _ in range(40):
            batch = next(loader)
        host_ms[name] = 1e3 * (time.perf_counter() - t1) / 40
        shapes = {k: tuple(np.asarray(v).shape) for k, v in batch.items()
                  if np.asarray(v).dtype == np.float32}
        getattr(loader, "close", lambda: None)()
        finite = all(np.isfinite(v).all() for v in map(np.asarray,
                                                       first.values())
                     if v.dtype == np.float32)
        log(f"host loader {name}: first batch {1e3 * t_first:.1f} ms, then "
            f"{host_ms[name]:.3f} ms a batch of {TRAIN_BATCH} (40 batches) "
            f"{shapes}; first batch finite {finite} ({card})")
        if not finite:
            raise AssertionError(f"host loader {name}: non-finite batch")
    log(f"phase 10a (native loader) in {time.perf_counter() - t0:.1f} s")
    return counts, dict(native, host_ms=host_ms)


def _ln_perturbed(model):
    """`model` with its LayerNorm affines moved off 1 and 0 (from a CPU
    generator seeded 5, as tests/test_fold.py moves them), so that the
    fold has work to do."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".norm_" in name:
                p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.device))
    return model


def _decode(model, inputs, steps):
    from mint_tpu_torch.infer import decoder

    return decoder.infer_auto_regressive(model, inputs, steps=steps).float()


def fold_on_card(work, run_dir, card):
    """10b: the LayerNorm-affine fold on the card.  The flagship's f32
    weights (LayerNorm affines moved off 1 and 0) folded: one forward
    and a 60-step decode against the unfolded model, f32 and bf16, the
    launches a folded decode step, batch-20 frames/s folded against
    unfolded, and the evaluator with ``fold_ln=True`` on phase 7's
    384-step bucket from the f32 train CLI's checkpoint.  Returns the
    folded bf16 decode's launches and the evaluator's."""
    import copy

    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.data import pipeline as data_pipeline
    from mint_tpu_torch.eval.evaluator import Evaluator
    from mint_tpu_torch.models import fold
    from mint_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    model32 = _ln_perturbed(flagship(torch.float32, "cuda"))
    state = model32.state_dict()
    model16 = flagship(torch.bfloat16, "cuda")
    model16.load_state_dict(state)
    folded32, _ = fold.fold_for_decode(model32, state)
    folded16, _ = fold.fold_for_decode(model16, state)

    rng = np.random.default_rng(2)
    motion = rng.standard_normal((1, 120, 225)).astype(np.float32) * 0.1
    audio = rng.standard_normal((1, 240, 35)).astype(np.float32) * 0.5
    inputs = {"motion_input": torch.from_numpy(motion).cuda(),
              "audio_input": torch.from_numpy(audio).cuda()}
    with torch.inference_mode():
        want = model32(inputs)
        got = folded32(inputs)
    err = (got - want).abs().max().item()
    log(f"fold f32 forward batch 1, folded vs unfolded on the card: "
        f"max_abs_err {err:.3e} (peak {want.abs().max().item():.3e}) tol "
        f"2e-4 (tests/test_fold.py's: the fold moves one rounding a "
        f"weight)")
    if not err <= 2e-4:
        raise AssertionError(f"folded f32 forward disagrees: {err}")

    audio = rng.standard_normal((1, FOLD_STEPS + 239, 35)).astype(
        np.float32) * 0.5
    inputs = {"motion_input": motion, "audio_input": audio}
    ref = _decode(model32, inputs, FOLD_STEPS)
    frames, launches = {}, {}
    for name, model in (("f32 folded", folded32), ("bf16 folded", folded16),
                        ("bf16", model16)):
        reset_launches()
        frames[name] = _decode(model, inputs, FOLD_STEPS)
        torch.cuda.synchronize()
        launches[name] = launch_counts()
    per_step = {name: (f - ref).abs().amax(dim=(0, 2))
                for name, f in frames.items()}
    peak = ref.abs().max().item()
    f32_held = per_step["f32 folded"][:HELD].max().item()
    f32_all = per_step["f32 folded"].max().item()
    plain16 = per_step["bf16"][:HELD].max().item()
    fold16 = per_step["bf16 folded"][:HELD].max().item()
    tol16 = 2 * plain16 + 2 * bf16_ulp(peak)
    log(f"fold decode batch 1 x {FOLD_STEPS} steps against the unfolded f32"
        f" decode: f32 folded first {HELD} frames max_abs_err "
        f"{f32_held:.3e} tol 2e-4, all {FOLD_STEPS} {f32_all:.3e} tol 5e-3 "
        f"(tests/test_fold.py's decode tolerance); bf16 folded first {HELD}"
        f" {fold16:.3e} tol {tol16:.3e} (twice the unfolded bf16 decode's "
        f"own {plain16:.3e}, plus 2 bf16 ulps of the peak {peak:.3e}), all "
        f"{FOLD_STEPS}: bf16 folded "
        f"{per_step['bf16 folded'].max().item():.3e}, bf16 unfolded "
        f"{per_step['bf16'].max().item():.3e}")
    if not (f32_held <= 2e-4 and f32_all <= 5e-3 and fold16 <= tol16
            and torch.isfinite(frames["bf16 folded"]).all()):
        raise AssertionError(f"folded decode disagrees: f32 {f32_held}, "
                             f"{f32_all}; bf16 {fold16} (tol {tol16})")
    for name, bf16 in (("f32 folded", False), ("bf16 folded", True)):
        expect = expected_launches(FOLD_STEPS, bf16, folded=True)
        log(f"fold decode {name}: launches {launches[name]} over "
            f"{FOLD_STEPS} steps, want {expect} (16 a step of each TPU "
            f"kernel's port; in bf16 32 affine-free LayerNorms, none with "
            f"parameters)")
        if launches[name] != expect:
            raise AssertionError(f"fold decode {name}: launches "
                                 f"{launches[name]}")

    rates = {}
    for dtype_name, pair in (("bf16", (model16, folded16)),
                             ("f32", (model32, folded32))):
        plain, folded = pair
        order = (("unfolded", plain), ("folded", folded), ("folded", folded),
                 ("unfolded", plain))
        for label, model in order:
            rates.setdefault((dtype_name, label), []).append(
                throughput(model, f"{dtype_name} {label}", card))
    log("fold decode batch 20 frames/s (unfolded, folded, folded, unfolded "
        "in turn): " + "; ".join(
            f"{d} {label} {r}" for (d, label), r in rates.items())
        + f" ({card})")
    del model32, model16, folded32, folded16
    torch.cuda.empty_cache()

    # The evaluator with fold_ln=True, bf16, on phase 7's 384-step bucket.
    pipe = load_pipeline_config(CONFIG)
    dataset = copy.deepcopy(pipe.eval_dataset)
    dataset.data_files = os.path.join(work, "short", dataset.data_files)
    short = [c for c in eval_clips() if 0 < true_steps(c[2]) < 1200]
    model = flagship(torch.bfloat16, "cuda")
    out = os.path.join(work, "out_bf16_folded")
    evaluator = Evaluator(
        model, lambda: data_pipeline.create_input(
            pipe.eval_config, dataset, is_training=False, use_tpu=False),
        output_dir=out, steps_bucket=EVAL_BUCKET, fold_ln=True)
    params = CheckpointManager(run_dir).restore_params(model.state_dict())
    reset_launches()
    evaluator.evaluate(params)
    torch.cuda.synchronize()
    eval_counts = launch_counts()
    check_clips(out, short, "Evaluator(fold_ln=True) bf16")
    steps = sum(n for _, _, n in dispatch_plan(short, evaluator.decode_batch))
    expect = expected_launches(steps, True, folded=True)
    held, drift = {}, {}
    for label, other in (("unfolded bf16", "out_bf16"),
                         ("folded bf16", "out_bf16_folded")):
        gaps = [np.abs(np.load(os.path.join(work, other, f"{m}_{a}.npy"))
                       - np.load(os.path.join(work, "out_f32",
                                              f"{m}_{a}.npy")))[SEED_FRAMES:]
                for m, a, _ in short]
        held[label] = max(g[:HELD].max() for g in gaps)
        drift[label] = max(g.max() for g in gaps)
    peak = max(np.abs(np.load(os.path.join(work, "out_f32", f"{m}_{a}.npy"))
                      [SEED_FRAMES:]).max() for m, a, _ in short)
    tol = 2 * held["unfolded bf16"] + 2 * bf16_ulp(peak)
    log(f"Evaluator(fold_ln=True) bf16 on the 384-step bucket: launches "
        f"{eval_counts}, want {expect} ({steps} decode steps); against the "
        f"evaluate CLI's f32 clips, first {HELD} frames: folded "
        f"{held['folded bf16']:.3e} tol {tol:.3e} (twice the unfolded bf16 "
        f"clips' {held['unfolded bf16']:.3e}, plus 2 bf16 ulps of the peak),"
        f" all frames: folded {drift['folded bf16']:.3e}, unfolded "
        f"{drift['unfolded bf16']:.3e}")
    if eval_counts != expect or not held["folded bf16"] <= tol:
        raise AssertionError(f"Evaluator(fold_ln=True): launches "
                             f"{eval_counts}, first frames "
                             f"{held['folded bf16']} (tol {tol})")
    del model, evaluator
    torch.cuda.empty_cache()
    log(f"phase 10b (the fold) in {time.perf_counter() - t0:.1f} s")
    return launches["bf16 folded"], eval_counts, {
        k: float(np.mean(v)) for k, v in rates.items()}


def last_modules(work, run_dir, native_counts, rates, card):
    """Phase 10: the native loader (a), the fold (b); (c), the kernels at
    a model = 4 rank's uneven heads, runs in phase 9a."""
    counts, loader = native_input(work, native_counts, rates, card)
    fold_launches, eval_counts, fold_rates = fold_on_card(work, run_dir,
                                                          card)
    return {"train_launches": counts, "loader": loader,
            "fold_launches": fold_launches, "eval_launches": eval_counts,
            "fold_rates": fold_rates}


# -- phase 11: configs past the old limits ------------------------------------

# 11a: (dtype names, B, H, Nq, Nk, D) of attention, each at once past a limit
# the kernels had: bf16 keys past the resident schedule (the streamed
# kernel; 48 queries against 1320 keys, the final block of a streamed
# decode), head dims over 128 (the f32 wide kernel and the bf16 streamed
# one; 264 past 256, in two output chunks on the grid's z axis), bf16 head
# dims no multiple of 16 (and of 8: 67), and more (batch, head) pairs than
# one grid takes (65540); q[20,12,360,64], the width hidden 804's heads
# would have at a multiple of 8; and views of rows 84 elements apart over
# 80 columns (every other row 8 bytes past a 16-byte step: tma_pairs, as
# hidden 804's D = 67 views); and heads past the resident-Q kernels'
# widths (f32 264, and 520 in both, 1032 (f32), 1360 (bf16) and 2048
# (both) at batch 2: the scores-once kernels, each score once a call into
# a workspace, normalised there, P.V over output chunks reading P; bf16
# 264, two output chunks of the streamed kernel).  Each the model's fused
# QKV views but the "rows84" one.
WIDE_ATTENTION = [(("bf16",), 20, 10, 1320, 1320, 80),
                  (("bf16",), 20, 10, 48, 1320, 80),
                  (("bf16",), 20, 8, 720, 720, 128)] + [
    (("f32", "bf16"), 20, h, 360, 360, d)
    for h, d in ((8, 130), (4, 192), (4, 256), (4, 264), (4, 520), (16, 50),
                 (12, 67), (12, 64))] + [
    (("f32", "bf16"), 6554, 10, 48, 120, 80),
    (("bf16",), 20, 10, 360, 360, 80, "rows84"),
    (("f32",), 2, 4, 360, 360, 1032),
    (("bf16",), 2, 4, 360, 360, 1360),
    (("f32", "bf16"), 2, 4, 360, 360, 2048)]
# (dtype names, M, H, F, O[, x's layout]) of the fused MLP: F no multiple
# of 8 (f32) or of fc1's 192-column tile (bf16: 16 tiles of 200), H = O =
# 804 (bf16: rows 8 bytes past a 16-byte step every other row, fc1 on
# tma_pairs, fc2 in 4 tiles of 208) at the decode's M and at M = 960 (fc2
# split over K), and in bf16 F = 3070 and 3068 (W2's rows in 4 and 2
# phases off the 16-byte step: fc2 on tma_phases, at M = 960 split over
# K), an odd O (single stores), x on a base 2 bytes past 16 (staged), and
# hidden 804 at M = 192 (batch 4's last block: fc1 on tma_pairs split
# over K).
WIDE_MLP = [(("f32",), 7200, 800, 3070, 800),
            (("bf16",), 7200, 800, 3080, 800),
            (("f32", "bf16"), 7200, 804, 3072, 804),
            (("bf16",), 7200, 800, 3070, 800),
            (("bf16",), 7200, 800, 3068, 800),
            (("bf16",), 960, 800, 3070, 800),
            (("bf16",), 7200, 800, 3072, 801),
            (("bf16",), 7200, 800, 3072, 800, "x_off2"),
            (("bf16",), 960, 804, 3072, 804),
            (("bf16",), 192, 804, 3072, 804)]
WIDE_LN = [(7200, 1040), (7200, 1041), (7200, 2048)]  # bf16 LayerNorm rows
# 11b: the flagship with one geometry field changed, each a config the
# kernels once refused (tests/test_torch_ops.py's LIMIT_CASES), then a
# 720-key D = 128 config and hidden 804 over 12 heads.
LIMIT_CONFIGS = {
    "head_dim_over_128": dict(hidden=1040, heads=8),
    "bf16_head_dim_step": dict(heads=16),
    "bf16_keys": dict(audio_seq=1200),
    "f32_mlp_width": dict(mlp_width=3070),
    "bf16_mlp_width": dict(mlp_width=3080),
    "bf16_layer_norm": dict(hidden=1040, heads=13),
    "keys_720_d128": dict(hidden=1024, heads=8, audio_seq=600),
    "hidden_804": dict(hidden=804, heads=12),
}
LIMIT_DECODE = (4, 8)  # 11b's decode: batch, steps
# 11b's configs whose decode reaches the redesigned kernels (the f32 wide
# attention kernel, the bf16 streamed one, heads read in place at D = 50
# and 67, on tma_pairs at 67; the bf16 MLP's 200- and 208-column tiles and
# fc1 on tma_pairs at hidden 804, its 200-column fc1 at F = 3080, and fc2
# on tma_phases at F = 3070): their graphed decode is timed.
LIMIT_TIMED = ("head_dim_over_128", "bf16_keys", "keys_720_d128",
               "bf16_head_dim_step", "hidden_804", "bf16_mlp_width",
               "f32_mlp_width")
LIMIT_TRAIN = 2        # 11b's train batch
WIDE_AXIS = dict(hidden_size=48, heads=2, intermediate_size=64)  # 11c
WIDE_AXIS_RANKS = 4


def _wide_row(name, shape, err, ok, tol, t_k, t_p, t_l, work, peak, card,
              library=None, kernels=None):
    """One 11a row: max_abs_err against the plain version, whether it is
    within the tolerance `tol` states, times, bound, and the device
    kernels a call runs where given; logged."""
    b_ms, b_by = bound(*work, peak)
    log(f"{name} {shape}: max_abs_err {err:.3e}, tol {tol} "
        f"{'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
        f", library {'none' if t_l is None else f'{t_l:.4f} ms'}, bound "
        f"{b_ms:.4f} ms ({b_by})"
        + (f" [{', '.join(kernels)}]" if kernels else "") + f" ({card})")
    if not ok:
        raise AssertionError(f"{name} {shape} disagrees: {err}")
    row = {"shape": shape, "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
           "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by}
    if library:
        row["library"] = library
    if kernels:
        row["device_kernels"] = list(kernels)
    return row


def wide_kernels(att, mlp, ln, gen, card):
    """11a: each kernel at the shapes of WIDE_ATTENTION, WIDE_MLP and
    WIDE_LN against its plain version, at phase 2's tolerance for its
    dtype, timed beside its plain version, its bound and, where one
    PyTorch call computes it, that call (attention past 256 columns:
    SDPA's math backend, the one that takes such heads).  Returns
    {(kernel, dtype name): {shape: row}}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(q, k, v, d):
        if d <= 256:
            return F.scaled_dot_product_attention(q, k, v, scale=SCALE)
        with sdpa_kernel(SDPBackend.MATH):
            return F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    rows = {}
    for names, b, h, nq, nk, d, *layout in WIDE_ATTENTION:
        for name in names:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
            q, k, v = _qkv(*(layout or ["fused"]), b, h, nq, nk, d, dtype,
                           gen)
            got = att.attention(q, k, v, SCALE)
            torch.cuda.synchronize()
            want = att.attention_reference(q, k, v, SCALE)
            err = (got.float() - want.float()).abs().max().item()
            tol = (1e-5 if name == "f32"
                   else 2 * bf16_ulp(want.float().abs().max().item()))
            del got, want
            shape = (f"q[{b},{h},{nq},{d}] k[{b},{h},{nk},{d}]"
                     + "".join(f" {x}" for x in layout))
            rows.setdefault(("attention", name), {})[shape] = _wide_row(
                f"attention {name}", shape, err, err <= tol, f"{tol:.3e}",
                cuda_ms(lambda: att.attention(q, k, v, SCALE), 5),
                cuda_ms(lambda: att.attention_reference(q, k, v, SCALE), 3),
                cuda_ms(lambda: sdpa(q, k, v, d), 5),
                attention_work(b, h, nq, nk, d, dtype.itemsize), name, card,
                "scaled_dot_product_attention" + (
                    " (math backend)" if d > 256 else ""),
                att.device_kernels(q, k, v))
            del q, k, v
            torch.cuda.empty_cache()
    for names, m, hid, f, o, *layout in WIDE_MLP:
        for name in names:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
            w1, b1, w2, b2 = mlp_weights(gen, dtype, h=hid, f=f, o=o)
            x = mlp_input(gen, m, hid, dtype, *layout)
            got = mlp.fused_mlp(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            want = mlp.mlp_reference(x, w1, b1, w2, b2)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            tol = 1e-5 * max(1.0, peak) if name == "f32" else 2 * bf16_ulp(
                peak)
            shape = (f"x[{m},{hid}] W1[{hid},{f}] W2[{f},{o}]"
                     + "".join(f" {x}" for x in layout))
            rows.setdefault(("fused_mlp", name), {})[shape] = _wide_row(
                f"fused_mlp {name}", shape, err, err <= tol, f"{tol:.3e}",
                cuda_ms(lambda: mlp.fused_mlp(x, w1, b1, w2, b2), 5),
                cuda_ms(lambda: mlp.mlp_reference(x, w1, b1, w2, b2), 3),
                None, mlp_work(m, hid, f, o, dtype.itemsize), name, card)
    for m, c in WIDE_LN:
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2
             + 0.5).bfloat16()
        for key, params in (("layer_norm", ln_params(gen, c)),
                            ("layer_norm_affine_free", (None, None))):
            got = ln.layer_norm(x, *params, 1e-5)
            torch.cuda.synchronize()
            want = ln.layer_norm_reference(x, *params, 1e-5)
            err = (got.float() - want.float()).abs()
            # phase 2's tolerance: 1 bf16 ulp of each output (floored at
            # the ulp of 2^-8).
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -8))) - 7)
            ulps = (err / ulp).max().item()
            affine = params[0] is not None
            rows.setdefault((key, "bf16"), {})[f"x[{m},{c}]"] = _wide_row(
                f"{key} bf16", f"x[{m},{c}]", err.max().item(), ulps <= 1.0,
                f"1 bf16 ulp of each output ({ulps:.2f})",
                cuda_ms(lambda: ln.layer_norm(x, *params, 1e-5)),
                cuda_ms(lambda: ln.layer_norm_reference(x, *params, 1e-5)),
                None if affine else cuda_ms(
                    lambda: F.layer_norm(x, (c,), eps=1e-5)),
                (8.0 * m * c, 2 * 2 * m * c + (8 * c if affine else 0)),
                "f32", card, None if affine else "layer_norm")
    return rows


def device_kernel_names(call, tries=3):
    """The names of the device kernels one `call` runs, as torch.profiler
    records them, after one call unprofiled.  A trace in which the
    profiler recorded no device event at all (CUPTI delivered none: a run
    of the card's checks once lost every event of one call) says nothing
    of the call, so the call is profiled again, up to `tries` times in
    all; a trace with any device event is returned as it is."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
        log(f"torch.profiler recorded no device event in try "
            f"{attempt + 1} of {tries}")
    return names


def one_kernel_a_call(att, gen, card):
    """11a: one bf16 attention call on the model's fused QKV views at head
    dims 50, 67 and 130 (hidden 800 over 16 heads, 804 over 12, 1040 over
    8; batch 20, 360 queries), and at 1360 and 2048 (4 heads, batch 2)
    runs the device kernels ops.attention.device_kernels names, each
    once, and nothing else, as torch.profiler records it: one (the resident,
    tma_pairs and streamed kernels), or the three scores-once kernels
    (their workspace comes from the caching allocator, no fill): the
    kernels read the heads where they lie (a route that copied them into
    zero-padded rows ran a fill and a copy of each of q, k and v besides).
    Returns {D: kernels}."""
    counts = {}
    for b, h, d in ((DISPATCH, 16, 50), (DISPATCH, 12, 67),
                    (DISPATCH, 8, 130), (2, 4, 1360), (2, 4, 2048)):
        q, k, v = _qkv("fused", b, h, 360, 360, d, torch.bfloat16, gen)
        want = att.device_kernels(q, k, v)
        names = device_kernel_names(lambda: att.attention(q, k, v, SCALE))
        counts[d] = len(names)
        log(f"attention bf16 q[{b},{h},360,{d}] on the model's views "
            f"({', '.join(att.bf16_route(t) for t in (q, k, v))}): "
            f"{len(names)} device kernel(s) a call, want {len(want)} "
            f"({', '.join(want)}): {[n[:60] for n in names]} ({card})")
        if len(names) != len(want) or not all(
                sum(w in n for n in names) == 1 for w in want):
            raise AssertionError(f"bf16 attention at D = {d} ran "
                                 f"{len(names)} device kernels: {names}, "
                                 f"want {want}")
    return counts


def mlp_kernels_a_call(mlp, gen, card):
    """11a: one bf16 fused MLP call at hidden 804 (M = 7200 and the split
    M = 960), at F = 3080 and at F = 3070 (fc2 on tma_phases; M = 960
    split) on the model's operands (nn.Linear's weights as .t() views)
    runs its two GEMM passes and, where K is split, their reduce, and no
    other device kernel, as torch.profiler records it: the kernel reads
    every operand where it lies (a route that padded x and W1 first ran six
    or seven kernels).  Returns {shape: kernels}."""
    counts = {}
    for m, h, f, o in ((7200, 804, 3072, 804), (960, 804, 3072, 804),
                       (7200, 800, 3080, 800), (7200, 800, 3070, 800),
                       (960, 800, 3070, 800)):
        w1, b1, w2, b2 = mlp_weights(gen, torch.bfloat16, h=h, f=f, o=o)
        x = mlp_input(gen, m, h, torch.bfloat16)
        names = device_kernel_names(lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
        gemms = sum("gemm_tc" in n for n in names)
        others = [n for n in names if "gemm_tc" not in n
                  and "reduce_tc" not in n]
        shape = f"x[{m},{h}] W1[{h},{f}] W2[{f},{o}]"
        counts[shape] = len(names)
        xo, w1t, _, w2t, _ = mlp._operands(x, w1, b1, w2, b2)
        plan = mlp.bf16_plan(xo, w1t, w2t)
        log(f"fused_mlp bf16 {shape} on the model's operands (tiles "
            f"{plan.tiles}, loads {'/'.join(plan.loads)}): {len(names)} "
            f"device kernel(s) a call, want 2 GEMMs and a reduce a split "
            f"pass: {[n[:50] for n in names]} ({card})")
        if gemms != 2 or others or len(names) > 4:
            raise AssertionError(f"bf16 fused MLP at {shape} ran {names}")
    return counts


def limit_config(hidden=800, heads=10, mlp_width=3072, audio_seq=240):
    """The flagship's config with one geometry field changed."""
    from mint_tpu_torch.config.schema import load_pipeline_config

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    fact = cfg.fact_model
    for tf in [m.model[0].transformer for m in fact.modality] + [
            fact.cross_modal_model.transformer]:
        tf.hidden_size, tf.num_attention_heads = hidden, heads
        tf.intermediate_size = mlp_width
    fact.modality_by_name("audio").sequence_length = audio_seq
    return cfg


def _takes_backward(hidden, heads):
    """1 if the attention backward kernels take the bf16 model's views at
    `hidden` over `heads` heads (ops.attention.backward_kernels), else 0."""
    from mint_tpu_torch.ops import attention as att
    d = hidden // heads
    qkv = torch.empty(1, 2, 3, heads, d, device="cuda", dtype=torch.bfloat16)
    return int(bool(att.backward_kernels(
        *qkv.permute(2, 0, 3, 1, 4).unbind(0))))


def _rel_l2(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def limit_reference(cfg):
    """11b's CPU side of one config: its weights (a CPU generator's, seed
    0), the inputs of its decode (LIMIT_DECODE) and of its train step
    (LIMIT_TRAIN), the CPU's decode of the first row, and the CPU's loss
    and gradients.  It touches no CUDA, so it runs in a thread beside the
    card's work (limit_references), graph captures included."""
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.train import Trainer, schedules

    t0 = time.perf_counter()
    b, steps = LIMIT_DECODE
    cpu = init_params(builder.build(cfg, is_training=True, device="cpu"),
                      torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    audio_seq = cpu.audio_seq_length
    inputs = {"motion_input": rng.standard_normal(
                  (b, 120, 225)).astype(np.float32) * 0.5,
              "audio_input": rng.standard_normal(
                  (b, steps + audio_seq - 1, 35)).astype(np.float32) * 0.5}
    batch = {"motion_input": rng.standard_normal(
                 (LIMIT_TRAIN, 120, 225)).astype(np.float32) * 0.5,
             "audio_input": rng.standard_normal(
                 (LIMIT_TRAIN, audio_seq, 35)).astype(np.float32) * 0.5,
             "target": rng.standard_normal(
                 (LIMIT_TRAIN, 20, 225)).astype(np.float32) * 0.5}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cpu.eval()
    want = decoder.infer_auto_regressive(
        cpu, {k: v[:1] for k, v in inputs.items()}, steps=steps)
    cpu.train()
    want_loss, want_grads = Trainer(cpu, schedules.constant(0.0)
                                    ).loss_and_grads(
        dict(cpu.named_parameters()), batch)
    return {"weights": cpu.state_dict(), "inputs": inputs, "batch": batch,
            "want": want, "want_loss": float(want_loss),
            "want_grads": want_grads, "seconds": time.perf_counter() - t0}


def limit_references():
    """Starts 11b's CPU references, the LIMIT_CONFIGS one after another in
    a thread of their own: {config: Future of limit_reference}."""
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-11b")
    futures = {case: pool.submit(limit_reference, limit_config(**change))
               for case, change in LIMIT_CONFIGS.items()}
    pool.shutdown(wait=False)
    return futures


def limit_configs(card, references):
    """11b: each LIMIT_CONFIGS config at full width and depth, built on the
    card in f32 and in bf16 (the whole-model cast, and bf16 compute for
    training), its weights and CPU results `references`' (computed in a
    thread beside this work, limit_references): a decode of LIMIT_DECODE
    (batch, steps) through the decode's CUDA graph, its first row against
    the same decode on the CPU (f32: 1e-3, phase 4's; bf16: 0.1 relative L2
    over every frame against the CPU's f32, phase 6a's bf16 rule: bf16
    rounding through 16 blocks, where a wrong kernel gives an error of
    order 1), and the launches counted through capture and replays; one
    train step's loss and gradients at batch LIMIT_TRAIN against the CPU's
    (f32: loss 1e-5 relative, gradients 1e-4 of each leaf's peak; bf16
    compute: loss 1e-2 relative as 9b's, gradients 0.1 relative L2 of all
    and of each leaf as 6a's), 16 launches of each kernel a forward (32
    LayerNorms in bf16), and the step through the trainer's graph finite.
    The LIMIT_TIMED configs' decode runs again, timed (ms a step, every
    step a graph replay), once every CPU reference is done, so that the
    thread's work is not in the reading.  Returns ({(config, dtype name):
    launches}, {(config, dtype name): ms a step})."""
    from mint_tpu_torch.infer import decoder
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.train import Trainer, schedules

    b, steps = LIMIT_DECODE
    counted, timed, to_time = {}, {}, []
    for case, change in LIMIT_CONFIGS.items():
        t0 = time.perf_counter()
        cfg = limit_config(**change)
        ref = references[case].result()
        t_wait = time.perf_counter() - t0
        weights, inputs, batch = ref["weights"], ref["inputs"], ref["batch"]
        want, want_loss, want_grads = (ref["want"], ref["want_loss"],
                                       ref["want_grads"])
        for name in ("f32", "bf16"):
            bf16 = name == "bf16"
            dtype = torch.bfloat16 if bf16 else torch.float32
            model = builder.build(cfg, is_training=False, dtype=dtype,
                                  device="cuda")
            model.load_state_dict(weights)
            reset_launches()
            got = decoder.infer_auto_regressive(model, inputs, steps=steps)
            torch.cuda.synchronize()
            counts = launch_counts()
            expect = expected_launches(steps, bf16)
            got = got.float().cpu()
            finite = bool(torch.isfinite(got).all())
            if bf16:
                err, tol = _rel_l2(got[:1], want), 0.1
                what = "relative L2 of the first row against the CPU's f32"
            else:
                err, tol = (got[:1] - want).abs().max().item(), 1e-3
                what = "max_abs_err of the first row against the CPU"
            log(f"limit config {case} {name}: decode batch {b} x {steps} "
                f"steps through its graph, {what} {err:.3e} (tol {tol:.0e}),"
                f" finite {finite}; launches {counts}, want {expect} "
                f"({card})")
            if not (err <= tol and finite and counts == expect):
                raise AssertionError(f"limit config {case} {name} decode: "
                                     f"{err}, finite {finite}, {counts}")
            counted[case, name] = counts
            if case in LIMIT_TIMED:
                to_time.append((case, name, model))
            del model
            model = builder.build(cfg, is_training=True, device="cuda",
                                  compute_dtype=dtype if bf16 else None)
            model.load_state_dict(weights)
            trainer = Trainer(model, schedules.constant(1e-4))
            state = trainer.init_state(model)
            cuda_batch = {k: v.cuda() for k, v in batch.items()}
            reset_launches()
            loss, grads = trainer.loss_and_grads(state.params, cuda_batch)
            torch.cuda.synchronize()
            counts = launch_counts()
            loss = float(loss)
            rel = abs(loss - want_loss) / abs(want_loss)
            if bf16:
                per_leaf = {k: _rel_l2(grads[k].cpu(), g)
                            for k, g in want_grads.items()}
                overall = _rel_l2(
                    torch.cat([grads[k].cpu().reshape(-1)
                               for k in want_grads]),
                    torch.cat([g.reshape(-1) for g in want_grads.values()]))
                loss_tol, grad_tol = 1e-2, 0.1
            else:
                per_leaf = {k: (grads[k].cpu() - g).abs().max().item()
                            / max(g.abs().max().item(), 1e-30)
                            for k, g in want_grads.items()}
                overall, loss_tol, grad_tol = 0.0, 1e-5, 1e-4
            worst = max(per_leaf, key=per_leaf.get)
            state, metrics = trainer.train_step(state, cuda_batch)
            stepped = float(metrics["loss"])
            expect = expected_launches(1, bf16, backwards=_takes_backward(
                change.get("hidden", 800), change.get("heads", 10)))
            log(f"limit config {case} {name}: train batch {LIMIT_TRAIN} "
                f"loss {loss:.6f} vs CPU {want_loss:.6f} (rel {rel:.2e}, tol "
                f"{loss_tol:.0e}); worst gradient {per_leaf[worst]:.3e} "
                f"({worst}; tol {grad_tol:.0e}"
                + (f", all {overall:.3e}" if bf16 else " of the leaf's peak")
                + f"); launches a forward {counts}, want {expect}; "
                f"train_step loss {stepped:.6f} ({card})")
            if (not rel <= loss_tol or not per_leaf[worst] <= grad_tol
                    or not overall <= grad_tol or counts != expect
                    or not math.isfinite(stepped)):
                raise AssertionError(f"limit config {case} {name} train: "
                                     f"{rel}, {worst} {per_leaf[worst]}, "
                                     f"{overall}, {counts}, {stepped}")
            del model, trainer, state, grads
            torch.cuda.empty_cache()
        log(f"limit config {case} in {time.perf_counter() - t0:.1f} s "
            f"(waited {t_wait:.1f} s for its CPU reference, which took "
            f"{ref['seconds']:.1f} s in its thread)")
        del ref, weights, want_grads
    # Again, every step a replay, with the CPU references done.
    for case, name, model in to_time:
        inputs = references[case].result()["inputs"]
        t1 = time.perf_counter()
        decoder.infer_auto_regressive(model, inputs, steps=steps)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / steps
        timed[case, name] = ms
        log(f"limit config {case} {name}: graphed decode batch {b} "
            f"{ms:.3f} ms/step ({card})")
    to_time.clear()
    torch.cuda.empty_cache()
    return counted, timed


def wide_axis_rank(rank: int, port: int, work: str) -> None:
    """One of 11c's gloo ranks on cuda:0 (``chip_smoke.py --wide-rank R
    --wide-port P --wide-work DIR``): a (data 1, model WIDE_AXIS_RANKS)
    mesh over the tiny config of WIDE_AXIS (2 heads: groups of 2 ranks a
    head), the rank's slice of ``full.pt``; the f32 loss and gradients of
    ``batch.pt`` and the forward's launches, then one train step and the
    loss after it; rank 0 saves them, the gradients and the stepped
    parameters gathered whole, in ``rank0.pt``."""
    import torch.distributed as dist
    from mint_tpu_torch.config import schema as S
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.parallel import mesh as mesh_lib
    from mint_tpu_torch.parallel.dryrun import tiny_fact_config
    from mint_tpu_torch.train import Trainer, schedules

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WIDE_AXIS_RANKS, rank=rank)
    try:
        mesh = mesh_lib.make_mesh(data=1, model=WIDE_AXIS_RANKS,
                                  device="cuda:0")
        cfg = S.MultiModalModelConfig(
            fact_model=tiny_fact_config(**WIDE_AXIS))
        model = builder.build(cfg, is_training=True, device="cuda:0",
                              mesh=mesh)
        full = torch.load(os.path.join(work, "full.pt"), weights_only=True)
        model.load_state_dict(mesh_lib.shard_state_dict(
            full, mesh, mesh_lib.attention_heads(model)))
        batch = {k: v.cuda() for k, v in torch.load(
            os.path.join(work, "batch.pt"), weights_only=True).items()}
        trainer = Trainer(model, schedules.constant(1e-3), mesh=mesh)
        state = trainer.init_state(model)
        with torch.no_grad():
            reset_launches()
            trainer.loss(state.params, batch)
            torch.cuda.synchronize()
            counts = launch_counts()
        loss, grads = trainer.loss_and_grads(state.params, batch)
        gathered = mesh_lib.gather_state_dicts([grads], mesh)
        state, _ = trainer.train_step(state, batch)
        with torch.no_grad():
            after = float(trainer.loss(state.params, batch))
        stepped = mesh_lib.gather_state_dicts([state.params], mesh)
        if rank == 0:
            torch.save({"loss": float(loss), "launches": counts,
                        "grads": gathered[0], "loss_after": after,
                        "params": stepped[0]},
                       os.path.join(work, "rank0.pt"))
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()


def wide_model_axis(work, card):
    """11c: WIDE_AXIS_RANKS gloo ranks on cuda:0 over the 2-head tiny
    config (each head gathered from a group of 2 ranks holding 12 of its
    24 columns) against one rank on the card, same weights and batch: f32
    loss 1e-5 relative, every gradient 1e-4 of its leaf's peak, 6 launches
    of each kernel a forward a rank (the config's 6 blocks; each rank runs
    its whole head), the loss after one step 1e-5 relative and the stepped
    parameters within 2e-5, as 9b holds 2 ranks to one.  Returns the
    numbers."""
    from mint_tpu_torch.config import schema as S
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.parallel.dryrun import (free_port, run_ranks,
                                                tiny_fact_config)
    from mint_tpu_torch.train import Trainer, schedules

    t0 = time.perf_counter()
    wide_dir = os.path.join(work, "wide_axis")
    os.makedirs(wide_dir)
    cfg = S.MultiModalModelConfig(fact_model=tiny_fact_config(**WIDE_AXIS))
    model = init_params(builder.build(cfg, is_training=True, device="cpu"),
                        torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), os.path.join(wide_dir, "full.pt"))
    rng = np.random.default_rng(12)
    batch = {"motion_input": rng.standard_normal((3, 8, 9), np.float32),
             "audio_input": rng.standard_normal((3, 16, 35), np.float32),
             "target": rng.standard_normal((3, 4, 9), np.float32)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save(batch, os.path.join(wide_dir, "batch.pt"))
    port = free_port()
    run_ranks(lambda r: [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                         "--wide-rank", str(r), "--wide-port", str(port),
                         "--wide-work", wide_dir], WIDE_AXIS_RANKS,
              timeout=300)
    got = torch.load(os.path.join(wide_dir, "rank0.pt"), weights_only=True)
    one = builder.build(cfg, is_training=True, device="cuda")
    one.load_state_dict(model.state_dict())
    trainer = Trainer(one, schedules.constant(1e-3))
    state = trainer.init_state(one)
    cuda_batch = {k: v.cuda() for k, v in batch.items()}
    loss, grads = trainer.loss_and_grads(state.params, cuda_batch)
    state, _ = trainer.train_step(state, cuda_batch)
    with torch.no_grad():
        after = float(trainer.loss(state.params, cuda_batch))
    rel = abs(got["loss"] - float(loss)) / abs(float(loss))
    per_leaf = {k: (got["grads"][k].cuda() - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30) for k, g in grads.items()}
    worst = max(per_leaf, key=per_leaf.get)
    step_rel = abs(got["loss_after"] - after) / abs(after)
    moved = max((got["params"][k].cuda() - v).abs().max().item()
                for k, v in state.params.items())
    expect = {"attention": 6, "attention_backward": 0, "fused_mlp": 6,
              "layer_norm": 0, "layer_norm_affine_free": 0}
    log(f"model axis wider than the heads: {WIDE_AXIS_RANKS} gloo ranks on "
        f"cuda:0 over 2 heads vs one rank, f32: loss {got['loss']:.6f} vs "
        f"{float(loss):.6f} (rel {rel:.2e}, tol 1e-5); worst gradient "
        f"{per_leaf[worst]:.3e} of its leaf's peak ({worst}; tol 1e-4); "
        f"launches a forward of rank 0 {got['launches']}, want {expect}; "
        f"after one step: loss rel {step_rel:.2e} (tol 1e-5), parameters "
        f"max_abs_err {moved:.3e} (tol 2e-5); phase 11c in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    if (not rel <= 1e-5 or not per_leaf[worst] <= 1e-4
            or got["launches"] != expect or not step_rel <= 1e-5
            or not moved <= 2e-5):
        raise AssertionError(f"model axis wider than the heads: {rel}, "
                             f"{worst} {per_leaf[worst]}, "
                             f"{got['launches']}, {step_rel}, {moved}")
    return {"loss_rel": rel, "worst_grad": per_leaf[worst],
            "step_loss_rel": step_rel, "max_abs_err": moved,
            "launches_per_forward_per_rank": got["launches"]}


def past_old_limits(att, mlp, ln, gen, work, card):
    """Phase 11: the kernels at the new shapes (a), the configs the
    kernels once refused at full width and depth (b), and a model axis
    wider than the heads (c)."""
    t0 = time.perf_counter()
    references = limit_references()  # 11b's, on the CPU meanwhile
    rows = wide_kernels(att, mlp, ln, gen, card)
    rows["one_kernel_a_call"] = one_kernel_a_call(att, gen, card)
    rows["mlp_kernels_a_call"] = mlp_kernels_a_call(mlp, gen, card)
    log(f"phase 11a (kernels past the old limits) in "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    launches, decode_ms = limit_configs(card, references)
    log(f"phase 11b (configs past the old limits) in "
        f"{time.perf_counter() - t1:.1f} s")
    axis = wide_model_axis(work, card)
    log(f"phase 11 in {time.perf_counter() - t0:.1f} s")
    return rows, launches, decode_ms, axis


# -- phase 12: the product loop ---------------------------------------------

def product_loop(work, card):
    """Phase 12: ``scripts/torch_e2e_run.py --smoke`` in `work`, then its
    summary checked.  Returns the kernel launches each CLI logged: the
    resumed train run's (bf16) and each evaluate's, by dtype."""
    t0 = time.perf_counter()
    root = os.path.join(work, "e2e")
    # A process group of its own, so a timeout stops the CLI it runs too.
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "torch_e2e_run.py"),
         "--smoke", root], cwd=work, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"torch_e2e_run.py --smoke exited "
                           f"{proc.returncode}:\n{out[-6000:]}")
    with open(os.path.join(root, "e2e_summary.json")) as f:
        summary = json.load(f)
    size, stages = summary["size"], summary["stages"]
    killed, resumed = stages["train-killed"][-1], stages["train-resume"][-1]
    at_kill = summary["ckpts_at_kill"]
    resumed_steps = size["train_steps"] - resumed["restored_step"]
    launches = {("train", "bf16"): resumed["kernel_launches"],
                ("evaluate", "f32"): stages["evaluate"][-1]["kernel_launches"],
                ("evaluate", "bf16"):
                    stages["evaluate-bf16"][-1]["kernel_launches"]}
    scores = summary["scores"]
    log(f"product loop (torch_e2e_run.py --smoke, flagship): stages "
        f"{ {k: [r['wall_s'] for r in v] for k, v in stages.items()} } s; "
        f"killed at step {summary['step_at_kill']} with checkpoints "
        f"{at_kill} (partial writes {summary['partial_checkpoints_at_kill']})"
        f"; the resumed run restored {resumed['restored_step']} and ended "
        f"with {summary['ckpts_final']}; start-up of the killed / resumed "
        f"run {killed.get('startup_s')} / {resumed.get('startup_s')} s "
        f"(graph captures {killed['capture_s']} / {resumed['capture_s']} s), "
        f"steps/s {killed.get('steps_per_s')} / {resumed.get('steps_per_s')}"
        f"; losses {summary['loss_first']} -> {summary['loss_last']}; clips "
        f"f32 {summary['generated_clips']}, bf16 "
        f"{summary['generated_clips_bf16']}; scores {scores}, bf16 vs f32 "
        f"{summary['bf16_vs_f32_rel']}; launches {launches}; phase 12 in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    finite = all(math.isfinite(v) for d in scores.values()
                 for k, v in d.items() if k != "beat_clips")
    if (killed["ok"] != "killed" or not at_kill
            or max(at_kill) < size["checkpoint_interval"]
            or resumed["restored_step"] != max(at_kill)
            or max(summary["ckpts_final"]) != size["train_steps"]
            or launches["train", "bf16"]
            != expected_launches(resumed_steps, True,
                                 backwards=resumed_steps)
            or not summary["generated_clips"]
            or not summary["generated_clips_bf16"]
            or set(scores) != {"f32", "bf16"} or not finite
            or not all(launches["evaluate", dt][k] > 0
                       for dt in ("f32", "bf16")
                       for k in ("attention", "fused_mlp"))
            or not launches["evaluate", "bf16"]["layer_norm"] > 0):
        raise AssertionError(f"product loop: {json.dumps(summary)[:4000]}")
    return launches


# -- phase 13: EDGE ---------------------------------------------------------

EDGE_CONFIG = os.path.join(REPO, "mint_tpu_torch", "config",
                           "edge_jukebox.config")
# port_bench's diffuse_edge_bf16_s8 dispatch: 8 songs of 15 chunks of 150
# frames; a DDIM step's denoiser runs both branches of the 120 chunks, 240
# sequences of 150 rows of 512.
EDGE_SONGS, EDGE_CHUNKS, EDGE_SEQ, EDGE_WIDTH = 8, 15, 150, 512
EDGE_ROWS = 2 * EDGE_SONGS * EDGE_CHUNKS * EDGE_SEQ
# The erf-GELU MLP on each route that applies a GELU: (route, M, H, F, O,
# x's layout).  EDGE's feedforward at the cell's rows on TMA; the same at
# 240 rows, which the plan splits over K (the reduce kernel applies fc2's
# bias there, fc1's GELU still in the GEMM's epilogue); hidden 804 on
# tma_pairs; x 2 bytes past a 16-byte step on the staged loads; F = 3070
# (W2^T's rows off the step) on tma_phases.
EDGE_MLP = (("tma", EDGE_ROWS, 512, 1024, 512, "contiguous"),
            ("split", 240, 512, 1024, 512, "contiguous"),
            ("tma_pairs", 7200, 804, 3072, 804, "contiguous"),
            ("staged", 960, 800, 3072, 800, "x_off2"),
            ("tma_phases", 7200, 800, 3070, 800, "contiguous"))
# Attention at EDGE's shapes (8 heads of 64, scale 0.125): self-attention
# over the 240 sequences, the conditional chunks against their 152 memory
# rows, the unconditional rows against the one shared key set.
EDGE_ATTENTION = (("self", 240, 150, 240, 150),
                  ("conditional", 120, 150, 120, 152),
                  ("unconditional", 1, 120 * 150, 1, 152))


def _rel_diff(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def edge_kernels(att, mlp, gen, card):
    """13a: the FiLM residual, the rotation (with its LayerNorm, writing
    the normed rows and not; without, from a position past 0) and the
    erf-GELU MLP on each route against their plain versions at the cell's
    shapes, attention at EDGE's; each timed beside its plain version and
    its bound.  Returns {kernel: {case: row}}."""
    from mint_tpu_torch.ops import film

    rows, c, seq = EDGE_ROWS, EDGE_WIDTH, EDGE_SEQ
    out = {"film_residual": {}, "rotary": {}, "fused_mlp_erf": {},
           "attention": {}}
    h = torch.randn(rows, c, device="cuda", generator=gen).bfloat16()
    a = torch.randn(rows, c, device="cuda", generator=gen).bfloat16()
    gb = (0.3 * torch.randn(rows // seq, 2 * c, device="cuda",
                            generator=gen)).bfloat16()
    got, want = film.film_residual(h, a, gb, seq), film.film_reference(
        h, a, gb, seq)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # h and a read, the output written; gamma and beta a row a sequence.
    nbytes = 2 * (3 * rows * c + 2 * c * rows // seq)
    out["film_residual"]["step"] = _wide_row(
        "film_residual bf16", [rows, c], err, torch.equal(got, want),
        "bit-equal (f32 in PyTorch's order, one rounding)",
        cuda_ms(lambda: film.film_residual(h, a, gb, seq)),
        cuda_ms(lambda: film.film_reference(h, a, gb, seq)), None,
        (4.0 * rows * c, nbytes), "bf16", card)

    table = film.rotary_table(seq + 2, c, "cuda")
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    b = 0.1 * torch.randn(c, device="cuda", generator=gen)
    n, r = film.rotary(h, table, seq, 0, w, b, 1e-5, normed=True)
    n_ref = film.layer_norm_reference(h, w, b, 1e-5)
    torch.cuda.synchronize()
    err = (n.float() - n_ref.float()).abs().max().item()
    tol = bf16_ulp(n_ref.float().abs().max().item())
    ok = (err <= tol and torch.equal(r, film.rotary_reference(n, table, seq))
          and torch.equal(film.rotary(h, table, seq, 0, w, b, 1e-5), r))
    # x read, the normed rows and their rotation written; the table read
    # once from HBM.
    nbytes = 2 * 3 * rows * c + 4 * (seq + 2) * c + 8 * c
    out["rotary"]["layer_norm_normed"] = _wide_row(
        "rotary+layer_norm bf16 (normed rows written)", [rows, c], err, ok,
        f"the normed rows within one rounding ({tol:.3e}), the rotation of "
        "them and the unwritten call's bit-equal to the plain rotation",
        cuda_ms(lambda: film.rotary(h, table, seq, 0, w, b, 1e-5,
                                    normed=True)),
        cuda_ms(lambda: film.rotary_reference(
            film.layer_norm_reference(h, w, b, 1e-5), table, seq)), None,
        (12.0 * rows * c, nbytes), "bf16", card)
    # The music memory's rows (the conditional chunks, no LayerNorm), and
    # the two time tokens at positions seq and seq + 1.
    m = h[:rows // 2]
    got = film.rotary(m, table, seq)
    want = film.rotary_reference(m, table, seq)
    t = h[:2]
    ok = torch.equal(got, want) and torch.equal(
        film.rotary(t, table, 2, seq), film.rotary_reference(t, table, 2,
                                                              seq))
    out["rotary"]["plain"] = _wide_row(
        "rotary bf16 (memory rows; time tokens from position 150)",
        [rows // 2, c], (got.float() - want.float()).abs().max().item(), ok,
        "bit-equal", cuda_ms(lambda: film.rotary(m, table, seq)),
        cuda_ms(lambda: film.rotary_reference(m, table, seq)), None,
        (6.0 * rows // 2 * c, 2 * rows * c + 4 * (seq + 2) * c), "bf16",
        card)

    for route, m_rows, hd, f, o, layout in EDGE_MLP:
        x = mlp_input(gen, m_rows, hd, torch.bfloat16, layout)
        w1, b1, w2, b2 = mlp_weights(gen, torch.bfloat16, hd, f, o)
        got = mlp.fused_mlp(x, w1, b1, w2, b2, activation="erf")
        torch.cuda.synchronize()
        want = mlp.mlp_reference(x, w1, b1, w2, b2, "erf")
        tanh = mlp.mlp_reference(x, w1, b1, w2, b2, "tanh")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 * bf16_ulp(want.float().abs().max().item())
        ok = (err <= tol and got.shape == want.shape
              and _rel_diff(got, want) < 0.5 * _rel_diff(got, tanh))
        plan = mlp.bf16_plan(*mlp._operands(x, w1, b1, w2, b2)[:2],
                             mlp._operands(x, w1, b1, w2, b2)[3])
        out["fused_mlp_erf"][route] = dict(_wide_row(
            f"fused_mlp erf bf16 ({route}: tiles {plan.tiles}, loads "
            f"{plan.loads})", [m_rows, hd, f, o], err, ok,
            f"2 bf16 ulps at the output's peak ({tol:.3e}), and nearer the "
            "erf formula than the tanh one",
            cuda_ms(lambda: mlp.fused_mlp(x, w1, b1, w2, b2,
                                          activation="erf")),
            cuda_ms(lambda: mlp.mlp_reference(x, w1, b1, w2, b2, "erf")),
            None, mlp_work(m_rows, hd, f, o, 2), "bf16", card),
            layout=layout, rel_to_erf=_rel_diff(got, want),
            rel_to_tanh=_rel_diff(got, tanh))

    for name, bq, nq, bk, nk in EDGE_ATTENTION:
        q = torch.randn(bq, 8, nq, 64, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(bk, 8, nk, 64, device="cuda",
                            generator=gen).bfloat16() for _ in range(2))
        got = att.attention(q, k, v, 0.125)
        torch.cuda.synchronize()
        want = att.attention_reference(q, k, v, 0.125)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 * bf16_ulp(want.float().abs().max().item())
        flops, _ = attention_work(bq, 8, nq, nk, 64, 2)
        out["attention"][name] = _wide_row(
            f"attention bf16 (EDGE {name})", [bq, 8, nq, 64, bk, nk], err,
            err <= tol, f"2 bf16 ulps at the output's peak ({tol:.3e})",
            cuda_ms(lambda: att.attention(q, k, v, 0.125)),
            cuda_ms(lambda: att.attention_reference(q, k, v, 0.125)), None,
            (flops, 2 * 8 * 64 * (2 * bq * nq + 2 * bk * nk)), "bf16", card)
    return out


def edge_expected_launches(e) -> dict:
    """Kernel launches of one EDGE dispatch of config `e` (bf16): the music
    memory once (each encoder layer's self-attention, its rotation with
    LayerNorm, its second LayerNorm and feedforward; the condition
    vector's LayerNorm, the memory rows' LayerNorm and rotation for the
    conditional chunks and the null embedding), then each DDIM step (the
    time tokens' LayerNorm and rotation; each decoder layer's two
    rotations with their LayerNorms, self-attention, cross-attention in two
    key groups, the third LayerNorm, the feedforward and three FiLM
    residuals)."""
    enc, layers, steps = e.cond_encoder_layers, e.num_layers, \
        e.sampling_steps
    return {"attention": enc + steps * 3 * layers,
            "attention_backward": 0,
            "fused_mlp": enc + steps * layers,
            "film": steps * 3 * layers,
            "film_rotary": enc + 2 + steps * (1 + 2 * layers),
            "layer_norm": enc + 3 + steps * (1 + layers),
            "layer_norm_affine_free": 0,
            "edge_kv_projections": layers * (1 + steps)}


def edge_dispatch(card):
    """13b: the published EDGE (``EDGE_CONFIG``, bf16, weights seeded)
    through ``builder.build`` and ``EDGEFamily.predict`` at the cell's
    dispatch (8 songs of 15 chunks): set-up captures the step's graph,
    then one dispatch's kernel launches (every step a replay) must be
    :func:`edge_expected_launches`, and its frames/s are logged; a dispatch
    of 3 chunks (songs of 2 and 1) graphed against the same steps
    uncaptured, bit for bit.  Returns the dispatch's launches."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.infer import diffusion
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.multi_modal import EDGEFamily
    from mint_tpu_torch.utils import graphs

    cfg = load_pipeline_config(EDGE_CONFIG).multi_modal_model
    e = cfg.edge_model
    model = builder.build(cfg, is_training=False, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():  # matrices and embeddings drawn; biases and
        for p in model.parameters():  # LayerNorms as built
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                        * (2.0 / sum(p.shape[-2:])) ** 0.5)
    family = EDGEFamily(model)

    def inputs(chunks):
        total = sum(chunks)
        shape = (total, e.seq_len, e.nfeats)
        return {"cond": torch.randn(total, e.seq_len, e.cond_feature_dim,
                                    device="cuda", generator=gen),
                "chunks": chunks,
                "x_T": torch.randn(shape, device="cuda", generator=gen),
                "noise": torch.randn((e.sampling_steps - 1,) + shape,
                                     device="cuda", generator=gen)}
    small = inputs([2, 1])
    graphed = family.predict(small)
    eager = diffusion.sample(model, small["cond"], small["chunks"],
                             small["x_T"], small["noise"], graphed=False)
    equal = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    big = inputs([EDGE_CHUNKS] * EDGE_SONGS)
    t0 = time.perf_counter()
    family.predict(big)  # set-up: the step's graph captured
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for name in graphs._launches():
        graphs._set_launches(name, 0)
    t0 = time.perf_counter()
    songs = family.predict(big)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = graphs._launches()
    want = edge_expected_launches(e)
    frames = sum(s.shape[0] for s in songs)
    finite = all(bool(torch.isfinite(s).all()) for s in songs)
    log(f"EDGE (edge_jukebox.config, bf16) through EDGEFamily.predict: "
        f"{EDGE_SONGS} songs x {EDGE_CHUNKS} chunks, {e.sampling_steps} "
        f"steps: set-up {setup:.2f} s, a dispatch {seconds:.4f} s "
        f"({frames / seconds:.1f} frames/s, {1e3 * seconds / e.sampling_steps:.3f}"
        f" ms a step), launches {counts} (expected {want}), finite {finite}; "
        f"3 chunks graphed = uncaptured bit for bit: {equal}; peak "
        f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    if counts != want or not finite or not equal:
        raise AssertionError("EDGE dispatch: launches, finiteness or the "
                             "graph against the uncaptured steps")
    del model, family
    torch.cuda.empty_cache()
    return counts


def edge_path(att, mlp, gen, card):
    """Phase 13: :func:`edge_kernels`, then :func:`edge_dispatch`; the
    rows of the summary line's EDGE kernels.  The JAX package has no
    EDGE: these kernels replace no TPU kernel."""
    rows = edge_kernels(att, mlp, gen, card)
    counts = edge_dispatch(card)
    src = "mint_tpu_torch/csrc/film.cu"
    return [{"name": "film_residual_bf16", "route": "cuda", "source": src,
             "replaces": None,
             "device_kernels": ["mint_film::film_residual_kernel"],
             "launches_per_dispatch": counts["film"],
             **rows["film_residual"]["step"]},
            {"name": "rotary_bf16", "route": "cuda", "source": src,
             "replaces": None,
             "device_kernels": ["mint_film::rotary_kernel<true>",
                                "mint_film::rotary_kernel<false>"],
             "launches_per_dispatch": counts["film_rotary"],
             **rows["rotary"]["layer_norm_normed"],
             "plain_rotation": rows["rotary"]["plain"]},
            {"name": "fused_mlp_erf_bf16", "route": "cuda",
             "source": "mint_tpu_torch/csrc/mlp.cu", "replaces": None,
             "launches_per_dispatch": counts["fused_mlp"],
             **rows["fused_mlp_erf"]["tma"],
             "routes": rows["fused_mlp_erf"]},
            {"name": "attention_bf16_edge", "route": "cuda",
             "source": "mint_tpu_torch/csrc/attention.cu", "replaces": None,
             "launches_per_dispatch": counts["attention"],
             "shapes": rows["attention"]}]


def main(edge_only: bool = False):
    t_start = time.perf_counter()
    seconds, last_mark = {}, [t_start]

    def done(name):
        """The seconds since the last phase ended, as phase `name`'s."""
        now = time.perf_counter()
        seconds[name] = now - last_mark[0]
        last_mark[0] = now

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    # One line per captured graph: its key, seconds, launches a replay and
    # the pool bytes it added.
    logging.basicConfig(stream=sys.stdout, format="%(name)s: %(message)s")
    logging.getLogger("mint_tpu_torch.utils.graphs").setLevel(logging.INFO)
    from mint_tpu_torch.ops import _build
    from mint_tpu_torch.ops import attention as att
    from mint_tpu_torch.ops import layer_norm as ln
    from mint_tpu_torch.ops import mlp

    # f32 runs true f32 (the reference's scoring semantics): no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc {' '.join(_build.NVCC_FLAGS)} -c per source, all at "
        f"once, then nvcc -shared) from "
        f"{[os.path.relpath(p, REPO) for p in _build.sources()]}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    done("1 (card and build)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if edge_only:
        edge_rows = edge_path(att, mlp, gen, card)
        done("13 (EDGE)")
        for name, secs in seconds.items():
            log(f"phase {name}: {secs:.1f} s")
        print(json.dumps({"kernels": edge_rows}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    errs = {"attention": check_attention(att, gen),
            "fused_mlp": check_mlp(mlp, gen)}
    bwd_ulps = check_attention_backward(att, gen)
    ln_err, ln_free_err = check_layer_norm(ln, gen)
    errs["layer_norm"] = {"bf16": ln_err}
    errs["layer_norm_affine_free"] = {"bf16": ln_free_err}
    # The decode's shapes: Nq = Nk = 360 (11 blocks a step), 48 queries
    # against 360 keys (1), and the encoders' 240 and 120 (2 each); then
    # training's, at batch 32 with no truncated block.
    times = time_kernels(att, mlp, ln, gen, card, DISPATCH,
                         ((360, 360), (48, 360), (240, 240), (120, 120)),
                         (360, 48, 240, 120))
    train_times = time_kernels(att, mlp, ln, gen, card, TRAIN_BATCH,
                               ((360, 360), (240, 240), (120, 120)),
                               (360, 240, 120), host=False, backward=True)
    done("2 (kernels against their plain versions)")

    # Each dtype has its own kernel; its launches are those of its server,
    # and its launches a step those over that server's decode steps.
    launches, per_step = {}, {}
    model32 = flagship(torch.float32, "cuda")
    model16 = flagship(torch.bfloat16, "cuda")
    # Phase 4's CPU side, in a thread from here on.
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-4")
    reference = pool.submit(cpu_reference, {
        k: v.cpu() for k, v in model32.state_dict().items()})
    pool.shutdown(wait=False)
    for model, name in ((model32, "f32"), (model16, "bf16")):
        counts, steps = serve_requests(model, name)
        for k, n in counts.items():
            launches[k, name] = n
            per_step[k, name] = n / steps
    done("3 (the server)")
    card_vs_cpu(model32, reference)
    done("4 (card against CPU)")
    throughput(model16, "bf16", card)
    throughput(model32, "f32", card)
    done("5 (decode frames/s)")
    graph_launches = decode_graphs(
        ((model32, "f32"), (model16, "bf16")), card)[1]
    done("5b (decode graphs)")
    del model16, model32
    torch.cuda.empty_cache()

    train_gradients()
    train_graphs(card)
    train_launches = {}
    with tempfile.TemporaryDirectory() as work:
        write_corpus(os.path.join(work, "data"))
        # The runs at once, each in a model_dir of its own, 10a's with the
        # C++ loader among them: their processes' start-ups overlap (their
        # steps/s are logged, not held to anything; 6c, 9c and 10a time
        # the train step alone).
        runs = (("f32", "python"), ("bf16", "python"), ("bf16", "device"),
                ("bf16", "native"))
        with ThreadPoolExecutor(len(runs)) as pool:
            counted = dict(zip(runs, pool.map(
                lambda run: train_cli(work, *run, run=f"run_{'_'.join(run)}"),
                runs)))
        for (name, backend), counts in counted.items():
            if backend == "python":
                for k, n in counts.items():
                    train_launches[k, name] = n
            run = os.path.join(work, f"run_{name}_{backend}")
            if name == "f32":  # phase 7 scores this run's checkpoint
                os.rename(run, os.path.join(work, "f32_run"))
            else:
                shutil.rmtree(run)
        rate_bf16 = train_rate("bf16", card, steps=10)
        train_rate("f32", card, steps=5)
        done("6 (training)")
        eval_launches, eval_times = scoring_path(
            att, mlp, ln, gen, work, os.path.join(work, "f32_run"), card)
        done("7 (scoring)")
        music_path(work, os.path.join(work, "f32_run"), card)
        done("8 (music in)")
        shard_errs, shard_times, tp = across_ranks(att, mlp, ln, gen, work,
                                                   card)
        done("9 (ranks and replicas, checkpoints in)")
        log(f"train bf16 batch {TRAIN_BATCH} Trainer.train_step: one device "
            f"(6c) {rate_bf16:.3f} steps/s, a world of one NCCL rank (9c) "
            f"{tp['rates']['step_world_of_one']:.3f} steps/s ({card})")
        last = last_modules(work, os.path.join(work, "f32_run"),
                            counted["bf16", "native"], tp["rates"], card)
        done("10 (the last modules)")
        wide_rows, limit_launches, limit_ms, wide_axis = past_old_limits(
            att, mlp, ln, gen, work, card)
        done("11 (configs past the old limits)")
        e2e_launches = product_loop(work, card)
        done("12 (the product loop)")
    edge_rows = edge_path(att, mlp, gen, card)
    done("13 (EDGE)")
    # The affine-free LayerNorm runs on the folded decode (10b): its
    # launches there, a step, and in the folded evaluator's pass.
    free = "layer_norm_affine_free"
    launches[free, "bf16"] = last["fold_launches"][free]
    per_step[free, "bf16"] = last["fold_launches"][free] / FOLD_STEPS
    graph_launches[free, "bf16"] = per_step[free, "bf16"]
    eval_launches[free, "bf16"] = last["eval_launches"][free]

    # The bf16 LayerNorm kernel replaces no TPU kernel: it is Flax's
    # LayerNorm(dtype=bf16) with f32 parameters, which XLA fuses there;
    # its affine-free form is the same LayerNorm with use_scale=False and
    # use_bias=False, the folded model's (ln_affine_folded).
    sources = {"attention": ({"f32": "mint_tpu_torch/csrc/attention_f32.cu",
                               "bf16": "mint_tpu_torch/csrc/attention.cu"},
                              "mint_tpu/ops/attention.py:43", ("f32", "bf16")),
               "fused_mlp": ("mint_tpu_torch/csrc/mlp.cu",
                             "mint_tpu/ops/mlp.py:44", ("f32", "bf16")),
               "layer_norm": ("mint_tpu_torch/csrc/layer_norm.cu",
                              "mint_tpu/models/layers.py:143", ("bf16",)),
               free: ("mint_tpu_torch/csrc/layer_norm.cu",
                      "mint_tpu/models/layers.py:143", ("bf16",))}
    # Each row's times are at the batch-20 full shape (Nq or M/20 = 360);
    # "small" holds the same at the final block's 48 rows.  `launches` is
    # the serving path's count (through its graphs' captures and replays);
    # `graphed_launches_per_step` phase 5b's batch-20 decode of 60 steps,
    # every one a replay, over its steps; `train_launches` the train CLI's
    # first invocation's (4 steps), and "train" the times at the training
    # shapes (batch 32; Nq or M/32 = 360, 240, 120); `eval_launches` the
    # evaluate CLI's (f32: every clip; bf16: the 384-step bucket), and
    # "eval" the times at the eval's default decode batch (Nq or M/batch
    # = 360, 240, 120, 48); "tensor_parallel" phase 9's: the worst error
    # at a model = 2 rank's shapes, the times there at batch 32 (Nq or
    # M/32 = 360, 240, 120; 5 heads, F = 1536) and each rank's launches a
    # forward of phase 9b's run, and "uneven_heads" the same at a model = 4
    # rank's shapes (3 or 2 heads; F = 768).  The affine-free LayerNorm's
    # `launches` are the folded bf16 decode's (10b), its graphed and eager
    # launches a step that decode's, its `eval_launches` the folded
    # evaluator's pass.  `e2e_launches` are phase 12's: its resumed bf16
    # train run's and its evaluate runs' (f32 and bf16; none folded).
    # The device kernels each wrapper ran at 11a's shapes (attention: the
    # resident, tma_pairs, streamed and scores-once kernels).
    ran = {key: sorted({k for row in rows.values()
                        for k in row.get("device_kernels", ())})
           for key, rows in wide_rows.items() if isinstance(key, tuple)}
    kernels = [{"name": f"{name}_{dt}", "route": "cuda",
                "source": src if isinstance(src, str) else src[dt],
                "replaces": rep, "launches": launches[name, dt],
                "device_kernels": ran.get((name, dt)) or None,
                "launches_per_step": per_step[name, dt],
                "graphed_launches_per_step": graph_launches[name, dt],
                "train_launches": train_launches[name, dt],
                "max_abs_err": errs[name][dt],
                **times[name, dt][360], "small": times[name, dt][48],
                "train": {str(n): row for n, row in
                          train_times[name, dt].items()},
                "eval_launches": eval_launches[name, dt],
                "eval": {str(n): row for n, row in
                         eval_times[name, dt].items()},
                "tensor_parallel": {
                    "max_abs_err": shard_errs.get((name, dt)),
                    "train": {str(n): row for n, row in
                              shard_times.get((name, dt), {}).items()},
                    "launches_per_forward_per_rank":
                        tp[dt]["launches"][name],
                    "uneven_heads": {
                        "max_abs_err": tp["uneven_errs"].get((name, dt)),
                        "train": {label: {str(n): row for n, row in
                                          rows.items()}
                                  for label, rows in tp["uneven_times"].get(
                                      (name, dt), {}).items()}}},
                "past_old_limits": {
                    "shapes": wide_rows.get((name, dt), {}),
                    "config_launches": {
                        case: counts[name] for (case, d), counts in
                        limit_launches.items() if d == dt},
                    "config_decode_ms_per_step": {
                        case: ms for (case, d), ms in limit_ms.items()
                        if d == dt} if name in ("attention", "fused_mlp")
                    else None,
                    "model_axis_wider_than_heads":
                        wide_axis["launches_per_forward_per_rank"].get(name)
                        if dt == "f32" else None,
                    "device_kernels_a_call_on_model_views":
                        {"attention": wide_rows["one_kernel_a_call"],
                         "fused_mlp": wide_rows["mlp_kernels_a_call"]}.get(
                            name) if dt == "bf16" else None},
                "e2e_launches": {
                    stage: e2e_launches[stage, dt][name]
                    for stage in ("train", "evaluate")
                    if (stage, dt) in e2e_launches}}
               for name, (src, rep, dts) in sources.items() for dt in dts]
    # The bf16 attention backward kernels replace the plain VJP the JAX
    # package's custom VJP runs (no TPU kernel): their worst error in ulps
    # of each gradient's peak (phase 2, at the full heads and at the
    # tensor-parallel ranks'), their calls in the train CLI's first
    # invocation (4 steps), in 9b's rank 0 backward and in phase 12's
    # resumed run, and their times at the training shapes.
    kernels.append({
        "name": "attention_backward_bf16", "route": "cuda",
        "source": "mint_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "mint_tpu/ops/attention.py:131",
        "device_kernels": list(att.BACKWARD_KERNELS),
        "max_ulps": bwd_ulps["train"],
        "train_launches": train_launches["attention_backward", "bf16"],
        "train": {str(n): row for n, row in
                  train_times["attention_backward", "bf16"].items()},
        "tensor_parallel": {
            "max_ulps": bwd_ulps["tensor_parallel"],
            "launches_per_backward_per_rank": tp["bf16"]["backward_launches"]},
        "e2e_launches": {
            "train": e2e_launches["train", "bf16"]["attention_backward"]}})
    # EDGE's kernels (phase 13): their rows at the diffuse cell's shapes
    # and their launches in one of its dispatches.
    kernels.extend(edge_rows)
    for name, secs in seconds.items():
        log(f"phase {name}: {secs:.1f} s")
    log(f"chip_smoke.py in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--tp-rank" in sys.argv or "--wide-rank" in sys.argv:
        # one of phase 9b's ranks, or of 11c's
        if not torch.cuda.is_available():
            raise SystemExit("a rank of phase 9b or 11c needs a CUDA card")
        sys.path.insert(0, REPO)
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        if "--tp-rank" in args:
            tp_rank(int(args["--tp-rank"]), int(args["--tp-port"]),
                    args["--tp-work"])
        else:
            wide_axis_rank(int(args["--wide-rank"]), int(args["--wide-port"]),
                           args["--wide-work"])
    else:
        main(edge_only="--edge" in sys.argv)
