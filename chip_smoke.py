"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU):

1. card and build: the card's name and power limit, torch/CUDA versions,
   and the build of ``mint_tpu_torch/csrc/*.cu`` for sm_90a;
2. each kernel against its plain PyTorch version on the card, at FACT's
   shapes in f32 and bf16 (and two more f32 head dims; attention also on
   the model's strided q/k/v views), with the tolerance stated; each
   kernel's time at the batch-20 decode's shapes beside the plain
   version's, its bound and, for attention, that of PyTorch's own fused
   attention call (timed in ``time_kernels`` as a yardstick only);
3. the slice: the flagship FACT (configs/fact_v5_deeper_t10_cm12.config,
   full width and depth, weights from a torch.Generator seeded 0) behind
   the port's GenerationService and HTTP server answers concurrent
   requests in two length buckets, in f32 and in bf16; the kernels'
   launch counts must equal 16 blocks x decode steps;
4. the same f32 weights on the card (kernels) and on the CPU (plain
   versions): one forward and a 60-step decode, compared (the first 3
   frames held to a tolerance, the drift over 60 recorded);
5. batch-20 decode frames/s in bf16 and f32, for the record;
6. the training path: (a) the flagship f32 at batch 2, one forward and
   backward on the card (kernels, through their autograd Functions) and on
   the CPU (plain versions) with the same weights and batch: the losses and
   every parameter's gradient compared, and 16 launches of each kernel per
   forward; the same in bf16 compute (f32 parameters): every gradient there
   and finite; (b) the port's train CLI as a subprocess on the full
   flagship at the config's batch of 32, in f32 and with
   ``--use_bfloat16``, on a synthetic AIST-shaped corpus it reads from
   ``<tmp>/data`` through the config's own ``data_files``, with the host
   pipeline and, in bf16, once more with ``--input_backend=device`` (the
   corpus resident on the card, windows drawn there): it trains,
   checkpoints and writes finite, falling losses, and a second invocation
   resumes from its checkpoint; (c) train steps/s at batch 32 in bf16 and
   f32.

Phase 2 also checks and times both kernels at the training shapes
(batch 32).  The last lines are one JSON object describing the kernels,
the card's ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": ...}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
SCALE = 800 ** -0.5  # FACT's attention scale: the full model dim
DISPATCH = 20        # bench.py's decode batch per dispatch
THROUGHPUT_STEPS = 32
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
    tensors of their own; "fused": the model's layout, strided views of one
    [b, nk, 3, h, d] buffer (the fused QKV projection's output, as
    models/layers.py makes them), q cut to its first nq rows."""
    if layout == "contiguous":
        return [torch.randn(b, h, n, d, device="cuda", generator=gen)
                .to(dtype) for n in (nq, nk, nk)]
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
    # The f32 kernel takes any D <= 128: one not a multiple of 4 (4-byte
    # copies) and one over 80 (the wider instance).
    f32_cases = [(1, 2, 37, 37, 18), (1, 3, 70, 50, 100)]
    # The model's own layout at FACT's shapes: strided views in.
    fused = [(2, 10, 360, 360, 80), (2, 10, 48, 360, 80),
             (DISPATCH, 10, 360, 360, 80), (DISPATCH, 10, 48, 360, 80),
             (TRAIN_BATCH, 10, 360, 360, 80)]
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


def check_mlp(mlp, gen):
    """Worst error per dtype name."""
    worst = {"f32": 0.0, "bf16": 0.0}
    # Also at the batch-20 decode's M: in f32 the cross and audio blocks'
    # fc1 (M = 7200, 4800) take the 144-row GEMM instance; in both dtypes
    # the last block's fc2 (M = 960) is split over K, and at batch 1
    # (M = 360) both bf16 passes are.  And at the batch-32 training M
    # (11520, 7680, 3840), which the kernels plan by M and the SM count.
    for dtype in (torch.float32, torch.bfloat16):
        w1, b1, w2, b2 = mlp_weights(gen, dtype)
        for m in (2 * 360, 2 * 48, 257, 3, 360, DISPATCH * 360,
                  DISPATCH * 240, DISPATCH * 48, TRAIN_BATCH * 360,
                  TRAIN_BATCH * 240, TRAIN_BATCH * 120):
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


def mlp_work(m, h, f, o, elem):
    """(flops, bytes) of the fused MLP: x, W1, b1, W2, b2 in, out out."""
    return (2.0 * m * (h * f + f * o),
            elem * (m * h + h * f + f + f * o + o + m * o))


def time_kernels(att, mlp, gen, card, batch, attn_shapes, mlp_rows,
                 host=True):
    """Kernel, plain version and, for attention, one PyTorch call
    (F.scaled_dot_product_attention, the yardstick: the port never calls
    it) at `batch` and the given shapes (attention's (Nq, Nk), the MLP's
    rows per sample), with each one's bound and, if `host`, the host's
    cost of a call.  Returns {(kernel, dtype name): {Nq or rows: row}} for
    the summary line."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def backend_of(q, k, v):
        """The backend PyTorch's dispatcher picks for these inputs."""
        try:
            return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=SCALE))
        except (AttributeError, RuntimeError, TypeError, ValueError):
            return None

    summary = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = DTYPES[dtype]
        elem = torch.empty((), dtype=dtype).element_size()
        for nq, nk in attn_shapes:
            q = torch.randn(batch, 10, nq, 80, device="cuda",
                            generator=gen).to(dtype)
            k = torch.randn(batch, 10, nk, 80, device="cuda",
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
            flops, nbytes = attention_work(batch, 10, nq, nk, 80, elem)
            b_ms, b_by = bound(flops, nbytes, name)
            row = {"shape": f"q[{batch},10,{nq},80] k[{batch},10,{nk},"
                            f"80]", "ms": t_k, "plain_ms": t_p,
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
        w1, b1, w2, b2 = mlp_weights(gen, dtype)
        for rows in mlp_rows:
            m = batch * rows
            x = torch.randn(m, 800, device="cuda", generator=gen).to(dtype)
            t_k = cuda_ms(lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
            t_p = cuda_ms(lambda: mlp.mlp_reference(x, w1, b1, w2, b2))
            b_ms, b_by = bound(*mlp_work(m, 800, 3072, 800, elem), name)
            row = {"shape": f"x[{m},800]", "ms": t_k, "plain_ms": t_p,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            hosted = ""
            if host:
                row["host_us"] = host_us(
                    lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
                hosted = f"; host {row['host_us']:.1f} us a call"
            log(f"time fused_mlp {name} x[{m},800]: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no "
                f"single library call{hosted} ({card})")
            summary.setdefault(("fused_mlp", name), {})[rows] = row
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


def serve_requests(model, att, mlp, dtype_name):
    """Concurrent HTTP requests: three that co-batch in the 128-steps
    bucket and one in the 256-steps bucket.  Returns each kernel's launches
    in this run and the server's decode steps."""
    from mint_tpu_torch.serving import GenerationService, serve

    service = GenerationService(model, batch_window_ms=500.0, max_batch=8,
                                default_steps=128, steps_bucket=128)
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
        att.launches = mlp.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(asks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"attention": att.launches, "fused_mlp": mlp.launches}
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"requests failed: {errors}")
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.loads(r.read())
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
    expect = n_blocks * stats["decode_steps"]
    log(f"server {dtype_name}: {len(asks)} requests answered in "
        f"{seconds:.3f} s; shapes {[r.shape for r in results]} all finite; "
        f"stats {stats}; healthz {health['status']}")
    if (stats["requests"] != len(asks) or stats["batches"] != 2
            or stats["decode_steps"] != 128 + 256):
        raise AssertionError(f"requests did not co-batch as expected: "
                             f"{stats}")
    for name, n in launches.items():
        log(f"server {dtype_name}: {name} launches {n} == {n_blocks} "
            f"blocks x {stats['decode_steps']} decode steps = {expect}")
        if n != expect:
            raise AssertionError(f"{name}: {n} launches, expected {expect}")
    return launches, stats["decode_steps"]


# -- phase 4: card against CPU --------------------------------------------

def card_vs_cpu(model_cuda):
    from mint_tpu_torch.infer import decoder

    model_cpu = flagship(torch.float32, "cpu")
    model_cpu.load_state_dict(model_cuda.state_dict())
    rng = np.random.default_rng(2)
    motion = rng.standard_normal((1, 120, 225)).astype(np.float32) * 0.1
    audio = rng.standard_normal((1, 240, 35)).astype(np.float32) * 0.5
    with torch.inference_mode():
        got = model_cuda({"motion_input": torch.from_numpy(motion).cuda(),
                          "audio_input": torch.from_numpy(audio).cuda()})
        want = model_cpu({"motion_input": torch.from_numpy(motion),
                          "audio_input": torch.from_numpy(audio)})
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
    steps, held = 60, 3
    audio = rng.standard_normal((1, steps + 239, 35)).astype(np.float32) * .5
    inputs = {"motion_input": motion, "audio_input": audio}
    got = decoder.infer_auto_regressive(model_cuda, inputs, steps=steps)
    want = decoder.infer_auto_regressive(model_cpu, inputs, steps=steps)
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
    decoder.infer_auto_regressive(model, inputs, steps=2)  # warm-up
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


def train_gradients(att, mlp):
    """One forward and backward of the flagship through Trainer on the card
    and on the CPU with the same weights and batch: in f32 every gradient
    compared, in bf16 compute every gradient present and finite; 16
    launches of each kernel per forward."""
    from mint_tpu_torch.train import Trainer, schedules

    def grads(model, batch):
        trainer = Trainer(model, schedules.constant(0.0))
        params = trainer.init_state(model).params
        att.launches = mlp.launches = 0
        loss, g = trainer.loss_and_grads(params, batch)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        counts = {"attention": att.launches, "fused_mlp": mlp.launches}
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
    expect = {"attention": 16, "fused_mlp": 16}
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
    if (bad or counts16 != expect or not math.isfinite(loss16)
            or not rel16 <= 0.1 or not per_leaf[worst16] <= 0.1):
        raise AssertionError(f"bf16 training gradients: bad {bad}, "
                             f"relative L2 {rel16}, worst leaf {worst16} "
                             f"{per_leaf[worst16]}, launches {counts16}")
    del mixed, g16
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


def run_train_cli(work, model_dir, steps, bf16, backend):
    """One invocation of the port's train CLI with `backend` as its
    ``--input_backend``, run from `work` (where the config's relative
    data_files finds ./data); returns its launch counts and stderr."""
    cmd = [sys.executable, "-m", "mint_tpu_torch.tools.train",
           f"--config_path={CONFIG}", f"--model_dir={model_dir}",
           f"--steps={steps}", "--steps_per_loop=2",
           "--checkpoint_interval=3", "--summary_interval=1",
           f"--input_backend={backend}"]
    if bf16:
        cmd.append("--use_bfloat16")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"train CLI exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    found = re.findall(r"kernel launches: (\{.*\})", proc.stderr)
    if not found:
        raise AssertionError("the train CLI reported no kernel launches")
    return json.loads(found[-1]), proc.stderr, seconds


def train_cli(work, name, backend):
    """The train CLI on the full flagship at batch 32 with input from
    `backend` ("python": the host pipeline; "device": the corpus resident
    on the card, windows drawn there): 4 steps, then a second invocation
    that resumes at 4 and runs to 6.  Returns the first invocation's
    launch counts."""
    bf16 = name == "bf16"
    name = f"{name}, {backend} input"
    model_dir = os.path.join(work, "run")

    def rows():
        with open(os.path.join(model_dir, "train", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def ckpts():
        return sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())

    counts, err, seconds = run_train_cli(work, model_dir, 4, bf16, backend)
    if (backend == "device") != ("device-resident dataset" in err):
        raise AssertionError(f"train CLI {name}: input backend not used")
    first = rows()
    # Saves at step 1, then when 3 steps have elapsed (never, by step 4),
    # then the final forced save.
    if ckpts() != [1, 4] or [r["step"] for r in first] != [1, 3, 4]:
        raise AssertionError(f"train CLI {name}: checkpoints {ckpts()}, "
                             f"summaries at {[r['step'] for r in first]}")
    expect = {"attention": 16 * 4, "fused_mlp": 16 * 4}
    if counts != expect:
        raise AssertionError(f"train CLI {name}: launches {counts}, want "
                             f"{expect} (16 a step)")
    counts2, err2, seconds2 = run_train_cli(work, model_dir, 6, bf16,
                                            backend)
    every = rows()
    losses = [r["loss"] for r in every]
    resumed = "restored checkpoint at step 4" in err2
    log(f"train CLI {name} batch {TRAIN_BATCH}: steps 0-4 in {seconds:.1f} "
        f"s, launches {counts}; resumed at step 4: {resumed}, steps 4-6 in "
        f"{seconds2:.1f} s, launches {counts2}; checkpoints {ckpts()}; "
        f"losses by step {[(r['step'], round(r['loss'], 5)) for r in every]}")
    if (not resumed or ckpts() != [1, 4, 6]
            or [r["step"] for r in every] != [1, 3, 4, 6]
            or counts2 != {"attention": 32, "fused_mlp": 32}):
        raise AssertionError(f"train CLI {name} did not resume as expected")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train CLI {name}: losses {losses}")
    return counts


def train_rate(att, mlp, name, card, steps):
    """Train steps/s of Trainer.train_step at batch 32 on a batch resident
    on the card, after two warm-up steps; with the launches of the timed
    steps and the peak device memory."""
    from mint_tpu_torch.train import Trainer, schedules

    model = flagship(torch.float32, "cuda", is_training=True,
                     compute_dtype=torch.bfloat16 if name == "bf16" else None)
    trainer = Trainer(model, schedules.constant(1e-4))
    state = trainer.init_state(model)
    batch = train_batch(TRAIN_BATCH, "cuda", seed=4)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    att.launches = mlp.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"attention": att.launches, "fused_mlp": mlp.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {name} batch {TRAIN_BATCH} x {steps} steps: {seconds:.4f} s, "
        f"{steps / seconds:.3f} steps/s, {1000 * seconds / steps:.2f} "
        f"ms/step, peak memory {peak:.2f} GiB, loss {loss:.5f}, launches "
        f"{counts} ({card})")
    if counts != {"attention": 16 * steps, "fused_mlp": 16 * steps} \
            or not math.isfinite(loss):
        raise AssertionError(f"train {name}: launches {counts}, loss {loss}")
    del model, trainer, state
    torch.cuda.empty_cache()
    return steps / seconds


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from mint_tpu_torch.ops import _build
    from mint_tpu_torch.ops import attention as att
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"attention": check_attention(att, gen),
            "fused_mlp": check_mlp(mlp, gen)}
    # The decode's shapes: Nq = Nk = 360 (11 blocks a step), 48 queries
    # against 360 keys (1), and the encoders' 240 and 120 (2 each); then
    # training's, at batch 32 with no truncated block.
    times = time_kernels(att, mlp, gen, card, DISPATCH,
                         ((360, 360), (48, 360), (240, 240), (120, 120)),
                         (360, 48, 240, 120))
    train_times = time_kernels(att, mlp, gen, card, TRAIN_BATCH,
                               ((360, 360), (240, 240), (120, 120)),
                               (360, 240, 120), host=False)

    # Each dtype has its own kernel; its launches are those of its server,
    # and its launches a step those over that server's decode steps.
    launches, per_step = {}, {}
    model32 = flagship(torch.float32, "cuda")
    model16 = flagship(torch.bfloat16, "cuda")
    for model, name in ((model32, "f32"), (model16, "bf16")):
        counts, steps = serve_requests(model, att, mlp, name)
        for k, n in counts.items():
            launches[k, name] = n
            per_step[k, name] = n / steps
    card_vs_cpu(model32)
    throughput(model16, "bf16", card)
    throughput(model32, "f32", card)
    del model16, model32
    torch.cuda.empty_cache()

    train_gradients(att, mlp)
    train_launches = {}
    with tempfile.TemporaryDirectory() as work:
        write_corpus(os.path.join(work, "data"))
        for name, backend in (("f32", "python"), ("bf16", "python"),
                              ("bf16", "device")):
            counts = train_cli(work, name, backend)
            if backend == "python":
                for k, n in counts.items():
                    train_launches[k, name] = n
            shutil.rmtree(os.path.join(work, "run"))
    train_rate(att, mlp, "bf16", card, steps=10)
    train_rate(att, mlp, "f32", card, steps=5)

    sources = {"attention": ("mint_tpu_torch/csrc/attention.cu",
                             "mint_tpu/ops/attention.py:43"),
               "fused_mlp": ("mint_tpu_torch/csrc/mlp.cu",
                             "mint_tpu/ops/mlp.py:44")}
    # Each row's times are at the batch-20 full shape (Nq or M/20 = 360);
    # "small" holds the same at the final block's 48 rows.  `launches` is
    # the serving path's count; `train_launches` the train CLI's first
    # invocation's (4 steps), and "train" the times at the training
    # shapes (batch 32; Nq or M/32 = 360, 240, 120).
    kernels = [{"name": f"{name}_{dt}", "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name, dt],
                "launches_per_step": per_step[name, dt],
                "train_launches": train_launches[name, dt],
                "max_abs_err": errs[name][dt],
                **times[name, dt][360], "small": times[name, dt][48],
                "train": {str(n): row for n, row in
                          train_times[name, dt].items()}}
               for name, (src, rep) in sources.items()
               for dt in ("f32", "bf16")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
