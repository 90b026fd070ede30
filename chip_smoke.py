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
5. batch-20 decode frames/s in bf16 and f32, for the record.

The last lines are one JSON object describing the kernels, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
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
             (1, 2, 37, 37, 16)]
    # The f32 kernel takes any D <= 128: one not a multiple of 4 (4-byte
    # copies) and one over 80 (the wider instance).
    f32_cases = [(1, 2, 37, 37, 18), (1, 3, 70, 50, 100)]
    # The model's own layout at FACT's shapes: strided views in.
    fused = [(2, 10, 360, 360, 80), (2, 10, 48, 360, 80),
             (DISPATCH, 10, 360, 360, 80), (DISPATCH, 10, 48, 360, 80)]
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
    # (M = 360) both bf16 passes are.
    for dtype in (torch.float32, torch.bfloat16):
        w1, b1, w2, b2 = mlp_weights(gen, dtype)
        for m in (2 * 360, 2 * 48, 257, 3, 360, DISPATCH * 360,
                  DISPATCH * 240, DISPATCH * 48):
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


def time_kernels(att, mlp, gen, card):
    """Kernel, plain version and, for attention, one PyTorch call
    (F.scaled_dot_product_attention, the yardstick: the port never calls
    it) at the batch-20 decode's shapes, with each one's bound.  Returns
    {(kernel, dtype name): {shape label: row}} for the summary line."""
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
        # The decode's shapes: Nq = Nk = 360 (11 blocks a step), 48 queries
        # against 360 keys (1), and the encoders' 240 and 120 (2 each).
        for nq, nk in ((360, 360), (48, 360), (240, 240), (120, 120)):
            q = torch.randn(DISPATCH, 10, nq, 80, device="cuda",
                            generator=gen).to(dtype)
            k = torch.randn(DISPATCH, 10, nk, 80, device="cuda",
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
            flops, nbytes = attention_work(DISPATCH, 10, nq, nk, 80, elem)
            b_ms, b_by = bound(flops, nbytes, name)
            row = {"shape": f"q[{DISPATCH},10,{nq},80] k[{DISPATCH},10,{nk},"
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
            row["host_us"] = host_us(lambda: att.attention(q, k, v, SCALE))
            log(f"time attention {name} {row['shape']}: kernel {t_k:.4f} ms,"
                f" plain {t_p:.4f} ms, SDPA {t_l:.4f} ms{named}, bound "
                f"{b_ms:.4f} ms ({b_by}){extra}; host {row['host_us']:.1f} "
                f"us a call ({card})")
            summary.setdefault(("attention", name), {})[nq] = row
        w1, b1, w2, b2 = mlp_weights(gen, dtype)
        for m in (DISPATCH * 360, DISPATCH * 48, DISPATCH * 240,
                  DISPATCH * 120):
            x = torch.randn(m, 800, device="cuda", generator=gen).to(dtype)
            t_k = cuda_ms(lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
            t_p = cuda_ms(lambda: mlp.mlp_reference(x, w1, b1, w2, b2))
            b_ms, b_by = bound(*mlp_work(m, 800, 3072, 800, elem), name)
            t_h = host_us(lambda: mlp.fused_mlp(x, w1, b1, w2, b2))
            log(f"time fused_mlp {name} x[{m},800]: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no "
                f"single library call; host {t_h:.1f} us a call ({card})")
            summary.setdefault(("fused_mlp", name), {})[m // DISPATCH] = {
                "shape": f"x[{m},800]", "ms": t_k, "plain_ms": t_p,
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "host_us": t_h}
    return summary


# -- phase 3: the server ---------------------------------------------------

def flagship(dtype, device):
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = builder.build(cfg, is_training=False, dtype=dtype, device=device)
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
    times = time_kernels(att, mlp, gen, card)

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

    sources = {"attention": ("mint_tpu_torch/csrc/attention.cu",
                             "mint_tpu/ops/attention.py:43"),
               "fused_mlp": ("mint_tpu_torch/csrc/mlp.cu",
                             "mint_tpu/ops/mlp.py:44")}
    # Each row's times are at the batch-20 full shape (Nq or M/20 = 360);
    # "small" holds the same at the final block's 48 rows.
    kernels = [{"name": f"{name}_{dt}", "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name, dt],
                "launches_per_step": per_step[name, dt],
                "max_abs_err": errs[name][dt],
                **times[name, dt][360], "small": times[name, dt][48]}
               for name, (src, rep) in sources.items()
               for dt in ("f32", "bf16")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
