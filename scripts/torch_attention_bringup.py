"""The attention kernels on the card: what ptxas made of them, whether
they agree with the plain version, and how fast they run beside the
design alternatives they were chosen over.

1. Builds ``mint_tpu_torch/csrc`` and prints, for each attention kernel
   instance, ptxas's registers and spills, and every note that ptxas
   serialised its ``wgmma`` products.
2. Builds each entry of ``VARIANTS`` (``csrc/attention.cu`` with a few
   lines changed: the alternatives the redesigned kernels were measured
   against) into a library of its own, all nvcc processes at once.
3. Checks the repo's kernels against ``attention_reference`` at shapes
   that reach every schedule (the f32 and bf16 kernels for heads over
   128, the bf16 streamed kernel at long keys, heads over 256 in output
   chunks, the widest heads ``ops.attention.MAX_HEAD_DIM`` allows), and
   each variant at the 360-query shapes: f32 within 1e-5, bf16 within 2
   bf16 ulps of the output's peak (phase 2's tolerances in
   ``chip_smoke.py``).
4. Times the repo's kernels and each variant at ``chip_smoke.py`` phase
   11a's shapes for the redesigned kernels, in turns (repo, variants,
   then again in reverse order), beside the plain version and the bound,
   by CUDA events (``chip_smoke.cuda_ms``); ``chip_smoke.py`` phase 11a
   times the library's call beside them.

    python scripts/torch_attention_bringup.py [f32|bf16]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mint_tpu_torch.ops import _build  # noqa: E402
from mint_tpu_torch.ops import attention as att  # noqa: E402

# name -> [(text in csrc/attention.cu, its replacement)]
VARIANTS = {
    # The f32 wide kernel testing each P.V column against the chunk.
    "f32_tested_columns": [(
        "pv_fma<NQ, false>(acc, ps, alpha_s, vs, ldv",
        "pv_fma<NQ, true>(acc, ps, alpha_s, vs, ldv")],
    # The bf16 streamed kernel with two consumer warpgroups at every
    # chunk width (three up to 96 columns in the repo).
    "bf16_two_consumers": [(
        "constexpr int kStreamWideW = 96;",
        "constexpr int kStreamWideW = 0;")],
    # Heads of 129-256 columns in whole 64-column slabs (D = 130 as 192,
    # TMA's zeros past 130) instead of 16-column steps (144: two
    # 64-column slabs and one of 16).
    "bf16_whole_slabs": [(
        "  switch (((d + chunks - 1) / chunks + 15) / 16 * 16) {",
        "  switch (((d + chunks - 1) / chunks + (d > kMaxD && chunks == 1\n"
        "                                           ? 63 : 15))\n"
        "          / (d > kMaxD && chunks == 1 ? 64 : 16)\n"
        "          * (d > kMaxD && chunks == 1 ? 64 : 16)) {")],
    # A producer warpgroup that gives its registers to the two consumer
    # warpgroups by setmaxnreg (40 / 232 a thread) instead of one producer
    # warp.
    "bf16_setmaxnreg": [
        ("constexpr int kStreamWideW = 96;",
         "constexpr int kStreamWideW = 0;"),
        ("constexpr int kStreamProducer = 32;",
         "constexpr int kStreamProducer = 128;"),
        ("    if (threadIdx.x != 128 * wgs) return;\n",
         '    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n");\n'
         "    if (threadIdx.x != 128 * wgs) return;\n"),
        ("  const uint8_t* qt = qs + wg * chunks * T::kBytes;\n",
         '  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");\n'
         "  const uint8_t* qt = qs + wg * chunks * T::kBytes;\n")],
}

# (dtype name, B, H, Nq, Nk, D): phase 11a's shapes of the redesigned
# kernels, and the flagship's for reference.
TIMED = [("bf16", 20, 4, 360, 360, 256), ("bf16", 20, 8, 360, 360, 130),
         ("bf16", 20, 4, 360, 360, 192), ("bf16", 20, 4, 360, 360, 264),
         ("bf16", 20, 8, 720, 720, 128), ("bf16", 20, 10, 1320, 1320, 80),
         ("bf16", 20, 10, 48, 1320, 80), ("bf16", 20, 10, 360, 360, 80),
         ("f32", 20, 4, 360, 360, 256), ("f32", 20, 8, 360, 360, 130),
         ("f32", 20, 4, 360, 360, 192), ("f32", 20, 4, 360, 360, 264),
         ("f32", 20, 10, 360, 360, 80)]


def checked_shapes(only):
    """(dtype name, B, H, Nq, Nk, D) that reach every schedule."""
    cases = []
    if only in ("all", "bf16"):
        for d, nk in ((16, 4160), (80, 1320), (64, 1500), (96, 1300),
                      (112, 800), (128, 720)):
            cases += [("bf16", 2, 3, nq, nk, d) for nq in (48, 130, 200, 360)]
        for d in (130, 144, 192, 200, 256, 264, 520, 1344):
            cases += [("bf16", 2, 3, nq, nk, d)
                      for nq, nk in ((48, 360), (100, 100), (360, 65),
                                     (360, 360))]
    if only in ("all", "f32"):
        for d in (130, 192, 200, 256, 264, 600, 1016):
            cases += [("f32", 2, 3, nq, nk, d)
                      for nq, nk in ((48, 37), (200, 360), (360, 360))]
    return cases


def ptxas_report(log, tag):
    """Registers, spills and wgmma serialisation notes of the attention
    kernels in nvcc's output."""
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "",
                          m.group(1))[:48]
            continue
        if "serialized" in line:
            fn = re.search(r"\d+(attention\w+?)EEEv", line)
            print(f"{tag} ptxas: wgmma serialised in "
                  f"{fn.group(1) if fn else '?'}: {line.split(':')[1]}")
        elif name and "attention" in name and (
                "Used" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line)):
            print(f"{tag} {name:48s} {line.strip()[:90]}")


def load(path):
    lib = ctypes.CDLL(path)
    for entry in ("mint_attention_f32", "mint_attention_bf16"):
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def launch(lib, q, k, v, scale):
    """ops.attention's launch through the library `lib`."""
    q, k, v, out = att._operands(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    b, h, nq, d = q.shape
    err = getattr(lib, att._ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, nq, k.shape[2], d, float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch: CUDA error {err}")
    return out


def main():
    only = sys.argv[1] if len(sys.argv) > 1 else "all"
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = {"repo": _build.library()}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas_report(_build.build_log, "repo")

    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    source = open(os.path.join(_build.CSRC, "attention.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-shared", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        ptxas_report(log, name)
        libs[name] = load(os.path.join(work, f"{name}.so"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for name, b, h, nq, nk, d in checked_shapes(only):
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        for layout in ("fused", "contiguous") if nq <= nk else ("contiguous",):
            q, k, v = cs._qkv(layout, b, h, nq, nk, d, dtype, gen)
            want = att.attention_reference(q, k, v, cs.SCALE)
            tol = 1e-5 if name == "f32" else 2 * cs.bf16_ulp(
                want.float().abs().max().item())
            for lname, lib in libs.items():
                if lname != "repo" and nq != 360:
                    continue
                got = launch(lib, q, k, v, cs.SCALE)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = err <= tol and bool(torch.isfinite(got).all())
                bad += not ok
                print(f"{'ok  ' if ok else 'FAIL'} {lname} {name} {layout} "
                      f"q[{b},{h},{nq},{d}] k[..,{nk},{d}]: max_abs_err "
                      f"{err:.3e} tol {tol:.3e}", flush=True)
    print(f"disagreeing: {bad}", flush=True)

    for name, b, h, nq, nk, d in TIMED:
        if only not in ("all", name):
            continue
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        q, k, v = cs._qkv("fused", b, h, nq, nk, d, dtype, gen)
        order = list(libs.items())
        first = {n: cs.cuda_ms(lambda: launch(lib, q, k, v, cs.SCALE))
                 for n, lib in order}
        second = {n: cs.cuda_ms(lambda: launch(lib, q, k, v, cs.SCALE))
                  for n, lib in reversed(order)}
        t_p = cs.cuda_ms(lambda: att.attention_reference(q, k, v, cs.SCALE),
                         3)
        b_ms, b_by = cs.bound(*cs.attention_work(b, h, nq, nk, d,
                                                 dtype.itemsize), name)
        kernels = ", ".join(f"{n} {first[n]:.4f} / {second[n]:.4f}"
                            for n, _ in order)
        print(f"time {name} q[{b},{h},{nq},{d}] k[..,{nk},{d}] ms: "
              f"{kernels}; plain {t_p:.4f}; bound "
              f"{b_ms:.4f} ({b_by}) ({card})", flush=True)
    if bad:
        raise SystemExit(f"{bad} kernel results disagree")


if __name__ == "__main__":
    main()
