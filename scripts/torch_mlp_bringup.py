"""The bf16 fused MLP on the card: what ptxas made of it, whether it
agrees with the plain version at every width and load route, where a
call's time goes by device kernel, and how fast it runs beside the parent
commit's.

1. Builds ``mint_tpu_torch/csrc`` and prints, for each MLP kernel
   instance, ptxas's registers and spills; the build's seconds.
2. Builds the MLP sources (``csrc/mlp.cu``, ``mlp_routes.cu``,
   ``mlp_phases.cu``) alone (their seconds), each entry of ``VARIANTS``
   (those sources with a few lines changed: the alternatives the kernel
   was measured against) and, given ``--parent DIR`` (a checkout of
   another commit with the same C entry, e.g. ``git archive HEAD``
   unpacked), that tree's MLP sources, each into a library of its own run
   through its tree's own wrapper (``ops/mlp.py``, its library swapped
   in), so that the parent's plan loads each operand its own way.
3. Checks the kernel against ``mlp_reference`` at ``CHECKED`` (every
   column tile and every load of ``ops.mlp.bf16_plan``: widths off the
   16-byte step, K tails inside a k-tile, odd outputs, bases off 16
   bytes, rows of odd strides, split K), within 2 bf16 ulps of the
   output's peak (``chip_smoke.py`` phase 2's tolerance).
4. ``--split``: one call at each ``TIMED`` shape under ``torch.profiler``,
   10 times: the device kernels a call and each one's time, for this tree
   and the parent.
5. Times the ``TIMED`` shapes by CUDA events (``chip_smoke.cuda_ms``) in
   turns, this tree, the variants and this tree's other routes (where a
   TIMED shape takes the load they change: ``TIMED_WHERE``) and the
   parent, then again in reverse order, beside the plain version and the
   bound.

    python scripts/torch_mlp_bringup.py [--parent DIR] [--split]
        [--check-only]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mint_tpu_torch.ops import _build  # noqa: E402
from mint_tpu_torch.ops import mlp  # noqa: E402

# (M, H, F, O, layout): the flagship's decode rows (batch 20's fc1 and
# the last block's split fc2; batch 1's last block), hidden 804 (rows of
# 1608 bytes: fc1 on tma_pairs; fc2's 208-column tiles) at the decode's M
# of batch 20 and 4, the split fc2 at M = 960 and split fc1 at M = 480,
# 192 and 48 (batch 4's and 1's small blocks), MLP width 3080 (200-column
# fc1 tiles), 3070, 3068, 3066 and 3071 (W2^T's rows in 4, 2, 4 and 8
# phases off the step: fc2 on tma_phases, at M = 960 split over K), O =
# 801 (odd: single stores), odd H (staged at a 2-byte phase), fewer of
# W2^T's rows than phases (O = 5 at F = 69), and the layouts: x on a base
# 2 bytes past 16 ("x_off2"), x a view of rows H + 1 apart ("x_rows"):
# staged.
C = "contiguous"
CHECKED = [
    (7200, 800, 3072, 800, C), (960, 800, 3072, 800, C),
    (48, 800, 3072, 800, C), (7200, 804, 3072, 804, C),
    (1440, 804, 3072, 804, C), (960, 804, 3072, 804, C),
    (480, 804, 3072, 804, C), (192, 804, 3072, 804, C),
    (48, 804, 3072, 804, C),
    (7200, 800, 3080, 800, C), (1440, 800, 3080, 800, C),
    (7200, 800, 3070, 800, C), (960, 800, 3070, 800, C),
    (7200, 800, 3068, 800, C), (960, 800, 3066, 800, C),
    (7200, 800, 3071, 800, C), (7200, 800, 3072, 801, C),
    (960, 800, 3071, 801, C), (7200, 800, 3072, 800, "x_off2"),
    (960, 804, 3072, 804, "x_off2"), (1440, 804, 3072, 804, "x_rows"),
    (257, 36, 100, 33, C), (300, 40, 3070, 24, C), (129, 33, 70, 17, C),
    (129, 33, 70, 17, "x_off2"), (3, 8, 8, 2, C), (64, 40, 69, 5, C),
    (600, 1040, 4160, 1040, C),
]
# The rows chip_smoke.py phase 11a times, and the flagship's decode rows.
TIMED = [
    (7200, 800, 3072, 800, C), (960, 800, 3072, 800, C),
    (7200, 804, 3072, 804, C), (1440, 804, 3072, 804, C),
    (960, 804, 3072, 804, C), (192, 804, 3072, 804, C),
    (7200, 800, 3080, 800, C), (1440, 800, 3080, 800, C),
    (7200, 800, 3070, 800, C), (7200, 800, 3068, 800, C),
    (960, 800, 3070, 800, C), (7200, 800, 3071, 800, C),
    (7200, 800, 3072, 801, C), (7200, 800, 3072, 800, "x_off2"),
    # The flagship's route at hidden widths whose rows start 16 bytes into
    # a 32-byte sector every other row (808: 1616-byte rows, as hidden
    # 804's tma_pairs maps do) and on sectors (816).
    (7200, 808, 3072, 808, C), (7200, 816, 3072, 816, C),
]


def operands(gen, m, h, f, o, layout):
    """x [m, h] in `layout` (chip_smoke.mlp_input's) and the model's
    weights (nn.Linear's, as ``.t()`` views), bf16."""
    return (cs.mlp_input(gen, m, h, torch.bfloat16, layout),
            *cs.mlp_weights(gen, torch.bfloat16, h=h, f=f, o=o))


def ptxas_report(log, tag):
    """Registers and spills of the MLP kernels in nvcc's output."""
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            name = m.group(1)
            continue
        if "serialized" in line and "gemm" in line:
            print(f"{tag} ptxas: {line.strip()[:160]}")
        elif name and ("gemm" in name or "reduce" in name) and (
                "Used" in line or "spill" in line):
            short = re.sub(r"^_ZN(8mint_mlp)?\d+_GLOBAL__N__\w+?_cu_\w{8}\d+",
                           "", name)[:60]
            print(f"{tag} {short:60s} {line.strip()[:90]}")


# name -> [(text in csrc/mlp.cu or mlp_routes.cu, its replacement)]: the
# design alternatives the kernel is timed against.
VARIANTS = {
    # One producer warp copies and moves the staged words, not four.
    "producer_warp": [("constexpr int kProducerWarps = 4;",
                       "constexpr int kProducerWarps = 1;")],
    # fc1 with one K range a block (tma_pairs before it took split K; the
    # variant is timed at its shapes only).
    "pairs_one_split": [("  p->split1 = tc_split(m, f, h, bn1, sms);",
                         "  p->split1 = 1;")],
    # fc1 on tma_pairs with a ring of 5 stages, not 4 (the cross product
    # runs a tile behind: 2 tiles held, 3 in flight, not 2).
    "pairs_5_stages": [("constexpr int kPairsStages = 4;",
                        "constexpr int kPairsStages = 5;")],
    # The flagship's fc1 (gemm_tc_kernel<192>) as two products of N = 96
    # a k-step, the column halves tma_pairs' products have.
    "flagship_n96": [(
        "      mint::wgmma_ss<BN>(acc, mint::smem_desc(at + 32 * kk, 16, 1024, 1),\n"
        "                         mint::smem_desc(bt + 32 * kk, 16, 1024, 1));",
        "      if constexpr (BN == 192) {\n"
        "        mint::wgmma_ss<96>(*reinterpret_cast<float(*)[48]>(acc),\n"
        "            mint::smem_desc(at + 32 * kk, 16, 1024, 1),\n"
        "            mint::smem_desc(bt + 32 * kk, 16, 1024, 1));\n"
        "        mint::wgmma_ss<96>(*reinterpret_cast<float(*)[48]>(acc + 48),\n"
        "            mint::smem_desc(at + 32 * kk, 16, 1024, 1),\n"
        "            mint::smem_desc(bt + 96 * 128 + 32 * kk, 16, 1024, 1));\n"
        "      } else {\n"
        "      mint::wgmma_ss<BN>(acc, mint::smem_desc(at + 32 * kk, 16, 1024, 1),\n"
        "                         mint::smem_desc(bt + 32 * kk, 16, 1024, 1));\n"
        "      }")],
}
# The load a run other than this tree's and the parent's is timed where a
# TIMED shape takes (None: at every shape).
TIMED_WHERE = {"producer_warp": "staged", "act_ld8": None,
               "pairs_one_split": "tma_pairs", "pairs_5_stages": "tma_pairs",
               "flagship_n96": "tma",
               "staged": "tma_pairs",
               "w2_staged": "tma_phases"}


def build_alone(sources, work):
    """{tag: ([MLP sources], their include dir)} built each into a library
    of its own in `work`, one nvcc each, all at once: {tag: its path},
    nvcc's seconds for each printed."""
    procs, t0 = {}, time.perf_counter()
    for tag, (files, include) in sources.items():
        so = os.path.join(work, f"{tag}_mlp.so")
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-shared",
             "-o", so, *files], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tag}'s MLP sources failed to build:\n{log}")
        if tag != "repo":
            ptxas_report(log, tag)
        print(f"{tag}'s MLP sources built in "
              f"{time.perf_counter() - t0:.1f} s (all at once)", flush=True)
        out[tag] = so
    return out


def wrapper(tree, so):
    """`tree`'s ops/mlp.py as a module of its own whose ``_build`` hands it
    the library `so` (built from that tree's mlp.cu, or a variant of it):
    its fused_mlp runs that library through that tree's own route."""
    lib = ctypes.CDLL(so)
    lib.mint_mlp_bf16.argtypes = _build._SIGNATURES["mint_mlp_bf16"]
    lib.mint_mlp_bf16.restype = ctypes.c_int
    lib.mint_mlp_bf16_scratch.argtypes = [ctypes.c_int] * 7
    lib.mint_mlp_bf16_scratch.restype = ctypes.c_longlong

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    spec = importlib.util.spec_from_file_location(
        f"mlp_of_{os.path.basename(so)[:-3]}",
        os.path.join(tree, "mint_tpu_torch", "ops", "mlp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._build = types.SimpleNamespace(library=lambda: lib, check=check)
    return module


def device_kernels(fn, calls=10):
    """{kernel name: mean device ms a call} of fn() under torch.profiler,
    and the device kernels a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows, n = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.count:
            short = re.sub(r"^void |mint_mlp::|\(anonymous namespace\)::",
                           "", evt.key)
            short = re.sub(r"\(.*", "", short)[:70]
            rows[short] = rows.get(short, 0.0) + (
                evt.self_device_time_total / 1e3 / calls)
            n += evt.count
    return rows, n / calls


def shape_name(m, h, f, o, layout):
    return f"x[{m},{h}] F{f} O{o}" + ("" if layout == "contiguous"
                                       else f" {layout}")


def main():
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s (one nvcc a source, "
          f"all at once)", flush=True)
    ptxas_report(_build.build_log, "repo")
    runs = {"repo": mlp.fused_mlp}
    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    # This tree's MLP sources (a variant patches whichever holds its text).
    mine = [n for n in ("mlp.cu", "mlp_routes.cu", "mlp_phases.cu")
            if os.path.exists(os.path.join(_build.CSRC, n))]
    sources = {"repo": ([os.path.join(_build.CSRC, n) for n in mine],
                        _build.CSRC)}
    for name, edits in VARIANTS.items():
        texts = {n: open(os.path.join(_build.CSRC, n)).read() for n in mine}
        for old, new in edits:
            holder = [n for n, t in texts.items() if old in t]
            if not holder:
                raise SystemExit(f"variant {name}: {old!r} not in {mine}")
            texts[holder[0]] = texts[holder[0]].replace(old, new)
        os.makedirs(os.path.join(work, name), exist_ok=True)
        for n, text in texts.items():
            with open(os.path.join(work, name, n), "w") as f:
                f.write(text)
        sources[name] = ([os.path.join(work, name, n) for n in mine],
                         _build.CSRC)
    if parent:
        tree = os.path.abspath(parent)
        csrc = os.path.join(tree, "mint_tpu_torch", "csrc")
        sources["parent"] = ([os.path.join(csrc, n) for n in (
            "mlp.cu", "mlp_routes.cu", "mlp_phases.cu") if os.path.exists(
            os.path.join(csrc, n))], csrc)
    built = build_alone(sources, work)
    for name in VARIANTS:
        runs[name] = wrapper(REPO, built[name]).fused_mlp
    # This tree's kernel with fc1 staged where it would take tma_pairs, W2^T
    # staged where it would take tma_phases, and with the activation's rows
    # F rounded up to 8 apart, not 64.
    staged = wrapper(REPO, built["repo"])
    staged._pairs = lambda t: False
    runs["staged"] = staged.fused_mlp
    w2_staged = wrapper(REPO, built["repo"])
    w2_staged._phases = lambda t: False
    runs["w2_staged"] = w2_staged.fused_mlp
    act_ld8 = wrapper(REPO, built["repo"])
    act_ld8.ACT_STEP = 8
    runs["act_ld8"] = act_ld8.fused_mlp
    if parent:
        runs["parent"] = wrapper(tree, built["parent"]).fused_mlp

    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for case in CHECKED:
        ops = operands(gen, *case)
        want = mlp.mlp_reference(*ops).float()
        tol = 2 * cs.bf16_ulp(want.abs().max().item())
        x, w1t, _, w2t, _ = mlp._operands(*ops)
        plan = mlp.bf16_plan(x, w1t, w2t)
        plan = f"{plan.tiles} {'/'.join(plan.loads)}"
        for name, fn in runs.items():
            got = fn(*ops)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            ok = (err <= tol and got.shape == want.shape
                  and bool(torch.isfinite(got).all()))
            bad += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {name} {shape_name(*case)}"
                  f" {plan}: max_abs_err {err:.3e} tol {tol:.3e}",
                  flush=True)
    print(f"disagreeing: {bad}", flush=True)
    if bad:
        raise SystemExit(f"{bad} kernel results disagree")
    if "--check-only" in args:
        return

    if "--split" in args:
        for case in TIMED:
            ops = operands(gen, *case)
            for name, fn in runs.items():
                if name in VARIANTS:
                    continue
                rows, n = device_kernels(lambda: fn(*ops))
                parts = "; ".join(f"{k} {v:.4f}" for k, v in sorted(
                    rows.items(), key=lambda x: -x[1]))
                print(f"split {name} {shape_name(*case)}: {n:g} device "
                      f"kernels a call, {sum(rows.values()):.4f} ms: {parts}"
                      f" ({card})", flush=True)

    for case in TIMED:
        ops = operands(gen, *case)
        x, w1t, _, w2t, _ = mlp._operands(*ops)
        loads = mlp.bf16_plan(x, w1t, w2t).loads
        order = [(n, fn) for n, fn in runs.items()
                 if TIMED_WHERE.get(n) in (None, *loads)]
        order += order[::-1]
        times = {}
        for name, fn in order:
            times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*ops)))
        t_p = cs.cuda_ms(lambda: mlp.mlp_reference(*ops), 3)
        m, h, f, o, _ = case
        b_ms, b_by = cs.bound(*cs.mlp_work(m, h, f, o, 2), "bf16")
        kernels = ", ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                            for n, ts in times.items())
        print(f"time bf16 {shape_name(*case)} ms: {kernels}; plain "
              f"{t_p:.4f}; bound {b_ms:.4f} ({b_by}) ({card})", flush=True)


if __name__ == "__main__":
    main()
