"""The attention kernels on the card: what ptxas made of them, whether
they agree with the plain version, and how fast they run beside the
design alternatives they were chosen over and the parent commit's.

1. Builds ``mint_tpu_torch/csrc`` and prints, for each attention kernel
   instance, ptxas's registers and spills, and every note that ptxas
   serialised its ``wgmma`` products; the build's seconds.
2. Builds each entry of ``VARIANTS`` (a source of ``csrc/`` with a few
   lines changed: the alternatives the kernels were measured against,
   such as the scores-once kernels below their boundary,
   ``bf16_once_all``) into a library of its own, and, given
   ``--parent DIR`` (a checkout of another commit, e.g. ``git archive HEAD``
   unpacked), that tree's ``attention.cu``, all nvcc processes at once.
3. Checks the repo's kernels against ``attention_reference`` at shapes
   that reach every schedule and every way the bf16 kernels load a view
   (``ops.attention.bf16_route``: the model's fused QKV views at head dims
   36-250 with the head counts that make each route, Nq = 360 and 48, and
   views of padded rows, 84 over 80 and 69 over 67; the f32 kernel's
   widths 8-128 and its wide heads; the scores-once kernels past 256
   columns, also with a workspace of one unit a launch group), and each
   variant at the 360-query shapes: f32 within 1e-5, bf16 within 2 bf16
   ulps of the output's peak (phase 2's tolerances in ``chip_smoke.py``).
4. Times ``TIMED`` (the model's fused views, and views of padded rows)
   in turns (then again in reverse order), by CUDA events
   (``chip_smoke.cuda_ms``) beside the plain version, the bound and, past
   256 columns, PyTorch's attention call on its math backend
   (``library_math``; ``chip_smoke.py`` phase 11a times
   the library's call beside the kernel at its shapes): bf16 on each
   view's route, the parent's kernel on the same views (its own C entry
   and ABI: no workspace), and, on the resident kernel, by the block's
   copies; f32 against each variant and the parent's library.  Where the
   scores-once kernels run, also with launch groups of at most 32 and 64
   MB of workspace (``repo_ws32``, ``repo_ws64``), and each of the three
   kernels' device µs a call under ``torch.profiler`` ("split").

5. With ``--decode`` (and ``--parent DIR``), only the flagship's bf16
   batch-20 decode frames/s through its CUDA graph (``chip_smoke.py``
   phase 5's ``throughput``), each tree's own code in a process of its
   own: parent, this tree, this tree, parent.

    python scripts/torch_attention_bringup.py [all|f32|bf16] [--check-only]
        [--parent DIR] [--decode]

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

# name (its dtype's name first) -> (source in csrc/, [(text in it, its
# replacement)])
VARIANTS = {
    # The f32 kernel's widths rounded up to 16 columns instead of 8 (half
    # the instances: D = 50 as 64, 67 as 80).
    "f32_width16": ("attention_f32.cu", [(
        "    width = (d + 7) / 8 * 8;",
        "    width = (d + 15) / 16 * 16;")]),
    # Its instances at W = 72 and 80 free to take the registers ptxas
    # gives them (144 a thread: three blocks an SM, not four).
    "f32_any_registers": ("attention_f32.cu", [
        ("#define MINT_PAD\n", "#define MINT_PAD , true\n")] + [
        (f"MINT_CASE({w8}, attention_kernel_4)",
         f"MINT_CASE({w8}, attention_kernel)") for w8 in (9, 10)]),
    # The f32 scores-once kernel 1 at 4 x 4 micro-tiles (256 threads a
    # block) instead of 8 x 4 (128).
    "f32_scores_tm4": ("attention_f32.cu", [
        ("constexpr int kOnceScoreTM = 8;",
         "constexpr int kOnceScoreTM = 4;")]),
    # Every bf16 frame past one output chunk on the scores-once kernels
    # (the repo's take them past two: the streamed kernel ran two chunks
    # faster).
    "bf16_once_all": ("attention.cu", [(
        "  if (d + shift >= kOnceMinFrame)",
        "  if (d + shift > kStreamMaxW)")]),
}
# ops.attention's mirror of a variant's choice: its first frame on the
# scores-once kernels, where it differs from the repo's.
VARIANT_MIN_FRAME = {"bf16_once_all": 257}

# A bf16 source's library also takes the other bf16 sources (those of its
# tree).
BF16_SOURCES = ("attention.cu", "attention_stream.cu", "attention_pairs.cu",
                "attention_once.cu")
# The C entries of a tree without the scores-once kernels' workspace (a
# parent before them): q, k, v, out, strides[, routes], B, H, nq, nk, d,
# scale, stream.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
PARENT_SIGNATURES = {
    "mint_attention_f32": [_P, _P, _P, _P, _S, _I, _I, _I, _I, _I, _F, _P],
    "mint_attention_bf16": [_P, _P, _P, _P, _S, ctypes.POINTER(_I), _I, _I,
                            _I, _I, _I, _F, _P],
}

# (dtype name, B, H, Nq, Nk, D, layout): chip_smoke.py phase 11a's shapes
# of the heads read in place (hidden 800 over 16 heads, 804 over 12, 1040
# over 8), the same widths rounded to 8 (what the parent's general f32
# instance cost at a width its 16-byte copies read), hidden 800 over 8
# heads, the flagship's, and the 84-over-80 view (tma_pairs); the heads
# over 128 with Q resident (130, 192, 256) and past one output chunk, on
# the scores-once kernels (264 and 520 at batch 20, f32 1032, bf16 1360,
# both 2048 at batch 2: the parent's output chunks on the grid).
TIMED = [(name, 20, h, 360, 360, d, "fused") for name in ("bf16", "f32")
         for h, d in ((16, 50), (12, 67), (12, 64), (16, 48), (10, 80),
                      (8, 100))] + [("bf16", 20, 8, 360, 360, 130, "fused"),
                                    ("bf16", 20, 10, 360, 360, 80, "rows84")
                                    ] + [
    (name, 20, h, 360, 360, d, "fused") for name in ("bf16", "f32")
    for h, d in ((8, 130), (4, 192), (4, 256), (4, 264), (4, 520))
    if (name, d) != ("bf16", 130)] + [
    ("bf16", 20, 4, 360, 360, d, "fused")
    for d in (352, 368, 392, 448, 504)] + [
    ("f32", 2, 4, 360, 360, 1032, "fused"),
    ("bf16", 2, 4, 360, 360, 1360, "fused"),
    ("f32", 2, 4, 360, 360, 2048, "fused"),
    ("bf16", 2, 4, 360, 360, 2048, "fused")]
if os.environ.get("BRINGUP_TIMED"):  # e.g. "bf16:12:67,bf16:10:80:rows84"
    TIMED = [(n, 20, int(h), 360, 360, int(d), (rest or ["fused"])[0])
             for n, h, d, *rest in (
                 x.split(":") for x in os.environ["BRINGUP_TIMED"].split(","))]


def checked_shapes(only):
    """(dtype name, layout, B, H, Nq, Nk, D) that reach every schedule and
    route."""
    cases = []
    if only in ("all", "bf16"):
        for d, nk in ((16, 4160), (80, 1320), (64, 1500), (96, 1300),
                      (112, 800), (128, 720)):
            cases += [("bf16", "contiguous", 2, 3, nq, nk, d)
                      for nq in (48, 130, 200, 360)]
        for d in (130, 144, 192, 200, 256, 264, 520, 1344, 1345, 1360,
                  2048, 4100):
            cases += [("bf16", "contiguous", 2, 3, nq, nk, d)
                      for nq, nk in ((48, 360), (100, 100), (360, 65),
                                     (360, 360))]
        # Heads over 256 on the model's views, on the scores-once kernels,
        # read over the token rows' head columns (266, 1298 and 1362 over
        # 4 heads: the columns around each head zeroed in its Q tiles at
        # each arrival; each output chunk past the first stores the
        # head's columns its frame moved into it) and over the view (1360
        # over 4); 254 over 4, a frame of 260 (the scores-once kernels)
        # and 250, of 256 (the streamed kernel).
        cases += [("bf16", "fused", 2, h, nq, 360, d)
                  for h, d in ((4, 266), (4, 1298), (4, 1362), (4, 1360),
                               (4, 254), (4, 250))
                  for nq in (360, 48)]
        # The model's views: the first head count makes a token row TMA
        # can step over (tma_columns; 67 over 12 heads: copies, the odd
        # heads' rows on 2-byte boundaries), 3 heads one it cannot.
        for d, heads in ((36, (2, 3)), (50, (16, 3)), (67, (12,)),
                         (100, (2, 3)), (130, (8, 3)), (250, (4, 3))):
            cases += [("bf16", "fused", 2, h, nq, 360, d)
                      for h in heads for nq in (360, 48)]
        cases += [("bf16", f"rows{st}", 2, 3, nq, 360, d)
                  for st, d in ((84, 80), (69, 67)) for nq in (360, 48)]
        # tma_pairs (token rows 8 bytes past a 16-byte step every other
        # row) at key counts that end either parity's run on a partial
        # tile or leave the odd run one tile, and at frames of every slab
        # mix: 67 over 12 and 4 heads (80 wide), 36 over 1 (48: narrow
        # slabs only), 100 over 1 (112), 121 over 4 (128).  An odd key
        # count puts the batch stride off the step: one batch.
        cases += [("bf16", "fused", 2 - nk % 2, h, min(nq, nk), nk, d)
                  for h, d in ((12, 67), (4, 67), (1, 36), (1, 100),
                               (4, 121))
                  for nk in (2, 3, 64, 65, 128, 129, 130, 361)
                  for nq in (48, 360)]
        cases += [("bf16", "rows84", 1, 3, nq, nk, 80)
                  for nk in (129, 361) for nq in (48, 360)]
        # The last key count the resident kernel takes by its block's
        # copies, and the first past it (the streamed kernel on a
        # zero-padded copy).
        cases += [("bf16", "rows84", 2, 3, 48, nk, 80)
                  for nk in (att.bf16_max_keys(80),
                             att.bf16_max_keys(80) + 1)]
    if only in ("all", "f32"):
        for d in (130, 192, 200, 256, 264, 600, 1016, 1017, 1032, 2048,
                  4100):
            cases += [("f32", "contiguous", 2, 3, nq, nk, d)
                      for nq, nk in ((48, 37), (200, 360), (360, 360))]
        # The scores-once kernels on the model's views: 16-byte copies
        # (1032 over 4 heads) and 4-byte ones (1031 over 3: columns past d
        # zero in the last stage).
        cases += [("f32", "fused", 2, h, nq, 360, d)
                  for h, d in ((4, 1032), (3, 1031)) for nq in (360, 48)]
        for d in (8, 18, 36, 48, 50, 64, 67, 80, 100, 120, 127, 128):
            cases += [("f32", layout, 2, h, nq, 360, d)
                      for layout, h in (("fused", 3), ("fused", 16),
                                        ("contiguous", 3))
                      for nq in (360, 48)]
        cases += [("f32", f"rows{st}", 2, 3, 360, 360, d)
                  for st, d in ((84, 80), (69, 67))]
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
            why = re.search(r"(\(C\d+\)).*serialized (due to .*?) in the "
                            r"function", line)
            print(f"{tag} ptxas: wgmma serialised in "
                  f"{fn.group(1) if fn else '?'}: "
                  f"{' '.join(why.groups()) if why else line.strip()[-160:]}")
        elif name and "attention" in name and (
                "Used" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line)):
            print(f"{tag} {name:48s} {line.strip()[:90]}")


def load(path, signatures=None):
    lib = ctypes.CDLL(path)
    for entry in ("mint_attention_f32", "mint_attention_bf16"):
        if hasattr(lib, entry):  # a variant's library has one of them
            fn = getattr(lib, entry)
            fn.argtypes = (signatures or _build._SIGNATURES)[entry]
            fn.restype = ctypes.c_int
    return lib


def parent_call(lib, q, k, v, scale):
    """One launch of a parent's kernel (PARENT_SIGNATURES: no workspace)
    on the operands this tree hands its own (ops.attention._call)."""
    q, k, v, out = att._operands(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    codes = ()
    if q.dtype == torch.bfloat16:
        codes = ((ctypes.c_int * 3)(*(att.ROUTES.index(att.bf16_route(t))
                                      for t in (q, k, v))),)
    b, h, nq, d = q.shape
    err = getattr(lib, att._ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        *codes, b, h, nq, k.shape[2], d, float(scale),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "the parent's attention kernel")
    return out


def build(sources, work):
    """{name: (source name, its text, include dir)} -> {name: library},
    one nvcc each, all at once."""
    procs = {}
    for name, (source, text, include) in sources.items():
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        # The bf16 sources call each other's launches.
        extra = ([os.path.join(include, s) for s in BF16_SOURCES
                  if s != source and os.path.exists(os.path.join(include, s))]
                 if source in BF16_SOURCES else [])
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-shared",
             "-o", path[:-3] + ".so", path, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} failed to build:\n{log}")
        ptxas_report(log, name)
        libs[name] = load(os.path.join(work, f"{name}.so"),
                          PARENT_SIGNATURES if name.startswith("parent")
                          else None)
    return libs


def kernel_split(fn, calls=10):
    """{device kernel name: mean µs a call} of `calls` calls of fn, as
    torch.profiler records them (the scores-once kernels' launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((n for n in att.ONCE_KERNELS[torch.float32]
                         + att.ONCE_KERNELS[torch.bfloat16] if n in e.name),
                        e.name[:40])
            us = getattr(e, "device_time", None)
            if us is None:
                us = e.cuda_time
            split[name] = split.get(name, 0.0) + us / calls
    return split


def calling(lname, lib, q, k, v):
    """A call of the library `lname` on q, k and v, with ops.attention's
    mirror of its choice (VARIANT_MIN_FRAME) and, for "repo_ws<MB>", a
    launch group of <MB> MB of workspace at most."""
    frame = VARIANT_MIN_FRAME.get(lname, att.SCORES_ONCE_MIN_FRAME[q.dtype])
    group = (int(lname[7:]) * 2 ** 20 if lname.startswith("repo_ws")
             else att.WORKSPACE_GROUP_BYTES)

    def call():
        saved = att.SCORES_ONCE_MIN_FRAME[q.dtype], att.WORKSPACE_GROUP_BYTES
        att.SCORES_ONCE_MIN_FRAME[q.dtype], att.WORKSPACE_GROUP_BYTES = (
            frame, group)
        try:
            return att._call(q, k, v, cs.SCALE, lib)
        finally:
            att.SCORES_ONCE_MIN_FRAME[q.dtype], att.WORKSPACE_GROUP_BYTES = (
                saved)
    return call


def library_math(q, k, v):
    """PyTorch's attention call on its math backend, on the same heads:
    the yardstick past 256 columns, where its fused backends refuse them;
    timed here, called by no kernel of the port."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v, scale=cs.SCALE)


# Run in a process of its own, sys.argv[1] a tree: that tree's flagship
# bf16 decode frames/s at batch 20 (its chip_smoke.throughput).
DECODE = """
import subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip().splitlines()[0]
print("rate", cs.throughput(cs.flagship(torch.bfloat16, "cuda"), "bf16",
                            card))
"""


def decode_turns(parent):
    """The flagship's bf16 batch-20 decode frames/s of the parent tree and
    of this one, in turns (parent, this, this, parent)."""
    rates = {"parent": [], "repo": []}
    for name in ("parent", "repo", "repo", "parent"):
        tree = os.path.abspath(parent) if name == "parent" else REPO
        out = subprocess.run([sys.executable, "-c", DECODE, tree],
                             capture_output=True, text=True, cwd=tree)
        lines = [x for x in out.stdout.splitlines() if x.startswith("rate ")]
        if out.returncode or not lines:
            raise SystemExit(f"decode in {tree} failed:\n{out.stderr[-3000:]}")
        rates[name].append(float(lines[-1].split()[1]))
        print(f"decode bf16 batch 20 {name}: {rates[name][-1]:.2f} frames/s",
              flush=True)
    return rates


def main():
    args = sys.argv[1:]
    only = next((a for a in args if a in ("all", "f32", "bf16")), "all")
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if "--decode" in args:
        rates = decode_turns(parent)
        print(f"decode bf16 batch 20 frames/s: repo {rates['repo']}, parent "
              f"{rates['parent']} ({card})", flush=True)
        return
    t0 = time.perf_counter()
    libs = {"repo": _build.library()}
    print(f"built in {time.perf_counter() - t0:.1f} s (one nvcc a source, "
          f"all at once)", flush=True)
    ptxas_report(_build.build_log, "repo")

    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    sources = {}
    for name, (source, edits) in VARIANTS.items():
        text = open(os.path.join(_build.CSRC, source)).read()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        sources[name] = (source, text, _build.CSRC)
    if parent:
        csrc = os.path.join(os.path.abspath(parent), "mint_tpu_torch", "csrc")
        for lname, source in (("parent", "attention.cu"),
                              ("parent_f32", "attention_f32.cu")):
            sources[lname] = (source, open(os.path.join(csrc, source)).read(),
                              csrc)
    t0 = time.perf_counter()
    others = build(sources, work)
    print(f"variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs.update((n, lib) for n, lib in others.items()
                if not n.startswith("parent"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for name, layout, b, h, nq, nk, d in checked_shapes(only):
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        q, k, v = cs._qkv(layout, b, h, nq, nk, d, dtype, gen)
        want = att.attention_reference(q, k, v, cs.SCALE)
        tol = 1e-5 if name == "f32" else 2 * cs.bf16_ulp(
            want.float().abs().max().item())
        routes = ("/".join(att.bf16_route(t) for t in (q, k, v))
                  if name == "bf16" else "")
        for lname, lib in libs.items():
            if lname != "repo" and (nq != 360 or "~" in lname
                                    or not lname.startswith(name)):
                continue
            got = calling(lname, lib, q, k, v)()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= tol and bool(torch.isfinite(got).all())
            bad += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {lname} {name} {layout} "
                  f"q[{b},{h},{nq},{d}] k[..,{nk},{d}] {routes}: max_abs_err "
                  f"{err:.3e} tol {tol:.3e}", flush=True)
    # The scores-once kernels with one unit of workspace a launch group
    # (a head's query tiles over several groups).
    group_bytes = att.WORKSPACE_GROUP_BYTES
    att.WORKSPACE_GROUP_BYTES = 1
    try:
        for name, layout, b, h, nq, nk, d in (
                [("f32", "contiguous", 2, 3, 200, 360, 1032),
                 ("f32", "fused", 2, 3, 360, 360, 1031)] * (only != "bf16")
                + [("bf16", "contiguous", 2, 3, 200, 360, 1360),
                   ("bf16", "fused", 2, 4, 360, 360, 1362)]
                * (only != "f32")):
            dtype = torch.bfloat16 if name == "bf16" else torch.float32
            q, k, v = cs._qkv(layout, b, h, nq, nk, d, dtype, gen)
            want = att.attention_reference(q, k, v, cs.SCALE)
            tol = 1e-5 if name == "f32" else 2 * cs.bf16_ulp(
                want.float().abs().max().item())
            got = att._call(q, k, v, cs.SCALE)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= tol and bool(torch.isfinite(got).all())
            bad += not ok
            print(f"{'ok  ' if ok else 'FAIL'} repo {name} {layout} "
                  f"q[{b},{h},{nq},{d}] k[..,{nk},{d}] one unit a group: "
                  f"max_abs_err {err:.3e} tol {tol:.3e}", flush=True)
    finally:
        att.WORKSPACE_GROUP_BYTES = group_bytes
    print(f"disagreeing: {bad}", flush=True)
    if bad:
        raise SystemExit(f"{bad} kernel results disagree")
    if "--check-only" in args:
        return

    for name, b, h, nq, nk, d, layout in TIMED:
        if only not in ("all", name):
            continue
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        q, k, v = cs._qkv(layout, b, h, nq, nk, d, dtype, gen)
        repo = libs["repo"]
        runs = {"repo": lambda: att._call(q, k, v, cs.SCALE, repo)}
        parent_lib = others.get("parent" if name == "bf16" else "parent_f32")
        if parent_lib is not None:
            runs["parent"] = lambda: parent_call(parent_lib, q, k, v,
                                                 cs.SCALE)
        if name == "bf16":
            routes = [att.bf16_route(t) for t in (q, k, v)]
            if att.bf16_resident(d, nk) and "copies" not in routes:
                runs["copies_route"] = lambda: att._call(
                    q, k, v, cs.SCALE, repo, ["copies"] * 3)
        else:
            routes = ""
        for lname, lib in libs.items():
            if lname.startswith(name):
                runs[lname] = calling(lname, lib, q, k, v)
        if att.device_kernels(q, k, v) == att.ONCE_KERNELS[dtype]:
            for mb in (32, 64):  # smaller launch groups
                runs[f"repo_ws{mb}"] = calling(f"repo_ws{mb}", repo, q, k, v)
        if d > 256:  # the library's math backend takes such heads
            runs["library_math"] = lambda: library_math(q, k, v)
        order = list(runs.items())
        first = {n: cs.cuda_ms(fn) for n, fn in order}
        second = {n: cs.cuda_ms(fn) for n, fn in reversed(order)}
        t_p = cs.cuda_ms(lambda: att.attention_reference(q, k, v, cs.SCALE),
                         3)
        b_ms, b_by = cs.bound(*cs.attention_work(b, h, nq, nk, d,
                                                 dtype.itemsize), name)
        kernels = ", ".join(f"{n} {first[n]:.4f} / {second[n]:.4f}"
                            for n, _ in order)
        print(f"time {name} q[{b},{h},{nq},{d}] k[..,{nk},{d}] {layout} "
              f"{'/'.join(routes)} ms: {kernels}; plain {t_p:.4f}; bound "
              f"{b_ms:.4f} ({b_by}) ({card})", flush=True)
        if att.device_kernels(q, k, v) == att.ONCE_KERNELS[dtype]:
            split = kernel_split(runs["repo"])
            print(f"split {name} q[{b},{h},{nq},{d}] µs a call: "
                  + ", ".join(f"{n} {us:.1f}" for n, us in split.items())
                  + f" ({card})", flush=True)


if __name__ == "__main__":
    main()
