"""Build ``csrc/*.cu`` with nvcc into one shared library and load it.

The library has a plain C interface (every pointer and the stream a
``ctypes.c_void_p``; every entry point returns ``cudaGetLastError()``),
so nvcc compiles it in seconds without PyTorch's headers.  It is built
at first use, never at import, into ``mint_tpu_torch/_build/`` keyed by
a hash of the sources and flags, so an unchanged tree reuses it.  Each
``.cu`` compiles to an object in its own nvcc process, all at once, and
the objects are then linked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of this process's build (ptxas report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)
_R = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes.  Each returns cudaError_t as int.
_SIGNATURES = {
    # q, k, v, out, strides (b, h, n of each), the scores-once kernels'
    # workspace and its bytes (null and 0 where they do not run), B, H, nq,
    # nk, d, scale, stream
    "mint_attention_f32": [_P, _P, _P, _P, _S, _P, _L, _I, _I, _I, _I, _I,
                           _F, _P],
    # the same with the routes of q, k and v (ops.attention.ROUTES) after
    # the strides
    "mint_attention_bf16": [_P, _P, _P, _P, _S, _R, _P, _L, _I, _I, _I, _I,
                            _I, _F, _P],
    # q, k, v, the output's gradient, dq, dk, dv, the statistics'
    # workspace, strides (b, h, n of each of the seven), B, H, nq, nk, d,
    # scale, stream
    "mint_attention_bwd_bf16": [_P] * 8 + [_S, _I, _I, _I, _I, _I, _F, _P],
    # x, w1, b1, w2, b2, scratch, out, m, h, f, o, stream
    "mint_mlp_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same with the row strides of x, w1, w2 and the activation and the
    # plan (column tiles and loads, ops.mlp.bf16_plan, and fc1's GELU) after
    # out
    "mint_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _S, _R, _I, _I, _I, _I,
                      _P],
    # x, gamma, beta (both null: no affine), out, rows, cols, eps, stream
    "mint_layer_norm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    # slots (int64 on the card), phase, stream
    "mint_trace_stamp": [_P, _I, _P],
    # h, a, gamma|beta rows, out, rows, cols, seq, gamma|beta's row stride,
    # stream (ops/film.py)
    "mint_film_residual_bf16": [_P, _P, _P, _P, _L, _I, _I, _L, _P],
    # x, gamma, beta (both null: no LayerNorm), the (cos, sin) table, the
    # normed rows (null: not written), the rotated rows, rows, cols, seq,
    # first position, eps, stream
    "mint_film_rotary_bf16": [_P] * 6 + [_I, _I, _I, _I, _F, _P],
}


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                       "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile_and_link(out: str) -> str:
    """Compile every ``.cu`` to an object, one nvcc each, all started
    together; link the objects into ``out``.  Returns nvcc's output."""
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}"
    cu = [p for p in sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o",
                               obj, src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    try:
        failed = [os.path.basename(src) for src, p in zip(cu, procs)
                  if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.so", *objs],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["the link"]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        os.replace(f"{tmp}.so", out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_log
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"libmint_kernels_{_digest()}.so")
        if not os.path.exists(out):
            build_log = _compile_and_link(out)
        lib = ctypes.CDLL(out)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mint_error_string.argtypes = [ctypes.c_int]
        lib.mint_error_string.restype = ctypes.c_char_p
        # m, h, f, o (and bf16's column tiles and activation stride) ->
        # scratch that mint_mlp_f32 (floats) and mint_mlp_bf16 (bytes)
        # need; -1 on error
        for name, n in (("mint_mlp_f32_scratch", 4),
                        ("mint_mlp_bf16_scratch", 7)):
            getattr(lib, name).argtypes = [_I] * n
            getattr(lib, name).restype = ctypes.c_longlong
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().mint_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
