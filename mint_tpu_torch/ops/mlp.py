"""Fused transformer MLP (fc1 + GELU + fc2): CUDA kernel and plain version.

Counterpart of ``mint_tpu/ops/mlp.py``.  :func:`fused_mlp` is the port of
the Pallas kernel ``_fused_mlp_fwd_2d`` (its source is
``mint_tpu_torch/csrc/mlp.cu``); :func:`mlp_reference` is the plain
PyTorch version with the kernel's cast points.  Weights are taken in the
JAX layout, W1 [H, F] and W2 [F, O].  The kernel reads them transposed
(nn.Linear's [out, in] layout), so passing ``linear.weight.t()`` costs no
copy, while a contiguous JAX-layout tensor is copied once per call.  The
bf16 kernel reads x and the weights where they lie at any widths and any
element-aligned base (:func:`bf16_plan` says how); the f32 kernel takes
contiguous copies.

GELU is FACT's tanh form unless the caller asks for ``activation="erf"``
(EDGE's ``F.gelu``): the bf16 kernel then applies erf-GELU in the same
epilogue (the C entry's ``plan[6]``; the tanh path is the same code as
before, the same bits).  The f32 kernel's epilogue is tanh alone, so an
f32 erf call on the card is refused, never run as tanh (EDGE, the one
erf model, runs bf16 on the card).

Gradients: where one is wanted, the kernel's launch runs inside
:class:`MLPFunction`, whose backward is the VJP of :func:`mlp_formula`
recomputed from the saved inputs, as the JAX custom VJP differentiates its
plain formula ``_reference_mlp`` (``mint_tpu/ops/mlp.py:111-121``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mint_tpu_torch.ops import _build

# Kernel launches made by :func:`fused_mlp` (the CUDA path only).
launches = 0

#: fc1's GELU by name, in the order of the bf16 C entry's code (plan[6]).
ACTIVATIONS = ("tanh", "erf")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, ``0.5 x (1 + erf(x / sqrt 2))`` (EDGE's ``F.gelu``)."""
    return F.gelu(x)


GELU = {"tanh": gelu_tanh, "erf": gelu_erf}


def mlp_reference(x, w1, b1, w2, b2, activation: str = "tanh"
                  ) -> torch.Tensor:
    """gelu(x W1 + b1) W2 + b2 with the TPU kernel's cast points
    (``mint_tpu/ops/mlp.py:45-49``): fc1, bias and GELU (`activation`'s)
    in f32, the activation rounded to x's dtype, fc2 and b2 in f32, cast
    to x's dtype.
    """
    h = GELU[activation](x.float() @ w1.float() + b1.float()).to(x.dtype)
    return (h.float() @ w2.float() + b2.float()).to(x.dtype)


def mlp_formula(x, w1, b1, w2, b2, activation: str = "tanh"
                ) -> torch.Tensor:
    """The JAX package's ``_reference_mlp``, the formula its custom VJP
    differentiates: ``gelu_tanh(x W1 + b1) W2 + b2`` in the inputs' dtype
    (on the card a bf16 GEMM accumulates in f32 and rounds its output).
    In f32 it is :func:`mlp_reference` up to summation order."""
    return GELU[activation](x @ w1 + b1) @ w2 + b2


_ENTRY = {torch.float32: "mint_mlp_f32", torch.bfloat16: "mint_mlp_bf16"}


def limit_broken(dtype: torch.dtype) -> str | None:
    """Why no fused MLP kernel takes inputs of `dtype`, or None if one
    does.  Both take any widths (mlp.cu): f32 runs two FMA GEMM passes,
    bf16 two tensor-core ones, loading each operand by the route its
    layout allows (:func:`bf16_plan`)."""
    if dtype not in _ENTRY:
        return f"no fused MLP kernel takes {dtype} (float32, bfloat16)"
    return None


def fused_mlp(x, w1, b1, w2, b2, activation: str = "tanh"
              ) -> torch.Tensor:
    """Fused MLP on [..., H] inputs; weights [H, F], [F], [F, O], [O];
    fc1's GELU `activation` (``ACTIVATIONS``).

    ``b2=None`` adds no output bias (the kernel gets zeros): a
    tensor-parallel rank's fc2 is a partial sum, whose bias is added once
    after the ranks' sum (``models/layers.py``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises), through :class:`MLPFunction` only where autograd
    needs it (grad mode on and an input that requires grad).
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp: activation {activation!r} not in "
                         f"{ACTIVATIONS}")
    if b2 is None:
        b2 = x.new_zeros(w2.shape[1])
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2, activation)
    lead = x.shape[:-1]
    args = (x.reshape(-1, x.shape[-1]), w1, b1, w2, b2)
    launch = (_launch if activation == "tanh"
              else functools.partial(_launch, activation=activation))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = MLPFunction.apply(*args, launch, activation)
    else:
        out = launch(*args)
    return out.reshape(*lead, out.shape[-1])


class MLPFunction(torch.autograd.Function):
    """``forward(x, w1, b1, w2, b2)`` as the forward, and the VJP of
    :func:`mlp_formula` as the backward (the JAX package's ``_fwd`` /
    ``_bwd``: in bf16 the backward's GEMMs run in bf16, as XLA's VJP of
    ``_reference_mlp`` does).

    ``forward`` is the kernel's launch on the card; the CPU tests pass the
    plain version in its place.  The inputs are saved as they are (the
    model's ``.t()`` views of its weights: no copy)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, forward, activation="tanh"):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.activation = activation
        return forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mlp_formula(*inputs, ctx.activation)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None, None)


# The bf16 kernel's column tiles (csrc/mlp.cu's instances): fc1's and
# fc2's, the flagship's first (F = 3072 in 16 tiles of 192, O = 800 in 4
# of 200); fc1 on tma_pairs takes 192 alone (two halves of 96 columns);
# fc2 on tma_phases tiles the activation's rows by 200 (and W2^T's by 128:
# csrc/mlp_phases.cu's transposed product).
TILES = ((192, 200), (200, 208))
PAIRS_TILES = (192,)
PHASES_TILE = 200
# The activation's row stride is F rounded up to this: rows on 128-byte
# lines for fc2's TMA loads (rows on 16-byte steps alone, F = 3080's 6160
# bytes, ran fc2 at 0.0957 ms against 0.0790 on an H100).
ACT_STEP = 64
# How the bf16 kernel loads an operand [rows, K] (csrc/mlp_tc.cuh's Load):
# TMA; staged (16-byte words copied as they lie, then moved in shared
# memory: any layout); for fc1's x and W1^T both with rows 8 bytes past a
# 16-byte step (hidden 804), TMA over their even rows and their odd rows;
# or, for fc2's W2^T on a step with rows off it (F no multiple of 8), TMA
# over each of its rows' 2, 4 or 8 phases.
LOADS = ("tma", "staged", "tma_pairs", "tma_phases")


class Bf16Plan(NamedTuple):
    """How the bf16 kernel runs one call."""
    tiles: tuple[int, int]  # fc1's and fc2's column tiles
    loads: tuple[str, str, str, str]  # x, W1^T, the activation, W2^T
    act_ld: int  # the activation's row stride (elements)


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def _row_stride(t: torch.Tensor) -> int:
    """The elements between rows of the [rows, K] operand t (one row: K
    rounded up to 8, a stride every route takes)."""
    return t.stride(0) if t.shape[0] > 1 else _round_up(t.shape[1], 8)


def _load(t: torch.Tensor) -> str:
    """The route that loads `t` as it lies: TMA where its base and row
    stride are whole 16-byte steps, else staged."""
    tma = t.data_ptr() % 16 == 0 and _row_stride(t) % 8 == 0
    return "tma" if tma else "staged"


def _tile(n: int, widths: tuple[int, ...]) -> int:
    """The width of `widths` that covers n columns in the fewest tiles,
    the first on a tie."""
    return min(widths, key=lambda w: -(-n // w))


def _pairs(t: torch.Tensor) -> bool:
    """Whether `t`'s rows alternate between two 16-byte phases, 8 bytes
    apart, from a base on a step: two TMA maps read it, every other row."""
    return (t.shape[0] > 1 and t.data_ptr() % 16 == 0
            and t.stride(0) % 8 == 4)


def _phases(t: torch.Tensor) -> bool:
    """Whether `t`'s rows start off the 16-byte step from a base on one:
    a TMA map over each of their phases reads it (fc2's W2^T at an MLP
    width no multiple of 8)."""
    return (t.shape[0] > 1 and t.data_ptr() % 16 == 0
            and t.stride(0) % 8 != 0)


def bf16_plan(x: torch.Tensor, w1t: torch.Tensor,
              w2t: torch.Tensor) -> Bf16Plan:
    """The bf16 kernel's plan for x [M, H], W1^T [F, H] and W2^T [O, F]
    (each K-contiguous, as :func:`_operands` hands them): each pass's
    column tile (the fewest tiles its instances allow: F = 3080 in 16 of
    200, O = 804 in 4 of 208; PHASES_TILE where W2^T is on tma_phases),
    each operand's load (fc1 on tma_pairs where x and W1^T both allow it,
    W2^T on tma_phases where it allows it), and the activation's row
    stride, F rounded up to ACT_STEP."""
    f, o = w1t.shape[0], w2t.shape[0]
    pairs = _pairs(x) and _pairs(w1t)
    fc1 = ("tma_pairs",) * 2 if pairs else (_load(x), _load(w1t))
    w2 = "tma_phases" if _phases(w2t) else _load(w2t)
    return Bf16Plan((_tile(f, PAIRS_TILES if pairs else TILES[0]),
                     PHASES_TILE if w2 == "tma_phases"
                     else _tile(o, TILES[1])),
                    (*fc1, "tma", w2), _round_up(f, ACT_STEP))


def _operands(x, w1, b1, w2, b2):
    """x [M, H], W1^T [F, H], b1, W2^T [O, F], b2 as the bf16 kernel reads
    them: the caller's own tensors wherever each row is contiguous and rows
    do not overlap (the model's activations and nn.Linear's weights as
    ``.t()`` views: no copy), else contiguous copies."""
    def rows(t):
        ok = t.stride(1) == 1 and (t.shape[0] == 1
                                   or t.stride(0) >= t.shape[1])
        return t if ok or t.shape[1] == 1 else t.contiguous()
    return rows(x), rows(w1.t()), b1.contiguous(), rows(w2.t()), \
        b2.contiguous()


def _launch(x, w1, b1, w2, b2, activation="tanh"):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    tensors = (x, w1, b1, w2, b2)
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("fused_mlp: all inputs must share one dtype of "
                         f"float32, bfloat16; got {[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_mlp: inputs must share one device")
    m, h = x.shape
    f = w1.shape[1]
    o = w2.shape[1]
    if (w1.shape != (h, f) or b1.shape != (f,) or w2.shape != (f, o)
            or b2.shape != (o,)):
        raise ValueError(
            f"fused_mlp: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if m == 0:
        return x.new_empty((0, o))
    if x.dtype == torch.float32 and activation != "tanh":
        raise ValueError(f"fused_mlp: {activation}-GELU is the bf16 "
                         "kernel's alone (the f32 kernel's epilogue is tanh)")
    out = torch.empty((m, o), dtype=x.dtype, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        x, w1t, b1, w2t, b2 = _operands(x, w1, b1, w2, b2)
        plan = bf16_plan(x, w1t, w2t)
        lds = (ctypes.c_longlong * 4)(*map(_row_stride, (x, w1t, w2t)),
                                      plan.act_ld)
        codes = (ctypes.c_int * 7)(*plan.tiles,
                                   *map(LOADS.index, plan.loads),
                                   ACTIVATIONS.index(activation))
        extra = (lds, codes)
    else:
        x, w1t, b1 = x.contiguous(), w1.t().contiguous(), b1.contiguous()
        w2t, b2 = w2.t().contiguous(), b2.contiguous()
        plan, extra = None, ()
    # fc1's GELU'd activation for fc2, then split partial sums.
    scratch = torch.empty(
        _scratch_bytes(x.device, x.dtype, m, h, f, o,
                       (*plan.tiles, plan.act_ld) if plan else ()),
        dtype=torch.uint8, device=x.device)
    err = getattr(lib, _ENTRY[x.dtype])(
        *(t.data_ptr() for t in (x, w1t, b1, w2t, b2, scratch)),
        out.data_ptr(), *extra, m, h, f, o, stream)
    _build.check(err, "fused MLP kernel launch")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _scratch_bytes(device, dtype, m, h, f, o, layout) -> int:
    """Bytes of scratch the kernel needs on ``device`` (its plan depends
    on the card's SM count and, in bf16, the column tiles and the
    activation's stride: `layout`), asked once per shape."""
    lib = _build.library()
    with torch.cuda.device(device):
        if dtype == torch.float32:
            n = lib.mint_mlp_f32_scratch(m, h, f, o) * 4
        else:
            n = lib.mint_mlp_bf16_scratch(m, h, f, o, *layout)
    if n < 0:
        raise RuntimeError(f"fused_mlp: cannot plan on {device}")
    return n
