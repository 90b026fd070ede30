"""Fused transformer MLP (fc1 + tanh-GELU + fc2): CUDA kernel and plain
version.

Counterpart of ``mint_tpu/ops/mlp.py``.  :func:`fused_mlp` is the port of
the Pallas kernel ``_fused_mlp_fwd_2d`` (its source is
``mint_tpu_torch/csrc/mlp.cu``); :func:`mlp_reference` is the plain
PyTorch version with the kernel's cast points.  Weights are taken in the
JAX layout, W1 [H, F] and W2 [F, O].  The kernel reads them transposed
(nn.Linear's [out, in] layout), so passing ``linear.weight.t()`` costs no
copy, while a contiguous JAX-layout tensor is copied once per call.

Gradients: where one is wanted, the kernel's launch runs inside
:class:`MLPFunction`, whose backward is the VJP of :func:`mlp_formula`
recomputed from the saved inputs, as the JAX custom VJP differentiates its
plain formula ``_reference_mlp`` (``mint_tpu/ops/mlp.py:111-121``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mint_tpu_torch.ops import _build

# Kernel launches made by :func:`fused_mlp` (the CUDA path only).
launches = 0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def mlp_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """gelu_tanh(x W1 + b1) W2 + b2 with the TPU kernel's cast points
    (``mint_tpu/ops/mlp.py:45-49``): fc1, bias and GELU in f32, the
    activation rounded to x's dtype, fc2 and b2 in f32, cast to x's dtype.
    """
    h = gelu_tanh(x.float() @ w1.float() + b1.float()).to(x.dtype)
    return (h.float() @ w2.float() + b2.float()).to(x.dtype)


def mlp_formula(x, w1, b1, w2, b2) -> torch.Tensor:
    """The JAX package's ``_reference_mlp``, the formula its custom VJP
    differentiates: ``gelu_tanh(x W1 + b1) W2 + b2`` in the inputs' dtype
    (on the card a bf16 GEMM accumulates in f32 and rounds its output).
    In f32 it is :func:`mlp_reference` up to summation order."""
    return gelu_tanh(x @ w1 + b1) @ w2 + b2


_ENTRY = {torch.float32: "mint_mlp_f32", torch.bfloat16: "mint_mlp_bf16"}


def limit_broken(dtype: torch.dtype) -> str | None:
    """Why no fused MLP kernel takes inputs of `dtype`, or None if one
    does.  Both take any widths (mlp.cu): f32 runs two FMA GEMM passes,
    bf16 two tensor-core ones, whose TMA loads need rows of whole 16-byte
    steps; :func:`_launch` pads other bf16 widths with zeros."""
    if dtype not in _ENTRY:
        return f"no fused MLP kernel takes {dtype} (float32, bfloat16)"
    return None


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused MLP on [..., H] inputs; weights [H, F], [F], [F, O], [O].

    ``b2=None`` adds no output bias (the kernel gets zeros): a
    tensor-parallel rank's fc2 is a partial sum, whose bias is added once
    after the ranks' sum (``models/layers.py``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises), through :class:`MLPFunction` only where autograd
    needs it (grad mode on and an input that requires grad).
    """
    if b2 is None:
        b2 = x.new_zeros(w2.shape[1])
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2)
    lead = x.shape[:-1]
    args = (x.reshape(-1, x.shape[-1]), w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = MLPFunction.apply(*args, _launch)
    else:
        out = _launch(*args)
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
    def forward(ctx, x, w1, b1, w2, b2, forward):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mlp_formula(*inputs)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def _launch(x, w1, b1, w2, b2):
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
    x = x.contiguous()
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    b1, b2 = b1.contiguous(), b2.contiguous()
    if x.dtype == torch.bfloat16:
        x, w1t, b1, w2t, b2 = _tma_operands(x, w1t, b1, w2t, b2)
    hp, fp, op = x.shape[1], w1t.shape[0], w2t.shape[0]
    out = torch.empty((m, op), dtype=x.dtype, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # fc1's GELU'd activation for fc2, then split partial sums.
    scratch = torch.empty(_scratch_bytes(x.device, x.dtype, m, hp, fp, op),
                          dtype=torch.uint8, device=x.device)
    err = getattr(lib, _ENTRY[x.dtype])(
        *(t.data_ptr() for t in (x, w1t, b1, w2t, b2, scratch)),
        out.data_ptr(), m, hp, fp, op, stream)
    _build.check(err, "fused MLP kernel launch")
    launches += 1
    return out if op == o else out[:, :o]


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def _tma_operands(x, w1t, b1, w2t, b2):
    """The bf16 kernel's operands: its TMA loads read x, W1^T, the
    activation and W2^T by rows of whole 16-byte steps from 16-byte aligned
    bases, and it writes the output in 4-byte pairs.  Widths that do not
    allow that get zero-padded copies, which leave every output the caller
    keeps unchanged: H up to a multiple of 8 (zero columns of x and of W1^T),
    F likewise (zero rows of W1^T and b1, so a GELU of 0, and zero columns
    of W2^T), O up to even (zero rows of W2^T and b2, cut off the output).
    A misaligned base is copied."""
    h, f, o = x.shape[1], w1t.shape[0], w2t.shape[0]
    hp, fp, op = _round_up(h, 8), _round_up(f, 8), _round_up(o, 2)
    if hp != h:
        x, w1t = F.pad(x, (0, hp - h)), F.pad(w1t, (0, hp - h))
    if fp != f:
        w1t, b1 = F.pad(w1t, (0, 0, 0, fp - f)), F.pad(b1, (0, fp - f))
        w2t = F.pad(w2t, (0, fp - f))
    if op != o:
        w2t, b2 = F.pad(w2t, (0, 0, 0, op - o)), F.pad(b2, (0, op - o))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, w1t, b1, w2t, b2))


@functools.lru_cache(maxsize=None)
def _scratch_bytes(device, dtype, m, h, f, o) -> int:
    """Bytes of scratch the kernel needs on ``device`` (its plan depends
    on the card's SM count), asked once per shape."""
    lib = _build.library()
    with torch.cuda.device(device):
        if dtype == torch.float32:
            n = lib.mint_mlp_f32_scratch(m, h, f, o) * 4
        else:
            n = lib.mint_mlp_bf16_scratch(m, h, f, o)
    if n < 0:
        raise RuntimeError(f"fused_mlp: cannot plan on {device}")
    return n
