"""Multi-head attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``mint_tpu/ops/attention.py``.  :func:`attention` is the
port of the Pallas kernel ``pallas_attention`` (its source is
``mint_tpu_torch/csrc/attention.cu``); :func:`attention_reference` is the
plain PyTorch version with the kernel's cast points.  The scale is always
passed in: FACT scales by the full model dim, ``800 ** -0.5``, not the
head dim (``mint_tpu/models/layers.py:84``).

Gradients: where one is wanted, the kernel's launch runs inside
:class:`AttentionFunction`, whose backward is the VJP of
:func:`attention_formula` recomputed from the saved q, k and v, as the
JAX custom VJP differentiates its plain formula ``xla_attention``
(``mint_tpu/ops/attention.py:127-142``).  No backward kernel exists there
either.
"""

from __future__ import annotations

import ctypes

import torch

from mint_tpu_torch.ops import _build

# Kernel launches made by :func:`attention` (the CUDA path only).
launches = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v; q [B, H, Nq, D], k/v [B, H, Nk, D].

    Scores in f32, then scaled, max-subtracted f32 softmax, P cast to v's
    dtype, P.V accumulated in f32, cast to q's dtype — the TPU kernel's
    arithmetic (``mint_tpu/ops/attention.py:53-68``).
    """
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    dots = dots - dots.amax(dim=-1, keepdim=True)
    e = torch.exp(dots)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_formula(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """The JAX package's ``xla_attention``, the formula its custom VJP
    differentiates: Q.K^T and P.V in the inputs' dtype (on the card a bf16
    GEMM accumulates in f32 and rounds its output), the softmax in f32, P
    cast to the inputs' dtype.  In f32 it is :func:`attention_reference`
    up to summation order."""
    dots = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(dots.to(torch.promote_types(q.dtype, torch.float32)),
                      dim=-1).to(q.dtype)
    return torch.matmul(p, v)


_ENTRY = {torch.float32: "mint_attention_f32",
          torch.bfloat16: "mint_attention_bf16"}


def bf16_max_keys(d: int) -> int:
    """The most keys the bf16 kernel takes at head dim d (a multiple of 16,
    <= 128): it holds the head's whole K in shared memory.  Mirrors
    ``tc_smem_bytes`` in csrc/attention.cu: 2 KB of mbarriers and slack,
    then every 64-key K tile and a ring of 3 V tiles, each 64 * 2 * d bytes,
    within the 232448 bytes a block may take on an H100, and at most 64
    tiles.  1216 keys at D = 80, 704 at D = 128."""
    return 64 * min(64, (232448 - 2048) // (64 * 2 * d) - 3)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Attention on [B, H, N, D] tensors; Nq may differ from Nk.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises).  The kernel reads q, k and v through their strides
    (any on B, H and N, D contiguous), so views of a fused QKV projection
    cost no copy, and returns a [B, H, Nq, D] view of [B, Nq, H, D]
    storage, so merging the heads afterwards is a view too.  The launch
    goes through :class:`AttentionFunction` only where autograd needs it
    (grad mode on and an input that requires grad): the decode, under
    ``no_grad``, launches directly.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return AttentionFunction.apply(q, k, v, scale, _launch)
    return _launch(q, k, v, scale)


class AttentionFunction(torch.autograd.Function):
    """``forward(q, k, v, scale)`` as the forward, and the VJP of
    :func:`attention_formula` as the backward (the JAX package's
    ``_pallas_attention_fwd`` / ``_pallas_attention_bwd``: in bf16 the
    backward's GEMMs run in bf16, as XLA's VJP of ``xla_attention`` does).

    ``forward`` is the kernel's launch on the card; the CPU tests pass the
    plain version in its place.  q, k and v are saved as they are (the
    model's strided views of its fused QKV output: no copy)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, forward):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_formula(*inputs, ctx.scale)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None, None)


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA loads can read `t` as it is: a
    16-byte aligned base and every stride of a dim longer than 1 a whole
    number of 16-byte steps (D itself contiguous)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1))


def _launch(q, k, v, scale):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must share one device")
    q, k, v, out = _operands(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    b, h, nq, d = q.shape
    err = getattr(_build.library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, nq, k.shape[2], d, float(scale), stream)
    _build.check(err, "attention kernel launch")
    launches += 1
    return out


def _operands(q, k, v):
    """Checks q, k and v against what the kernel of their dtype takes and
    returns what it is given: q, k and v as they are (a copy only of a
    layout the kernel cannot read, never the model's) and the output, a
    [B, H, Nq, D] view of new [B, Nq, H, D] storage."""
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         "(needs one of float32, bfloat16 for all three)")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    # f32 runs on the FMA kernel, bf16 on the tensor-core one, whose head
    # dim steps by 16 (attention.cu).
    d_step = 1 if q.dtype == torch.float32 else 16
    if (not 0 < d <= 128 or d % d_step or nq == 0 or nk == 0
            or not 0 < b * h <= 65535):
        raise ValueError(f"attention: the {q.dtype} kernel takes 0 < D <= "
                         f"128 (a multiple of {d_step}), N > 0 and "
                         f"B*H <= 65535; got {tuple(q.shape)}, Nk={nk}")
    if q.dtype == torch.bfloat16:
        if nk > bf16_max_keys(d):
            raise ValueError(f"attention: the bf16 kernel holds a head's K "
                             f"in shared memory, at most {bf16_max_keys(d)} "
                             f"keys at D={d}; got Nk={nk}")
        # Layouts TMA cannot address are copied once (never the model's).
        q, k, v = (t if _tma_ready(t) else t.contiguous() for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty((b, nq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return q, k, v, out
