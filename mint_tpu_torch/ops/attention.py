"""Multi-head attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``mint_tpu/ops/attention.py``.  :func:`attention` is the
port of the Pallas kernel ``pallas_attention`` (its source is
``mint_tpu_torch/csrc/attention_f32.cu`` and ``attention.cu``, with
``attention_pairs.cu`` and ``attention_stream.cu``);
:func:`attention_reference` is the
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
import math

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


# Where each kernel's schedule for heads over 128 changes
# (csrc/attention*.cu): up to this width (bf16: of the head's frame in its
# tiles, the head dim and the columns it lies into them, _col_shift) Q's
# rows stay in shared memory for the whole pass over the keys, over every
# column of the head: f32 attention_wide_kernel (one warp's 16 rows of Q
# and a 32-key K tile over the head, a 32-key V tile, P; the whole head
# one output chunk), bf16 attention_tc_stream_kernel (a warpgroup's 64
# rows of Q over the head in chunks of at most 256 columns and a ring of
# 64-key tiles; past 256 columns two output chunks on the grid, each
# block computing every score).  Wider heads take the scores-once kernels
# (SCORES_ONCE_MIN_FRAME on): each score computed once a call over the
# whole head into a workspace (workspace_bytes), each row normalised
# there, then P.V over output chunks that read P (ONCE_KERNELS).  The
# boundary is where an H100 ran them faster than the resident-Q form in
# one call (PERF.md, PR 17): f32 from the first head past one output
# chunk on (q[20,4,360,264]: 0.423 ms against 0.879), bf16 past two
# chunks of 176 columns, the widest the streamed kernel holds without
# spills (352: 0.141 against 0.122; 368: 0.145 against 0.154).
RESIDENT_Q_MAX_HEAD_DIM = {torch.float32: 256, torch.bfloat16: 352}
SCORES_ONCE_MIN_FRAME = {dtype: width + 1 for dtype, width
                         in RESIDENT_Q_MAX_HEAD_DIM.items()}

# The widest head the kernels take: the C entries take it, and a frame up
# to 7 columns wider rounded up to whole output chunks, in a C int.
HEAD_DIM_CEILING = 2 ** 30

# The most workspace one launch group of the scores-once kernels takes; a
# call whose units (a (batch, head) pair's 64 query rows) need more runs
# in several groups, each three launches.  Fewer groups ran faster on an
# H100 although the workspace then outgrows the 50 MB of L2 (q[20,4,360,
# 520] bf16: 0.185 ms in one group of 69 MB, 0.205 in three of at most
# 32 MB; PERF.md, PR 17).
WORKSPACE_GROUP_BYTES = 256 * 2 ** 20


def scores_once(dtype: torch.dtype, frame: int) -> bool:
    """Whether the kernel of `dtype` runs the scores-once kernels for
    heads whose frame (f32: the head dim; bf16: see _frame) is `frame`
    columns wide (csrc/attention_f32.cu's launch_f32,
    csrc/attention.cu's launch_bf16)."""
    return frame >= SCORES_ONCE_MIN_FRAME[dtype]


def _unit_bytes(dtype: torch.dtype, nk: int) -> int:
    """Workspace of one unit (64 query rows of a pair) against nk keys:
    f32 its scores, then P in place, rows of nk rounded up to 32 floats
    (csrc/attention_f32.cu's once_f32_unit_bytes); bf16 a 64-key tile's
    f32 scores (16 KB) and bf16 P (8 KB) for every key tile
    (csrc/attention_once.cu's once_unit_bytes)."""
    if dtype == torch.float32:
        return 4 * 64 * (-(-nk // 32) * 32)
    return -(-nk // 64) * (64 * 64 * 4 + 64 * 64 * 2)


def workspace_bytes(dtype: torch.dtype, pairs: int, nq: int,
                    nk: int) -> int:
    """Bytes of workspace the scores-once kernels take for `pairs` (batch,
    head) pairs of nq queries against nk keys: every unit's (64 query rows
    of a pair) where they fit WORKSPACE_GROUP_BYTES, else as many units as
    fit, at least one; the kernels run as many launch groups as that
    takes (csrc/attention.cuh's over_groups)."""
    unit = _unit_bytes(dtype, nk)
    units = pairs * -(-nq // 64)
    return min(units, max(1, WORKSPACE_GROUP_BYTES // unit)) * unit


def bf16_max_keys(d: int) -> int:
    """Where the bf16 kernels part at head dim d: up to this many keys the
    resident kernel holds the head's whole K in shared memory, past it the
    streamed kernel runs (K and V through a ring of 64-key tiles, Q in
    shared memory); heads over 128 wide always stream (0).  Mirrors
    ``tc_smem_bytes`` in csrc/attention_tc.cuh: 2 KB of mbarriers and slack,
    then every 64-key K tile and a ring of 3 V tiles, each 64 * 2 * D bytes
    for D the head dim rounded up to 16, within the 232448 bytes a block
    may take on an H100, and at most 64 tiles.  1216 keys at D = 80, 704
    at D = 128."""
    if d > 128:
        return 0
    width = -(-d // 16) * 16
    return 64 * min(64, (232448 - 2048) // (64 * 2 * width) - 3)


def limit_broken(dtype: torch.dtype) -> str | None:
    """Why no attention kernel takes inputs of `dtype`, or None if one
    does.  Both kernels take any key count and batch of heads, and any
    head dim up to HEAD_DIM_CEILING (csrc/attention*.cu): f32 runs on the
    FMA kernels, bf16 on the tensor-core ones."""
    if dtype not in _ENTRY:
        return f"no attention kernel takes {dtype} (float32, bfloat16)"
    return None


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


# How the bf16 kernel loads a view (csrc/attention_tc.cuh's Route), by
# code.
ROUTES = ("tma_view", "tma_columns", "copies", "tma_pairs")


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can address `t` as a [B, H, N, D] tensor: a 16-byte
    aligned base and every stride of a dim longer than 1 a whole number of
    16-byte steps (D itself contiguous).  Any D: its loads read zeros past
    it."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1))


def bf16_route(t: torch.Tensor) -> str:
    """How the bf16 kernel loads the view `t` (D contiguous), as it lies:
    "tma_view", TMA over [B, H, N, D] (see _tma_ready); else "tma_columns",
    TMA over a token row's head columns, [B, N, (H - 1) * st_h + D], where
    the base and the B and N strides are whole 16-byte steps, whatever the
    head stride (the model's fused QKV views at head dims no multiple of 8,
    where the token stride 3 * H * D * 2 bytes is a multiple of 16: hidden
    800 over 16 heads, 1040 over 8; a head's boxes start on the 16-byte step
    at or before it, see _col_shift); else "tma_pairs", TMA over its even
    token rows and over its odd ones, where the token stride is 8 bytes
    past a 16-byte step (hidden 804 over 12 heads: 4824-byte rows; the
    resident kernel only); else "copies", the block's threads copying rows
    into the layout TMA writes (any view; the resident kernel only)."""
    if _tma_ready(t):
        return "tma_view"
    b, h, n, d = t.shape
    columns = (h - 1) * t.stride(1) + d + 4 < 2 ** 31
    if (t.data_ptr() % 16 == 0 and (b == 1 or t.stride(0) % 8 == 0)
            and (n == 1 or t.stride(2) % 8 == 0) and columns):
        return "tma_columns"
    if (t.data_ptr() % 8 == 0 and (b == 1 or t.stride(0) % 8 == 0)
            and n > 1 and t.stride(2) % 8 == 4 and columns):
        return "tma_pairs"
    return "copies"


def _col_shift(t: torch.Tensor, route: str) -> int:
    """The most columns a head of `t` lies into its tiles on `route`: TMA
    takes no box whose first column is off a 16-byte step, so over a token
    row's head columns a head's boxes start at the step at or before it,
    h * st_h % 8 columns early (8 - gcd(st_h, 8) at most; at most 7 over
    the token rows of one parity; csrc/attention_tc.cuh's col_shift)."""
    if route == "tma_pairs":
        return 7
    if route != "tma_columns" or t.shape[1] == 1:
        return 0
    return 8 - math.gcd(8, t.stride(1) % 8)


def _resident_route(k_route: str, v_route: str) -> str:
    """The one route the resident kernel loads K and V by
    (csrc/attention.cu's load_route)."""
    pairs = (k_route == "tma_pairs", v_route == "tma_pairs")
    if "copies" in (k_route, v_route) or pairs[0] != pairs[1]:
        return "copies"
    if pairs[0]:
        return "tma_pairs"
    return ("tma_columns" if "tma_columns" in (k_route, v_route)
            else "tma_view")


def bf16_resident(frame: int, nk: int, pairs: bool = False) -> bool:
    """Whether the bf16 attention over nk keys of heads whose tiles hold
    `frame` columns (the head dim and its _col_shift) runs on the resident
    kernel (any view), rather than the streamed one (TMA's views only).
    `pairs`: K and V on "tma_pairs" (csrc/attention.cu's launch_bf16):
    the even rows' tiles, then the odd rows' (one more tile where both
    parities end in a partial one)."""
    if not pairs:
        return frame <= 128 and nk <= bf16_max_keys(frame)
    width = -(-frame // 16) * 16
    tiles = -(-((nk + 1) // 2) // 64) + -(-(nk // 2) // 64)
    smem = 2048 + (tiles + min(tiles, 3)) * 64 * 2 * width
    return frame <= 128 and tiles <= 64 and smem <= 232448


def _streamable(q, k, v):
    """q, k and v as the streamed and scores-once kernels take them: by
    TMA over the view or its head columns, q's heads as many columns into
    their tiles as k's (their head strides alike modulo 8).  A view that
    is not is copied once into zero-padded rows (_tma_copy; never one of
    the model's)."""
    views = (q, k, v)
    routes = [bf16_route(t) for t in views]
    copy = [r in ("copies", "tma_pairs") for r in routes]
    steps = [t.stride(1) % 8 if r == "tma_columns" and t.shape[1] > 1 else 0
             for t, r in zip(views, routes)]
    if steps[0] != steps[1]:
        copy[0] = copy[0] or routes[0] == "tma_columns"
        copy[1] = copy[1] or routes[1] == "tma_columns"
    return tuple(_tma_copy(t) if c else t for t, c in zip(views, copy))


def _tma_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` copied into new storage whose rows are its head dim rounded up
    to 8 columns, zeros after it, returned as a view of `t`'s shape: a view
    the streamed kernel's TMA loads read (a layout the model never hands
    it)."""
    d = t.shape[-1]
    out = t.new_zeros(*t.shape[:-1], -(-d // 8) * 8)
    out[..., :d] = t
    return out[..., :d]


def _frame(q, k, v) -> int:
    """The frame of the heads of q, k and v as _operands hands them to
    the kernel: f32 the head dim; bf16 the head dim and the most columns
    a head lies into the tiles of any of them (_col_shift of its
    bf16_route; csrc/attention.cu's launch_bf16 reckons the streamed
    kernels' frames so)."""
    d = q.shape[-1]
    if q.dtype != torch.bfloat16:
        return d
    return d + max(_col_shift(t, bf16_route(t)) for t in (q, k, v))


# The scores-once kernels of each dtype, in the order one call launches
# them (once a launch group).
ONCE_KERNELS = {
    torch.float32: ("attention_scores_f32_kernel",
                    "attention_softmax_f32_kernel",
                    "attention_pv_f32_kernel"),
    torch.bfloat16: ("attention_scores_tc_kernel",
                     "attention_probs_tc_kernel", "attention_pv_tc_kernel"),
}


def device_kernels(q, k, v) -> tuple[str, ...]:
    """The kernels of csrc/attention*.cu that one attention call on q, k
    and v runs (once; the scores-once kernels once a launch group), as the
    C entries choose them: f32 attention_kernel (its instances, and
    attention_kernel_4, up to 128 columns), attention_wide_kernel (to
    RESIDENT_Q_MAX_HEAD_DIM) or the scores-once kernels; bf16 the resident
    attention_tc_kernel (attention_tc_pairs_kernel on tma_pairs), the
    streamed attention_tc_stream_kernel, or the scores-once kernels."""
    q, k, v, _ = _operands(q, k, v)
    d, nk = q.shape[-1], k.shape[2]
    if q.dtype == torch.float32:
        if scores_once(q.dtype, d):
            return ONCE_KERNELS[q.dtype]
        return ("attention_wide_kernel" if d > 128 else "attention_kernel",)
    routes = [bf16_route(t) for t in (k, v)]
    route = _resident_route(*routes)
    frame = d + (0 if route == "copies" else max(
        _col_shift(t, r) for t, r in zip((k, v), routes)))
    if bf16_resident(frame, nk, route == "tma_pairs"):
        return ("attention_tc_pairs_kernel" if route == "tma_pairs"
                else "attention_tc_kernel",)
    if scores_once(q.dtype, _frame(q, k, v)):
        return ONCE_KERNELS[q.dtype]
    return ("attention_tc_stream_kernel",)


def _launch(q, k, v, scale):
    global launches
    out = _call(q, k, v, scale)
    launches += 1
    return out


def _call(q, k, v, scale, lib=None, routes=None):
    """One launch of the kernel of q's dtype in the library `lib` (by
    default the package's); bf16 loads q, k and v by `routes` (names in
    ROUTES), by default each view's bf16_route."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must share one device")
    lib = lib or _build.library()
    q, k, v, out = _operands(q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    b, h, nq, d = q.shape
    nk = k.shape[2]
    codes = ()
    if q.dtype == torch.bfloat16:
        codes = ((ctypes.c_int * 3)(*(ROUTES.index(r) for r in (
            routes or [bf16_route(t) for t in (q, k, v)]))),)
    # The scores-once kernels' workspace, from the caching allocator on
    # the call's stream (a graph capture's pool takes it as the output).
    ws = None
    if scores_once(q.dtype, _frame(q, k, v)):
        ws = torch.empty(workspace_bytes(q.dtype, b * h, nq, nk),
                         dtype=torch.uint8, device=q.device)
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        *codes, None if ws is None else ws.data_ptr(),
        0 if ws is None else ws.numel(), b, h, nq, nk, d, float(scale),
        stream)
    _build.check(err, "attention kernel launch")
    return out


def _operands(q, k, v):
    """Checks q, k and v and returns what the kernel of their dtype is
    given: q, k and v as they are (a copy only of a layout the kernel
    cannot read, never the model's) and the output, a [B, H, Nq, D] view
    of new [B, Nq, H, D] storage."""
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
    if nq == 0 or nk == 0 or b * h == 0 or d == 0:
        raise ValueError(f"attention: empty input; got {tuple(q.shape)}, "
                         f"Nk={nk}")
    if d > HEAD_DIM_CEILING:
        raise ValueError(f"attention: head dim {d} over the "
                         f"{HEAD_DIM_CEILING} the kernels take")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        routes = [bf16_route(t) for t in (k, v)]
        route = _resident_route(*routes)
        frame = d + (0 if route == "copies" else max(
            _col_shift(t, r) for t, r in zip((k, v), routes)))
        if not bf16_resident(frame, nk, route == "tma_pairs"):
            q, k, v = _streamable(q, k, v)
    out = torch.empty((b, nq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return q, k, v, out
