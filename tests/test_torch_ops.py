"""The port's kernel modules (mint_tpu_torch/ops) against the JAX kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
version is held to the JAX Pallas kernel it ports, run as the JAX tests run
it (interpret mode on the CPU).  The CUDA kernels themselves are compared
with the plain versions on the card by chip_smoke.py (the card's machine
has no JAX, which these tests and tests/conftest.py import).

Tolerances: f32 to 2e-6 (the JAX attention tests' class: summation order
only); bf16 to 2 bf16 ulps at the output's magnitude (both sides round P,
the MLP activation and the output to bf16, so one rounding may flip).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.ops import attention as jax_attention
from mint_tpu.ops import mlp as jax_mlp
from mint_tpu_torch.ops import attention as att
from mint_tpu_torch.ops import layer_norm as ln_op
from mint_tpu_torch.ops import mlp

RNG = np.random.default_rng(41)
BF16_TOL = 2 * 2.0 ** -7  # 2 bf16 ulps, relative to the output's peak


def _qkv(b, h, nq, nk, d):
    return (RNG.standard_normal((b, h, nq, d)).astype(np.float32),
            RNG.standard_normal((b, h, nk, d)).astype(np.float32),
            RNG.standard_normal((b, h, nk, d)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = BF16_TOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,scale", [((2, 10, 360, 80), 800 ** -0.5),
                                         ((1, 2, 37, 16), 0.1)])
def test_attention_reference_matches_pallas_f32(shape, scale):
    b, h, n, d = shape
    q, k, v = _qkv(b, h, n, n, d)
    want = np.asarray(jax_attention.pallas_attention(*_jax(q, k, v), scale))
    got = att.attention(*_torch(q, k, v), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_attention_reference_matches_pallas_bf16():
    q, k, v = _qkv(1, 10, 120, 120, 80)
    want = jax_attention.pallas_attention(
        *_jax(q, k, v, dtype=jnp.bfloat16), 800 ** -0.5)
    got = att.attention(*_torch(q, k, v, dtype=torch.bfloat16), 800 ** -0.5)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_attention_rows_sum_to_one():
    q, k, _ = _qkv(1, 1, 8, 8, 8)
    ones = np.ones_like(k)
    want = np.asarray(jax_attention.pallas_attention(
        *_jax(q, k, ones), 0.3, head_block=1))
    got = att.attention(*_torch(q, k, ones), 0.3).numpy()
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_attention_fewer_queries_than_keys():
    """The decode's final block: 48 queries against 360 keys."""
    q, k, v = _qkv(2, 10, 48, 360, 80)
    full_q = np.concatenate([q, RNG.standard_normal(
        (2, 10, 312, 80)).astype(np.float32)], axis=2)
    want = np.asarray(jax_attention.xla_attention(
        *_jax(full_q, k, v), 800 ** -0.5))[:, :, :48]
    got = att.attention(*_torch(q, k, v), 800 ** -0.5)
    assert got.shape == (2, 10, 48, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # Slicing the queries of a full call gives the same rows.
    full = att.attention(*_torch(full_q, k, v), 800 ** -0.5)
    np.testing.assert_allclose(full[:, :, :48].numpy(), got.numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [360, 48])
def test_kernel_takes_fused_qkv_views_without_copies(nq, dtype):
    """The model passes q, k, v as strided views of its fused QKV output,
    a [B, N, 3, H, D] buffer (models/layers.py).  The CUDA path hands the
    kernel those views themselves, so their strides, and an output that is
    a [B, H, Nq, D] view of [B, Nq, H, D] storage (the head merge's
    layout).  The kernel's reads of them are held to the plain version on
    the card by chip_smoke.py."""
    buf = torch.zeros(2, 360, 3, 10, 80, dtype=dtype)
    q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
    q = q[:, :, :nq]
    assert not q.is_contiguous() and not k.is_contiguous()
    *given, out = att._operands(q, k, v)
    assert all(g is t for g, t in zip(given, (q, k, v)))
    assert out.shape == (2, 10, nq, 80) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("d,max_keys", [(80, 1216), (128, 704), (16, 4096)])
def test_bf16_kernel_key_limit(d, max_keys):
    """Where the bf16 kernel's schedule changes: up to max_keys keys it
    holds a head's whole K in shared memory (csrc/attention.cu,
    tc_smem_bytes), past it K streams through a ring of tiles with V.  The
    wrapper hands the kernel both as they are; heads of a width that is no
    multiple of 16 take the next multiple's schedule, and heads over 128
    always stream.  The f32 kernel streams K at any Nk."""
    assert att.bf16_max_keys(d) == max_keys
    assert att.bf16_max_keys(d - 1 if d > 16 else 9) == max_keys
    assert att.bf16_max_keys(130) == 0
    q = torch.zeros(1, 2, 48, d, dtype=torch.bfloat16)
    for nk in (360, max_keys, max_keys + 1):
        k = torch.zeros(1, 2, nk, d, dtype=torch.bfloat16)
        *given, out = att._operands(q, k, k)
        assert given[1] is k and out.shape == q.shape
    q32, k32 = q.float(), torch.zeros(1, 2, 4 * max_keys, d)
    assert att._operands(q32, k32, k32)[-1].shape == q.shape


def _tile_ld(d):
    """csrc/attention.cu's tile_ld: a row of d floats rounded up to a
    float4, padded so that (stride / 4) is odd."""
    d4 = -(-d // 4)
    return 4 * (d4 + 2 if d4 % 2 else d4 + 1)


def _fits(dtype, d):
    """Whether a head dim d fits the kernel's shared memory (232448 bytes
    a block) with Q's rows resident over the whole head, as
    csrc/attention*.cu reckon it at its smallest block: f32
    (wide_smem_bytes at one warp) 16 rows of Q and 32 of K over the head
    dim, 32 of V over an output chunk, and one warp's P; bf16
    (tc_stream_smem_bytes at one warpgroup) 2 KB of mbarriers and slack,
    64 rows of Q over every chunk and a ring of two 64-key tiles of one."""
    chunks = -(-d // 256)
    if dtype == torch.float32:
        dc = -(-(-(-d // chunks)) // 4) * 4
        need = 4 * (48 * _tile_ld(d) + 32 * _tile_ld(dc) + 16 * 38)
    else:
        width = -(-(-(-d // chunks)) // 16) * 16
        need = 2048 + (chunks + 2) * 64 * 2 * width
    return need <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_limit(dtype):
    """No head is refused for shared memory, as the Pallas kernel refuses
    none.  attention.RESIDENT_Q_MAX_HEAD_DIM marks where each kernel's
    schedule changes: every head dim up to it keeps Q in shared memory
    over the whole head (it fits at every such width: f32 one output
    chunk, bf16 two), and the next takes the scores-once kernels
    (attention.scores_once), which hold no head whole.  The wrapper and
    the build's check take heads past it (1032 in f32, 1360 in bf16) and
    any width up to attention.HEAD_DIM_CEILING (at least every width the
    kernels took with output chunks of 256 columns on the grid's z
    axis), refusing only a wider one, naming the ceiling."""
    from mint_tpu_torch.models import builder

    changes = att.RESIDENT_Q_MAX_HEAD_DIM[dtype]
    assert all(_fits(dtype, d) for d in range(129, changes + 1))
    assert not att.scores_once(dtype, changes)
    assert att.scores_once(dtype, changes + 1)
    ceiling = att.HEAD_DIM_CEILING
    assert ceiling >= 65535 * 256 - 7
    past = {torch.float32: 1032, torch.bfloat16: 1360}[dtype]
    for d in (changes + 1, past, 8192):
        q = torch.zeros(1, 1, 2, d, dtype=dtype)
        assert att._operands(q, q, q)[-1].shape == q.shape
        builder.check_kernel_limits(
            _fact_config(hidden=2 * d, heads=2).fact_model, dtype)
    q = torch.empty(1, 1, 2, ceiling, dtype=dtype, device="meta")
    assert att._operands(q, q, q)[-1].shape == q.shape
    q = torch.empty(1, 1, 2, ceiling + 1, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=f"head dim {ceiling + 1} over"):
        att._operands(q, q, q)
    builder.check_kernel_limits(
        _fact_config(hidden=2 * ceiling, heads=2).fact_model, dtype)
    with pytest.raises(ValueError, match=f"over the {ceiling}"):
        builder.check_kernel_limits(
            _fact_config(hidden=2 * ceiling + 2, heads=2).fact_model, dtype)


def _pallas_rows(q, k, v, scale, dtype):
    """The Pallas kernel (interpret mode on the CPU) on q's rows against
    more keys: it takes Nq = Nk, so q's rows come first among random ones,
    each row's output its own; as f32 numpy."""
    extra = RNG.standard_normal(
        q.shape[:2] + (k.shape[2] - q.shape[2], q.shape[3])).astype(np.float32)
    full_q = np.concatenate([q.float().numpy(), extra], axis=2)
    out = jax_attention.pallas_attention(
        *(jnp.asarray(t, dtype) for t in (full_q, k.float().numpy(),
                                          v.float().numpy())), scale)
    return np.asarray(out.astype(jnp.float32))[:, :, :q.shape[2]]


def _groups(pairs, qtiles, fit, most_qt):
    """csrc/attention.cuh's over_groups: the launch groups (bh0, np, qt0,
    nqt) of the scores-once kernels, at most `fit` units each."""
    bh0 = 0
    while bh0 < pairs:
        if fit >= qtiles and qtiles <= most_qt:
            np_ = min(fit // qtiles, 65535, pairs - bh0)
            yield bh0, np_, 0, qtiles
            bh0 += np_
            continue
        nqt = min(fit, most_qt)
        for qt0 in range(0, qtiles, nqt):
            yield bh0, 1, qt0, min(nqt, qtiles - qt0)
        bh0 += 1


class _Scored:
    """Counts each (pair, query, key) score a schedule computes."""

    def __init__(self, pairs, nq, nk):
        self.times = torch.zeros(pairs, nq, nk, dtype=torch.int32)

    def add(self, bh, rows, keys):
        self.times[bh, rows.start:min(rows.stop, self.times.shape[1]),
                   keys.start:min(keys.stop, self.times.shape[2])] += 1

    def once(self):
        assert bool((self.times == 1).all()), "a score computed != once"


def _scores_once_f32_attention(q, k, v, scale, ws_bytes=None):
    """csrc/attention_f32.cu's scores-once kernels in f32 PyTorch, over
    launch groups of the workspace's units (64 query rows of a pair;
    ops.attention.workspace_bytes, or `ws_bytes`).  Kernel 1: each (unit,
    64-key tile) block sums its scores over the head dim in stages of 32
    columns and writes them scaled to the unit's rows (keys below Nk);
    kernel 2: a warp a row below Nq, P = exp(s - max) / sum in place,
    zeros to the row's end (Nk rounded up to 32); kernel 3: each (unit,
    64-column chunk) block sums P v over the keys in stages of 32 (V's
    keys past Nk zeros).  Counts every score a block computes: each
    (query, key) pair once a call."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    q, k, v = (t.reshape(b * h, -1, d) for t in (q, k, v))
    unit = att._unit_bytes(torch.float32, nk)
    fit = (ws_bytes or att.workspace_bytes(torch.float32, b * h, nq, nk)
           ) // unit
    ld = -(-nk // 32) * 32
    qtiles = -(-nq // 64)
    v = torch.nn.functional.pad(v, (0, 0, 0, ld - nk))
    out = torch.empty(b * h, nq, d)
    scored = _Scored(b * h, nq, nk)
    for bh0, np_, qt0, nqt in _groups(b * h, qtiles, fit, 65535):
        ws = torch.full((np_ * nqt, 64, ld), torch.nan)
        for y in range(np_):
            for z in range(nqt):
                rows = slice(64 * (qt0 + z), 64 * (qt0 + z + 1))
                qb = q[bh0 + y, rows]
                w = ws[y * nqt + z]
                for k0 in range(0, nk, 64):  # kernel 1
                    keys = slice(k0, min(k0 + 64, nk))
                    s = torch.zeros(qb.shape[0], keys.stop - k0)
                    for c in range(0, d, 32):
                        s = s + qb[:, c:c + 32] @ k[bh0 + y, keys,
                                                    c:c + 32].T
                    scored.add(bh0 + y, rows, keys)
                    w[:qb.shape[0], keys] = s * scale
                sw = w[:qb.shape[0], :nk]  # kernel 2
                e = torch.exp(sw - sw.amax(-1, keepdim=True))
                w[:qb.shape[0]] = torch.nn.functional.pad(
                    e / e.sum(-1, keepdim=True), (0, ld - nk))
                for c0 in range(0, d, 64):  # kernel 3
                    acc = torch.zeros(qb.shape[0], min(64, d - c0))
                    for k0 in range(0, ld, 32):
                        acc = acc + w[:qb.shape[0], k0:k0 + 32] @ v[
                            bh0 + y, k0:k0 + 32, c0:c0 + 64]
                    out[bh0 + y, rows, c0:c0 + 64] = acc
    scored.once()
    return out.reshape(b, h, nq, d)


def _scores_once_bf16_attention(q, k, v, scale, ws_bytes=None):
    """csrc/attention_once.cu's scores-once kernels in f32 PyTorch on
    bf16-valued inputs, over launch groups of the workspace's units (64
    query rows of a pair).  Kernel 1: a block of two units' query tiles
    and one 64-key tile sums each tile's scores over the head in 64-column
    chunks (zeros past D, as TMA fills them; keys past Nk zeros) into the
    workspace, f32, unscaled; kernel 2: a unit's rows' running max and
    sum of exp2 of the scaled scores over its key tiles (keys past Nk
    masked), then P = exp2(s - max) / sum rounded to bf16 (zeros past Nk);
    kernel 3: a block of two units and one output chunk of W columns (the
    head in chunks of at most 128, W a multiple of 16) adds P.V a key tile
    at a time in f32; the output is rounded to bf16.  Counts every score:
    each (query, key) pair once a call."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    q, k, v = (t.float().reshape(b * h, -1, d) for t in (q, k, v))
    kchunks = -(-d // 64)
    chunks = -(-d // 128)
    width = -(-(-(-d // chunks)) // 16) * 16
    ktiles, qtiles = -(-nk // 64), -(-nq // 64)
    pad = torch.nn.functional.pad
    q = pad(q, (0, kchunks * 64 - d, 0, qtiles * 64 - nq))
    k = pad(k, (0, kchunks * 64 - d, 0, ktiles * 64 - nk))
    v = pad(v, (0, chunks * width - d, 0, ktiles * 64 - nk))
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    unit = att._unit_bytes(torch.bfloat16, nk)
    fit = (ws_bytes or att.workspace_bytes(torch.bfloat16, b * h, nq, nk)
           ) // unit
    out = torch.empty(b * h, qtiles * 64, chunks * width)
    scored = _Scored(b * h, nq, nk)
    for bh0, np_, qt0, nqt in _groups(b * h, qtiles, fit, 2 * 65535):
        scores = torch.full((np_ * nqt, ktiles, 64, 64), torch.nan)
        probs = torch.full((np_ * nqt, ktiles, 64, 64), torch.nan,
                           dtype=torch.bfloat16)
        blocks = [(y, z, min(2, nqt - z)) for y in range(np_)
                  for z in range(0, nqt, 2)]
        for y, z, live in blocks:  # kernel 1
            for t in range(ktiles):
                for w in range(live):
                    rows = slice(64 * (qt0 + z + w), 64 * (qt0 + z + w + 1))
                    s = torch.zeros(64, 64)
                    for c in range(kchunks):
                        cols = slice(64 * c, 64 * (c + 1))
                        s = s + q[bh0 + y, rows, cols] @ k[
                            bh0 + y, 64 * t:64 * (t + 1), cols].T
                    scored.add(bh0 + y, rows, slice(64 * t, 64 * (t + 1)))
                    scores[y * nqt + z + w, t] = s
        for u in range(np_ * nqt):  # kernel 2
            valid = torch.arange(ktiles * 64).reshape(ktiles, 1, 64) < nk
            x = torch.where(valid, scores[u] * scale_log2, -torch.inf)
            m = torch.full((64, 1), -torch.inf)
            l = torch.zeros(64, 1)
            for t in range(ktiles):
                m_new = torch.maximum(m, x[t].amax(-1, keepdim=True))
                l = l * torch.exp2(m - m_new) + torch.exp2(
                    x[t] - m_new).sum(-1, keepdim=True)
                m = m_new
            probs[u] = (torch.exp2(x - m) * (1 / l)).bfloat16()
        for y, z, live in blocks:  # kernel 3
            for c in range(chunks):
                cols = slice(width * c, width * (c + 1))
                for w in range(live):
                    acc = torch.zeros(64, width)
                    for t in range(ktiles):
                        acc = acc + probs[y * nqt + z + w, t].float() @ v[
                            bh0 + y, 64 * t:64 * (t + 1), cols]
                    rows = slice(64 * (qt0 + z + w), 64 * (qt0 + z + w + 1))
                    out[bh0 + y, rows, cols] = acc
    scored.once()
    return out[:, :nq, :d].reshape(b, h, nq, d).bfloat16()


@pytest.mark.parametrize("d,nq,nk,groups", [
    (264, 16, 37, 1),    # the first widths past one output chunk
    (1032, 40, 67, 2),   # past the old resident-Q width, a unit a group
])
def test_scores_once_f32_attention_matches_pallas(d, nq, nk, groups):
    """f32 heads past one output chunk: each score computed once a call
    (every query against every key, counted), normalised in the
    workspace, P.V over 64-column chunks reading P, against the Pallas
    kernel in f32 on q[1, 2, nq, d] against a ragged key count, within
    1e-5 (summation order only: exact f32 on both sides).  `groups`
    launch groups: 2 hands the schedule one unit of workspace, so each
    pair runs in a group of its own."""
    assert att.scores_once(torch.float32, d)
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(
        np.float32)) for n in (nq, nk, nk))
    unit = att._unit_bytes(torch.float32, nk)
    got = _scores_once_f32_attention(q, k, v, 800 ** -0.5,
                                     unit if groups > 1 else None)
    want = _pallas_rows(q, k, v, 800 ** -0.5, jnp.float32)
    assert got.shape == want.shape == (1, 2, nq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,nq,nk,groups", [
    (264, 16, 37, 1),    # three output chunks of 96 (the streamed kernel
                         # takes such heads: its two chunks ran faster)
    (1360, 40, 67, 2),   # eleven of 128, past the old resident-Q frame
])
def test_scores_once_bf16_attention_matches_pallas(d, nq, nk, groups):
    """bf16 heads past one output chunk: each score computed once a call
    (counted), over 64-column chunks of the head with TMA's zeros past
    it, P exactly normalised and rounded to bf16 in the workspace, P.V
    over output chunks of at most 128 columns; q[1, 2, nq, d] against a
    ragged key count, within 2 bf16 ulps of the Pallas kernel's peak.
    `groups` as in the f32 test."""
    assert att.scores_once(torch.bfloat16, d) == (
        d > att.RESIDENT_Q_MAX_HEAD_DIM[torch.bfloat16])
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(
        np.float32)).bfloat16() for n in (nq, nk, nk))
    unit = att._unit_bytes(torch.bfloat16, nk)
    got = _scores_once_bf16_attention(q, k, v, 800 ** -0.5,
                                      unit if groups > 1 else None)
    want = _pallas_rows(q, k, v, 800 ** -0.5, jnp.bfloat16)
    assert got.shape == want.shape == (1, 2, nq, d)
    _close_bf16(got.float().numpy(), want)


def _views(dtype, layout, heads, d, b=2, n=30):
    """q, k and v [b, heads, n, d] on the CPU: the model's fused QKV views
    ("fused": [b, n, 3, heads, d] storage) or contiguous tensors."""
    if layout == "fused":
        buf = torch.zeros(b, n, 3, heads, d, dtype=dtype)
        return buf.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.zeros(b, heads, n, d, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,layout,heads,d,kernel", [
    (torch.float32, "fused", 10, 80, "attention_kernel"),  # the flagship's
    (torch.float32, "fused", 8, 130, "attention_wide_kernel"),
    (torch.float32, "contiguous", 4, 256, "attention_wide_kernel"),
    (torch.float32, "fused", 4, 257, "once"),
    (torch.float32, "fused", 4, 264, "once"),
    (torch.float32, "contiguous", 4, 2048, "once"),
    (torch.bfloat16, "fused", 10, 80, "attention_tc_kernel"),  # flagship
    (torch.bfloat16, "fused", 8, 130, "attention_tc_stream_kernel"),
    (torch.bfloat16, "contiguous", 4, 256, "attention_tc_stream_kernel"),
    (torch.bfloat16, "fused", 4, 264, "attention_tc_stream_kernel"),
    # 346 columns lying up to 6 into their tiles (a frame of 352), and
    # 350 (a frame of 356): the frame, not the head dim, decides.
    (torch.bfloat16, "fused", 4, 346, "attention_tc_stream_kernel"),
    (torch.bfloat16, "fused", 4, 350, "once"),
    (torch.bfloat16, "fused", 4, 520, "once"),
    (torch.bfloat16, "fused", 4, 1360, "once"),
])
def test_scores_once_routing(dtype, layout, heads, d, kernel):
    """The Python mirror of the C entries' choice (ops.attention's
    scores_once and device_kernels): the flagship's D = 80 keeps its
    kernels (f32 attention_kernel, bf16 the resident attention_tc_kernel),
    heads up to RESIDENT_Q_MAX_HEAD_DIM (f32 256 columns, one output
    chunk; bf16 a frame in the tiles of 352, two chunks of 176) keep the
    resident-Q ones, and wider ones take the scores-once kernels, three
    launches, with a workspace."""
    q, k, v = _views(dtype, layout, heads, d)
    got = att.device_kernels(q, k, v)
    once = kernel == "once"
    assert got == (att.ONCE_KERNELS[dtype] if once else (kernel,))
    frame = att._frame(*att._operands(q, k, v)[:3])
    assert att.scores_once(dtype, frame) == once
    assert (frame > att.RESIDENT_Q_MAX_HEAD_DIM[dtype]) == once


@pytest.mark.parametrize("dtype,pairs,nq,nk,units", [
    (torch.float32, 8, 360, 360, 48),       # q[2,4,360,2048]: 4.5 MB
    (torch.bfloat16, 8, 360, 360, 48),      # 6.75 MB
    (torch.bfloat16, 80, 360, 360, 480),    # q[20,4,360,520]: 69 MB
    (torch.float32, 65540, 48, 120, 8192),  # B * H past one grid's y axis
    (torch.bfloat16, 65540, 48, 120, 5461),
    (torch.float32, 1, 64, 2000000, 1),     # one unit past the group cap
])
def test_workspace_bytes(dtype, pairs, nq, nk, units):
    """The scores-once kernels' workspace (ops.attention.workspace_bytes,
    csrc's once_f32_unit_bytes and once_unit_bytes): a unit (64 query rows
    of a pair) takes f32 64 rows of Nk rounded up to 32 floats, bf16 24 KB
    a 64-key tile; a call gets every unit's where they fit
    WORKSPACE_GROUP_BYTES, else as many as fit (at least one), and the
    launch groups (csrc/attention.cuh's over_groups) then cover every
    unit of every pair once, at most 65535 pairs a group."""
    unit = (4 * 64 * -(-nk // 32) * 32 if dtype == torch.float32
            else -(-nk // 64) * 24576)
    assert att._unit_bytes(dtype, nk) == unit
    got = att.workspace_bytes(dtype, pairs, nq, nk)
    assert got == units * unit
    assert got <= max(att.WORKSPACE_GROUP_BYTES, unit)
    qtiles = -(-nq // 64)
    most = 65535 * (2 if dtype == torch.bfloat16 else 1)
    covered = torch.zeros(pairs, qtiles, dtype=torch.int32)
    for bh0, np_, qt0, nqt in _groups(pairs, qtiles, got // unit, most):
        assert np_ * nqt <= units and np_ <= 65535 and nqt <= most
        covered[bh0:bh0 + np_, qt0:qt0 + nqt] += 1
    assert bool((covered == 1).all())


def _fact_config(hidden=800, heads=10, mlp_width=3072, audio_seq=240):
    """The flagship's FACT config with one geometry field changed."""
    from mint_tpu_torch.config.schema import load_pipeline_config

    cfg = load_pipeline_config("configs/fact_v5_deeper_t10_cm12.config")
    fact = cfg.multi_modal_model.fact_model
    for tf in [m.model[0].transformer for m in fact.modality] + [
            fact.cross_modal_model.transformer]:
        tf.hidden_size, tf.num_attention_heads = hidden, heads
        tf.intermediate_size = mlp_width
    fact.modality_by_name("audio").sequence_length = audio_seq
    return cfg.multi_modal_model


# (config change, the dtype whose kernel once refused it, that refusal's
# words): each the flagship with one geometry field changed
# (tests/test_torch_wide_configs.py holds the port to the JAX package at
# each geometry).
LIMIT_CASES = {
    "head_dim_over_128": (dict(hidden=1040, heads=8), torch.float32,
                          "head dim 0 < D <= 128"),
    "bf16_head_dim_step": (dict(hidden=800, heads=16), torch.bfloat16,
                           "a head dim that is a multiple of 16"),
    "bf16_keys": (dict(audio_seq=1200), torch.bfloat16,
                  "at most 1216 keys at D=80"),
    "f32_mlp_width": (dict(mlp_width=3070), torch.float32,
                      "H and F multiples of 8"),
    "bf16_mlp_width": (dict(mlp_width=3080), torch.bfloat16,
                       "H and F multiples of 16"),
    "bf16_layer_norm": (dict(hidden=1040, heads=13), torch.bfloat16,
                        "an even C <= 1024"),
}


@pytest.mark.parametrize("case", list(LIMIT_CASES))
def test_build_checks_kernel_limits_on_cuda(case):
    """Each config the kernels once refused at build time (naming the
    limit in the third field) now passes the check in both dtypes, for
    inference and for bf16 compute training: builder.build on the card
    gets past it and only then looks for a card (which the CPU has not).
    A dtype with no kernel is still refused."""
    from mint_tpu_torch.models import builder

    change, _, _ = LIMIT_CASES[case]
    cfg = _fact_config(**change)
    for dtype in (torch.float32, torch.bfloat16):
        builder.check_kernel_limits(cfg.fact_model, dtype)
        for kw in (dict(is_training=False, dtype=dtype),
                   dict(is_training=True, compute_dtype=dtype)):
            if torch.cuda.is_available():
                assert builder.build(cfg, device="cuda", **kw)
            else:
                with pytest.raises(RuntimeError, match="no CUDA card"):
                    builder.build(cfg, device="cuda", **kw)
    with pytest.raises(ValueError, match="no attention kernel takes "
                       "torch.float16"):
        builder.check_kernel_limits(cfg.fact_model, torch.float16)


def test_flagship_passes_every_kernel_limit():
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder

    cfg = load_pipeline_config("configs/fact_v5_deeper_t10_cm12.config")
    for dtype in (torch.float32, torch.bfloat16):
        builder.check_kernel_limits(cfg.multi_modal_model.fact_model, dtype)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            builder.build(cfg.multi_modal_model, is_training=False,
                          device="cuda")


def test_batch_limit_is_checked_before_any_step():
    """Both attention kernels launch as many grids as the (batch, head)
    pairs need, 65535 a launch (csrc/attention.cu), so no batch is refused
    any more: B*H = 65536 reaches the kernel in both dtypes, and nothing
    checks the batch before a step (builder.check_batch, which refused
    B*H > 65535 there, is gone)."""
    from mint_tpu_torch.models import builder

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(16384, 4, 2, 16, dtype=dtype)
        *given, out = att._operands(q, q, q)
        assert all(t is q for t in given) and out.shape == q.shape
        assert att.limit_broken(dtype) is None
    assert not hasattr(builder, "check_batch")


def test_model_layout_needs_no_copy_for_tma():
    """The bf16 kernel's TMA loads read the model's fused QKV views as they
    are (16-byte steps); a layout they cannot address would be copied."""
    buf = torch.zeros(20, 360, 3, 10, 80, dtype=torch.bfloat16)
    q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
    assert all(att._tma_ready(t) for t in (q[:, :, :48], k, v))
    assert att._tma_ready(torch.zeros(1, 2, 37, 16, dtype=torch.bfloat16))
    odd = torch.zeros(2, 3, 5, 88, dtype=torch.bfloat16)[..., :80]
    assert odd.stride(2) == 88 and att._tma_ready(odd)
    assert not att._tma_ready(torch.zeros(2, 3, 5, 84,
                                          dtype=torch.bfloat16)[..., :80])
    assert not att._tma_ready(torch.zeros(2, 3, 80, 5,
                                          dtype=torch.bfloat16).transpose(
                                              -1, -2))


@pytest.mark.parametrize("hidden,heads,route", [
    (800, 10, "tma_view"),      # the flagship: D = 80
    (800, 16, "tma_columns"),   # D = 50: 4800-byte token rows
    (1040, 8, "tma_columns"),   # D = 130: 6240-byte token rows
    (804, 12, "tma_pairs"),     # D = 67: 4824-byte rows, 8 past a step
])
def test_bf16_route_of_the_models_views(hidden, heads, route):
    """How the bf16 kernel loads each of the model's fused QKV views
    (csrc/attention_tc.cuh's Route): TMA over the [B, H, N, D] view where
    every stride is a whole 16-byte step, else TMA over a token row's head
    columns where the row is, else TMA over every other token row where
    two rows are.  Each reaches the kernel as it is, on the resident
    schedule (up to 128 columns and bf16_max_keys keys) and the streamed
    one (D = 130)."""
    d = hidden // heads
    buf = torch.zeros(20, 360, 3, heads, d, dtype=torch.bfloat16)
    q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
    for views in ((q, k, v), (q[:, :, :48], k, v)):
        assert [att.bf16_route(t) for t in views] == [route] * 3
        *given, out = att._operands(*views)
        assert all(g is t for g, t in zip(given, views))
        assert out.shape == views[0].shape
    frame = d + att._col_shift(k, route)  # the columns of a head's tiles
    assert frame == {"tma_view": d, "tma_pairs": d + 7,
                     "tma_columns": d + 6}[route]
    assert att._resident_route(route, route) == route
    assert att.bf16_resident(frame, 360, route == "tma_pairs") == (d <= 128)


def test_bf16_streamed_kernel_copies_only_what_tma_cannot_address():
    """The resident kernel takes any view by its block's copies, the
    streamed one only TMA's over a view or its head columns: a view of rows
    TMA cannot step over (81 elements apart, over 80 columns) reaches the
    resident kernel as it is, and the streamed one (past bf16_max_keys
    keys) as a copy whose rows are zero-padded to a multiple of 8, the
    values unchanged.  Rows 84 elements apart, every other one on a
    16-byte step, reach the resident kernel by TMA over each parity's."""
    assert att.bf16_route(torch.zeros(1, 2, 9, 84).bfloat16()[..., :80]) \
        == "tma_pairs"
    rows = torch.randn(1, 2, 1300, 81).bfloat16()
    view = rows[..., :80]
    assert att.bf16_route(view) == "copies"
    q = view[:, :, :48]
    *given, _ = att._operands(q, view[:, :, :360], view[:, :, :360])
    assert all(g is t for g, t in zip(given, (q,)))
    assert given[1].data_ptr() == view.data_ptr()
    assert not att.bf16_resident(80, 1300)
    *given, out = att._operands(q, view, view)
    for was, got in zip((q, view, view), given):
        assert att.bf16_route(got) == "tma_view" and torch.equal(got, was)
        assert torch.all(got._base[..., 80:] == 0)
    assert out.shape == q.shape


def _two_pass_bf16_attention(q, k, v, scale, tile=64):
    """The bf16 CUDA kernel's arithmetic (csrc/attention.cu), in f32 numpy
    on bf16-valued inputs: pass 1 keeps each row's running max and sum of
    exp2 over `tile`-key tiles; pass 2 forms P = exp2(s - max) / sum,
    rounds it to bf16 and accumulates P.V in f32; the output is rounded to
    bf16."""
    log2e = np.float32(1.4426950408889634)
    q, k, v = (np.asarray(t, np.float32) for t in (q, k, v))
    s = (q @ np.swapaxes(k, -1, -2)) * np.float32(scale) * log2e
    m = np.full(q.shape[:-1] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    for k0 in range(0, k.shape[-2], tile):
        st = s[..., k0:k0 + tile]
        m_new = np.maximum(m, st.max(axis=-1, keepdims=True))
        l = l * np.exp2(m - m_new) + np.exp2(st - m_new).sum(
            axis=-1, keepdims=True)
        m = m_new
    p = torch.from_numpy(np.exp2(s - m) * (1 / l)).bfloat16().float()
    out = p.numpy() @ v
    return torch.from_numpy(out).bfloat16().float().numpy()


@pytest.mark.parametrize("nq", [360, 48])
def test_two_pass_bf16_attention_matches_jax(nq):
    """The bf16 kernel's two passes against the Pallas kernel (Nq = Nk) or
    the sliced XLA attention (Nq = 48 < Nk), both in bf16, at FACT's
    widths; 2 bf16 ulps of the output's peak."""
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in _qkv(2, 10, nq, 360, 80))
    if nq == 360:
        want = jax_attention.pallas_attention(
            *_jax(q, k, v, dtype=jnp.bfloat16), 800 ** -0.5)
    else:
        full_q = np.concatenate([q, RNG.standard_normal(
            (2, 10, 360 - nq, 80)).astype(np.float32)], axis=2)
        want = jax_attention.xla_attention(
            *_jax(full_q, k, v, dtype=jnp.bfloat16), 800 ** -0.5)[:, :, :nq]
    got = _two_pass_bf16_attention(q, k, v, 800 ** -0.5)
    assert got.shape == want.shape
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def _heads_in_place(d, width, zeroed, offset=0, b=1, h=4, n=360):
    """q, k and v [b, h, n, d] (bf16-valued f32), and the same in tiles
    `width` columns wide as the kernels hold a head read in place: the head
    from column `offset`, the columns around it zeros in the operands named
    in `zeroed` ("q", "k"), as the kernels write them, and other heads'
    values (random here) in the rest and in V."""
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in _qkv(b, h, n, n, d))

    def pad(t, zeros):
        fill = np.zeros if zeros else RNG.standard_normal
        return np.concatenate(
            [fill(t.shape[:-1] + (offset,)).astype(np.float32), t,
             fill(t.shape[:-1] + (width - d - offset,)).astype(np.float32)],
            axis=-1)

    return (q, k, v), (pad(q, "q" in zeroed), pad(k, "k" in zeroed),
                       pad(v, False))


@pytest.mark.parametrize("d,offset,zeroed", [
    (50, 6, "q"), (67, 5, "q"), (67, 0, "qk"),  # the kernels' routes
    (50, 6, "qk"),                              # and zeros on both sides
])
def test_two_pass_bf16_attention_at_padded_widths_matches_jax(d, offset,
                                                              zeroed):
    """The bf16 kernels' two passes over a head read where it lies, in
    tiles of its frame's width rounded up to 16: D = 50 over 16 heads by
    TMA over the token rows' head columns (a box from the 16-byte step at
    or before the head: up to 6 columns early, 64 wide), D = 67 over 12 by
    TMA over each parity's token rows (up to 7 columns early, 80 wide); Q's
    columns around the head zero, K's and V's other heads' values.  By the
    block's copies the head starts at column 0, zeros past d in K (V's
    there reach only output columns never stored).  The output's columns
    of the head are the Pallas kernel's on the d-wide head, within 2 bf16
    ulps of its peak."""
    width = -(-(d + offset) // 16) * 16
    (q, k, v), padded = _heads_in_place(d, width, zeroed, offset)
    want = jax_attention.pallas_attention(
        *_jax(q, k, v, dtype=jnp.bfloat16), 800 ** -0.5)
    got = _two_pass_bf16_attention(*padded, 800 ** -0.5)[
        ..., offset:offset + d]
    assert got.shape == want.shape
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def _shift4_lanes(x, delta):
    """csrc/attention_pairs.cu's shift4 on fragment rows x [..., W] (W a
    multiple of 8): lane t (0-3) of a row holds columns 8 n + 2 t and the
    next of each group n; for delta 4 (column c takes c - 4's) it sends its
    group n where t < 2, else its group n - 1 (zeros before the first),
    groups from the last down; for -4 (c takes c + 4's) its group n + 1
    where t < 2 (zeros past the last), else its group n, from the first up;
    each lane takes lane t ^ 2's."""
    groups = x.shape[-1] // 8
    lanes = [[x[..., 8 * n + 2 * t:8 * n + 2 * t + 2].copy()
              for n in range(groups)] for t in range(4)]
    zero = np.zeros_like(lanes[0][0])
    for n in (range(groups - 1, -1, -1) if delta > 0 else range(groups)):
        if delta > 0:
            send = [lanes[t][n] if t < 2 else
                    (lanes[t][n - 1] if n > 0 else zero) for t in range(4)]
        else:
            send = [(lanes[t][n + 1] if n + 1 < groups else zero) if t < 2
                    else lanes[t][n] for t in range(4)]
        for t in range(4):
            lanes[t][n] = send[t ^ 2]
    out = np.empty_like(x)
    for t in range(4):
        for n in range(groups):
            out[..., 8 * n + 2 * t:8 * n + 2 * t + 2] = lanes[t][n]
    return out


def _pairs_tiles(flat, base, st_n, st_h, heads, n, d, h, par, width):
    """The 64-key tiles of head h of one parity's token rows (par) as
    csrc/attention_tc.cuh's tc_pair_maps has TMA load them from a view of
    `flat` (its [n, heads, d] rows st_n elements apart from element
    `base`, heads st_h apart; `flat`'s start on a 16-byte step): the map
    over every other row from row par, based 4 columns early where the
    row starts 8 bytes past a step, columns past the last head's zeros;
    the head's boxes `width` wide from the step at or before its first
    column.  Returns (tiles, the head's column in them)."""
    row0 = base + par * st_n
    lag = 4 if row0 % 8 else 0
    cols = lag + (heads - 1) * st_h + d
    first = lag + h * st_h
    c0 = first // 8 * 8
    rows = list(range(par, n, 2))
    tiles = []
    for t0 in range(0, len(rows), 64):
        tile = np.zeros((64, width), np.float32)
        for i, r in enumerate(rows[t0:t0 + 64]):
            for c in range(width):
                if c0 + c < cols:
                    tile[i, c] = flat[row0 - par * st_n + r * st_n - lag
                                      + c0 + c]
        tiles.append(tile)
    return tiles, first - c0


def _pairs_bf16_attention(buf, nq, scale):
    """The bf16 kernel over tma_pairs views (csrc/attention_pairs.cu) in
    f32 numpy on the model's fused QKV buffer [n, 3, heads, d] (bf16
    values): per head, K's and V's tiles of the even token rows then the
    odd ones (_pairs_tiles, frames of the head dim + 7 rounded up to 16);
    Q's fragments at the even K tiles' frame, zeros outside the head,
    moved to the odd tiles' frame by shift4 (_shift4_lanes) between the
    runs and back after pass 1; pass 1 the running max and sum of exp2
    over each tile's real keys, pass 2 P = exp2(s - max) / sum rounded to
    bf16 and P.V accumulated in the even V tiles' frame, the accumulator
    moved to the odd tiles' frame by shift4 between the runs and the odd
    rows' products added; the output the head's columns of that frame,
    rounded to bf16.  Returns [heads, nq, d]."""
    n, _, heads, d = buf.shape
    flat = buf.reshape(-1)
    st_n, width = 3 * heads * d, -(-(d + 7) // 16) * 16
    log2e = np.float32(1.4426950408889634)
    ne = (n + 1) // 2
    valid = ([min(64, ne - 64 * t) for t in range(-(-ne // 64))]
             + [min(64, n - ne - 64 * t) for t in range(-(-(n - ne) // 64))])
    out = np.zeros((heads, nq, d), np.float32)
    for h in range(heads):
        # (tiles, the head's column) of K's and V's even and odd rows
        (ke, ko), (ve, vo) = (
            [_pairs_tiles(flat, part * heads * d, st_n, d, heads, n, d, h,
                          par, width) for par in (0, 1)] for part in (1, 2))
        kt, vt = ke[0] + ko[0], ve[0] + vo[0]
        te, dk, dv = len(ke[0]), ko[1] - ke[1], vo[1] - ve[1]
        assert abs(dk) == abs(dv) == 4
        q0 = np.zeros((nq, width), np.float32)
        q0[:, ke[1]:ke[1] + d] = buf[:nq, 0, h]
        qs = [q0 if t < te else _shift4_lanes(q0, dk)
              for t in range(len(kt))]
        m = np.full((nq, 1), -np.inf, np.float32)
        l = np.zeros_like(m)
        s = []
        for t, tile in enumerate(kt):
            st = (qs[t] @ tile.T) * np.float32(scale) * log2e
            st[:, valid[t]:] = -np.inf
            m_new = np.maximum(m, st.max(axis=-1, keepdims=True))
            l = l * np.exp2(m - m_new) + np.exp2(st - m_new).sum(
                axis=-1, keepdims=True)
            m = m_new
            s.append(st)
        acc = np.zeros((nq, width), np.float32)
        for t, tile in enumerate(vt):
            if t == te:
                acc = _shift4_lanes(acc, dv)
            p = torch.from_numpy(np.exp2(s[t] - m) / l).bfloat16().float()
            acc += p.numpy() @ tile
        frame = vo[1] if len(vt) > te else ve[1]
        out[h] = acc[:, frame:frame + d]
    return torch.from_numpy(out).bfloat16().float().numpy()


def test_shift4_moves_columns():
    """shift4's lanes move a fragment row 4 columns either way, zeros in."""
    x = RNG.standard_normal((3, 80)).astype(np.float32)
    right = np.concatenate([np.zeros((3, 4), np.float32), x[:, :-4]], 1)
    left = np.concatenate([x[:, 4:], np.zeros((3, 4), np.float32)], 1)
    np.testing.assert_array_equal(_shift4_lanes(x, 4), right)
    np.testing.assert_array_equal(_shift4_lanes(x, -4), left)


@pytest.mark.parametrize("n", [129, 130])
def test_pairs_bf16_attention_matches_pallas(n):
    """The bf16 kernel over views whose token rows lie 8 bytes past a
    16-byte step every other row (tma_pairs: hidden 804's fused QKV at
    D = 67; here 4 heads, 804-element rows), emulated from the buffer's
    bytes as TMA lays the tiles out (_pairs_bf16_attention), against the
    Pallas kernel in bf16 (interpret mode) on each head's q, k and v, to 2
    bf16 ulps of the output's peak; an odd key count (the odd rows' run a
    tile shorter) and an even one, the heads lying both ways of their odd
    rows' frame."""
    heads, d = 4, 67
    buf = torch.from_numpy(RNG.standard_normal((n, 3, heads, d)).astype(
        np.float32)).bfloat16().float().numpy()
    assert (3 * heads * d) % 8 == 4
    views = [np.ascontiguousarray(buf[:, i].transpose(1, 0, 2))[None]
             for i in range(3)]
    want = jax_attention.pallas_attention(
        *_jax(*views, dtype=jnp.bfloat16), 800 ** -0.5)
    got = _pairs_bf16_attention(buf, n, 800 ** -0.5)[None]
    assert got.shape == want.shape
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def _online_softmax_attention(q, k, v, scale, tile):
    """The f32 CUDA kernel's arithmetic (csrc/attention.cu), in f32 numpy:
    one pass over tiles of `tile` keys (the kernel's are 32) with a running
    row max and sum; the P.V accumulator is rescaled by
    exp(old max - new max) and divided by the sum at the end."""
    q, k, v = (np.asarray(t, np.float32) for t in (q, k, v))
    m = np.full(q.shape[:-1] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    for k0 in range(0, k.shape[-2], tile):
        s = (q @ np.swapaxes(k[..., k0:k0 + tile, :], -1, -2)
             * np.float32(scale))
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * alpha + p.sum(axis=-1, keepdims=True)
        acc = acc * alpha + p @ v[..., k0:k0 + tile, :]
        m = m_new
    return acc / l


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("b,h,nq,nk,d,scale", [
    (2, 10, 360, 360, 80, 800 ** -0.5),  # a full block
    (2, 10, 48, 360, 80, 800 ** -0.5),   # the decode's final block
    (1, 2, 37, 37, 16, 0.1),             # ragged last tile, narrow head
])
def test_online_softmax_tiles_match_jax_f32(b, h, nq, nk, d, scale, tile):
    q, k, v = _qkv(b, h, nq, nk, d)
    if nq == nk:
        want = np.asarray(jax_attention.pallas_attention(*_jax(q, k, v),
                                                         scale))
    else:  # the Pallas kernel takes Nq = Nk: slice a full XLA call
        full_q = np.concatenate([q, RNG.standard_normal(
            (b, h, nk - nq, d)).astype(np.float32)], axis=2)
        want = np.asarray(jax_attention.xla_attention(
            *_jax(full_q, k, v), scale))[:, :, :nq]
    got = _online_softmax_attention(q, k, v, scale, tile)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("d,zeroed", [(50, "qk"), (67, "qk"),  # the kernel
                                      (50, "k"), (67, "q")])
def test_online_softmax_at_padded_widths_matches_jax_f32(d, zeroed):
    """The f32 kernel's general instances: every loop at the width W = d
    rounded up to 8 (56, 72), Q's and K's columns past d zero in shared
    memory (one of them is enough for finite values), V's there another
    head's, 32-key tiles; the output cut to d is the Pallas kernel's on the
    d-wide head, to 2e-6."""
    (q, k, v), padded = _heads_in_place(d, -(-d // 8) * 8, zeroed)
    want = np.asarray(jax_attention.pallas_attention(*_jax(q, k, v),
                                                     800 ** -0.5))
    got = _online_softmax_attention(*padded, 800 ** -0.5, 32)[..., :d]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


def _gemm_sequential(a, bt, bias, split=1, ktile=32):
    """c[m, n] = sum_k a[m, k] bt[n, k] + bias[n] in f32 as the MLP's GEMM
    passes sum it: K cut into `split` ranges of whole `ktile`-wide k-tiles
    (32 in the f32 kernel, 64 in the bf16 one), each range summed in order,
    the ranges' sums added in order, then the bias."""
    k = a.shape[1]
    per = -(-k // split)                 # ceil(k / split)
    kper = ktile * -(-per // ktile)      # rounded up to whole k-tiles
    total = np.zeros((a.shape[0], bt.shape[0]), np.float32)
    for k0 in range(0, split * kper, kper):
        acc = np.zeros_like(total)
        for kk in range(k0, min(k, k0 + kper)):
            acc += a[:, kk, None] * bt[None, :, kk]
        total = acc if k0 == 0 else total + acc
    return total + bias


def _mlp_params(h=64, f=256, o=64):
    return (RNG.standard_normal((h, f)).astype(np.float32) * 0.05,
            RNG.standard_normal(f).astype(np.float32) * 0.01,
            RNG.standard_normal((f, o)).astype(np.float32) * 0.05,
            RNG.standard_normal(o).astype(np.float32) * 0.01)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)


@pytest.mark.parametrize("shape", [(4, 36, 64), (256, 64), (3, 64),
                                   (257, 64)])
def test_mlp_reference_matches_pallas_f32(shape, _interpret):
    params = _mlp_params()
    x = RNG.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_mlp.fused_mlp(*_jax(x, *params)))
    got = mlp.fused_mlp(*_torch(x, *params))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("shape", [(4, 36, 64), (256, 64), (3, 64),
                                   (257, 64)])
def test_two_pass_mlp_matches_pallas_f32(shape, split):
    """The f32 CUDA path (csrc/mlp.cu): fc1 + b1 + GELU into an f32
    scratch, then fc2 + b2, against the fused Pallas kernel; with split > 1
    each pass sums K in parts reduced in a fixed order, as at small M."""
    w1, b1, w2, b2 = _mlp_params()
    x = RNG.standard_normal(shape).astype(np.float32)
    x2d = x.reshape(-1, x.shape[-1])
    want = np.asarray(jax_mlp._fused_mlp_fwd_2d(*_jax(x2d, w1, b1, w2, b2),
                                                interpret=True))
    scratch = torch.nn.functional.gelu(
        torch.from_numpy(_gemm_sequential(x2d, w1.T, b1, split)),
        approximate="tanh").numpy()
    got = _gemm_sequential(scratch, w2.T, b2, split)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("h,f,o", [(256, 512, 64), (36, 100, 33),
                                   (100, 70, 17)])
@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("m", [40, 257])
def test_two_pass_bf16_mlp_matches_pallas(m, split, h, f, o):
    """The bf16 CUDA path (csrc/mlp.cu): fc1 + b1 + GELU in f32 rounded to
    a bf16 scratch (the TPU kernel's own rounding point), then fc2 + b2 in
    f32 rounded to bf16; with split > 1 each pass sums 64-wide k-tiles in
    parts added in a fixed order, as at small M.  Against the fused Pallas
    kernel in bf16 (interpret mode), to 2 bf16 ulps of the output's peak;
    also at widths off the 16-byte step, whose K ends inside a k-tile (the
    kernel's loads zero-fill past K) and whose odd O is stored a column at
    a time."""
    params = _mlp_params(h=h, f=f, o=o)
    x = RNG.standard_normal((m, h)).astype(np.float32)
    x, w1, b1, w2, b2 = (torch.from_numpy(a).bfloat16().float().numpy()
                         for a in (x, *params))
    want = jax_mlp._fused_mlp_fwd_2d(*_jax(x, w1, b1, w2, b2,
                                           dtype=jnp.bfloat16),
                                     interpret=True)
    act = torch.nn.functional.gelu(
        torch.from_numpy(_gemm_sequential(x, w1.T, b1, split, ktile=64)),
        approximate="tanh").bfloat16().float().numpy()
    got = torch.from_numpy(_gemm_sequential(act, w2.T, b2, split, ktile=64)
                           ).bfloat16().float().numpy()
    assert got.shape == want.shape
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def _pairs_tile(flat, ld, rows, k, first, shift, t):
    """The 64-column tile t of every other row (from row `first`) of a
    row-major [rows, k] matrix whose rows lie `ld` apart in `flat`, as
    csrc/mlp.cu's pairs_map has TMA load it: based `shift` elements before
    each row (what lies there, the row before's tail), columns past
    k + shift zero."""
    out = np.zeros((len(range(first, rows, 2)), 64), flat.dtype)
    for i, r in enumerate(range(first, rows, 2)):
        for c in range(64):
            col = 64 * t + c
            if col < k + shift:
                out[i, c] = flat[r * ld - shift + col]
    return out


def _frag_shift(prev, carry, up):
    """csrc/mlp_routes.cu's shift_frags on a tile's fragment rows [rows,
    64] as ldmatrix read them: moved 4 columns up (column c takes c - 4's,
    `carry` the tile before's last 8-column group shifted in) or down (c
    takes c + 4's, `carry` the next tile's first group), the lanes of
    _shift4_lanes over the row with the carry group beside it."""
    if up:
        return _shift4_lanes(np.concatenate([carry, prev], 1), 4)[:, 8:]
    return _shift4_lanes(np.concatenate([prev, carry], 1), -4)[:, :64]


@pytest.mark.parametrize("m,h", [(40, 36), (41, 100), (7, 804)])
def test_pairs_fc1_matches_pallas(m, h):
    """The bf16 MLP's fc1 on tma_pairs (csrc/mlp_routes.cu, x and W1^T
    with rows 8 bytes past a 16-byte step, hidden 804), emulated: each
    operand's even rows and its odd rows as two maps, the odd rows' tiles 4
    columns early and holding the row before's tail at k-tile 0 (zeroed in
    x's); a warpgroup a parity of x's rows.  Its `same` product (its rows x
    W1^T's rows of its parity) over the tiles as they lie; its `cross`
    product (x W1^T's other parity) one tile behind, from its tile's
    fragments as they lie moved 4 columns by shift_frags: even rows up,
    the tile before's last group shifted in, odd rows down, the next
    tile's first group (zeros past the last tile).  fc2 on the rounded
    activation, against the fused Pallas kernel in bf16 (interpret mode),
    to 2 bf16 ulps of the output's peak."""
    f, o = 70, 17
    rng = np.random.default_rng(h)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float(
        ).numpy()
    x = bf(rng.standard_normal((m, h)))
    w1t = bf(rng.standard_normal((f, h)) * 0.05)
    b1 = bf(rng.standard_normal(f) * 0.01)
    w2 = bf(rng.standard_normal((f, o)) * 0.05)
    b2 = bf(rng.standard_normal(o) * 0.01)
    tiles = -(-h // 64)
    xa = [[_pairs_tile(x.ravel(), h, m, h, p, 4 * p, t)
           for t in range(tiles)] for p in (0, 1)]
    wb = [[_pairs_tile(w1t.ravel(), h, f, h, p, 4 * p, t)
           for t in range(tiles)] for p in (0, 1)]
    out = np.zeros((m, f), np.float32)
    for par in (0, 1):
        up, own = par == 0, [t.copy() for t in xa[par]]
        if not up:
            own[0][:, :4] = 0  # the row before's tail meets zeros
        zero = np.zeros((own[0].shape[0], 8), np.float32)
        prev, c7 = own[0], zero
        same = prev @ wb[par][0].T
        cross = np.zeros_like(same)
        for i in range(1, tiles):
            cur = own[i]
            cin, c7 = (c7 if up else cur[:, :8]), prev[:, 56:]
            xs = _frag_shift(prev, cin, up)
            same += cur @ wb[par][i].T
            cross += xs @ wb[1 - par][i - 1].T
            prev = cur
        cross += _frag_shift(prev, c7 if up else zero, up) @ wb[
            1 - par][tiles - 1].T
        out[par::2, par::2] = same
        out[par::2, 1 - par::2] = cross
    act = bf(torch.nn.functional.gelu(torch.from_numpy(out + b1),
                                      approximate="tanh").numpy())
    got = bf(act @ w2 + b2)
    want = jax_mlp._fused_mlp_fwd_2d(*_jax(x, w1t.T, b1, w2, b2,
                                           dtype=jnp.bfloat16),
                                     interpret=True)
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def _phases_fc2(act, w2t, b2, split):
    """fc2 on tma_phases (csrc/mlp_phases.cu), emulated in f32 numpy: W2^T
    [o, f] (rows f apart, f no multiple of 8, its base on a 16-byte step)
    as P = 8 / gcd(f, 8) TMA maps, phase p over rows p, p + P, .. based
    c_p = f p % 8 columns early, columns past f + c_p zeros; a block's
    128 rows hold 128 / P of each phase's, tiles of 64 map columns, the
    stage past a split's last k-tile W2^T's alone and a phase's tile there
    not loaded (NaN here: stale shared memory) where its map ends before
    it.  Each row's A fragments of k-tile i are its map columns
    64 i + c_p .. from tiles i and i + 1, columns past f zero; the
    transposed product c^T = W2^T act^T summed over each split's k-tiles
    in order, the splits' sums in order, then b2."""
    o, f = w2t.shape
    m = act.shape[0]
    flat = w2t.ravel()
    P = 8 // np.gcd(f, 8)
    ktiles = -(-f // 64)
    per = -(-ktiles // split)
    act = np.pad(act, ((0, 0), (0, 64 * ktiles - f)))  # TMA's zeros past f
    out = np.zeros((m, o), np.float32)
    for o0 in range(0, o, 128):
        tiles = {}  # (phase, k-tile) -> [128 / P, 64]
        for p in range(P):
            cp = f * p % 8
            for i in range(ktiles + 1):
                tile = np.full((128 // P, 64), np.nan, np.float32)
                if p < o and 64 * i < f + cp:
                    tile[:] = 0
                    for j in range(128 // P):
                        row = o0 + p + P * j
                        for c in range(64):
                            col = 64 * i + c
                            if row < o and col < f + cp:
                                tile[j, c] = flat[row * f - cp + col]
                tiles[p, i] = tile
        total = np.zeros((min(128, o - o0), m), np.float32)
        for z in range(split):
            part = np.zeros_like(total)
            for i in range(min(ktiles, z * per), min(ktiles, z * per + per)):
                fr = np.zeros((len(total), 64), np.float32)
                for r in range(len(total)):
                    p, cp = r % P, f * (r % P) % 8
                    both = np.concatenate([tiles[p, i][r // P],
                                           tiles[p, i + 1][r // P]])
                    live = min(64, f - 64 * i)
                    fr[r, :live] = both[cp:cp + live]
                part += fr @ act[:, 64 * i:64 * i + 64].T
            total = part if z == 0 else total + part
        out[:, o0:o0 + 128] = total.T + b2[o0:o0 + 128]
    return out


@pytest.mark.parametrize("f,o", [(66, 17), (68, 130), (70, 17), (69, 5)])
@pytest.mark.parametrize("split", [1, 2])
def test_phases_fc2_matches_pallas(f, o, split):
    """The bf16 MLP's fc2 on tma_phases (csrc/mlp_phases.cu: MLP widths
    no multiple of 8, W2^T's rows in 4, 2, 4 and 8 phases off the 16-byte
    step), emulated (_phases_fc2) on fc1's rounded activation, split over
    K or not, two blocks of W2^T's rows at o = 130 and fewer rows than
    phases at o = 5, against the fused Pallas kernel in bf16 (interpret
    mode), to 2 bf16 ulps of the output's peak."""
    m, h = 40, 36
    rng = np.random.default_rng(f + o)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float(
        ).numpy()
    x = bf(rng.standard_normal((m, h)))
    w1 = bf(rng.standard_normal((h, f)) * 0.05)
    b1 = bf(rng.standard_normal(f) * 0.01)
    w2t = bf(rng.standard_normal((o, f)) * 0.05)
    b2 = bf(rng.standard_normal(o) * 0.01)
    act = bf(torch.nn.functional.gelu(torch.from_numpy(x @ w1 + b1),
                                      approximate="tanh").numpy())
    got = bf(_phases_fc2(act, w2t, b2, split))
    want = jax_mlp._fused_mlp_fwd_2d(*_jax(x, w1, b1, w2t.T, b2,
                                           dtype=jnp.bfloat16),
                                     interpret=True)
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def test_mlp_reference_matches_pallas_bf16(_interpret):
    params = _mlp_params()
    x = RNG.standard_normal((40, 64)).astype(np.float32)
    want = jax_mlp.fused_mlp(*_jax(x, *params, dtype=jnp.bfloat16))
    got = mlp.fused_mlp(*_torch(x, *params, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_mlp_takes_linear_weights_transposed():
    """The model passes nn.Linear weights as .t() views (JAX layout)."""
    fc1, fc2 = torch.nn.Linear(64, 256), torch.nn.Linear(256, 64)
    x = torch.from_numpy(RNG.standard_normal((5, 64)).astype(np.float32))
    with torch.no_grad():
        got = mlp.fused_mlp(x, fc1.weight.t(), fc1.bias, fc2.weight.t(),
                            fc2.bias)
        want = fc2(torch.nn.functional.gelu(fc1(x), approximate="tanh"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_cpu_path_launches_nothing():
    before = (att.launches, mlp.launches, ln_op.launches)
    q, k, v = _torch(*_qkv(1, 2, 4, 4, 8))
    att.attention(q, k, v, 0.5)
    mlp.fused_mlp(*_torch(RNG.standard_normal((3, 64)).astype(np.float32),
                          *_mlp_params()))
    ln_op.layer_norm(torch.ones(3, 64, dtype=torch.bfloat16),
                     torch.ones(64), torch.zeros(64), 1e-5)
    assert (att.launches, mlp.launches, ln_op.launches) == before


def test_wrappers_reject_other_devices():
    q = torch.empty(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        att.attention(q, q, q, 0.5)
    x = torch.empty(3, 64, device="meta")
    w1, w2 = torch.empty(64, 256, device="meta"), torch.empty(
        256, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        mlp.fused_mlp(x, w1, torch.empty(256, device="meta"), w2,
                      torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="device"):
        ln_op.layer_norm(x.bfloat16(), x[0], x[0], 1e-5)


# -- bf16 LayerNorm with f32 parameters (csrc/layer_norm.cu) ---------------

def _layer_norm_like_kernel(x, weight, bias, eps):
    """csrc/layer_norm.cu's arithmetic in f32: the mean, then the mean of
    squared deviations from it (not E[x^2] - mean^2), rsqrt, the affine
    with the f32 parameters, one rounding to bf16."""
    v = x.float()
    mean = v.mean(-1, keepdim=True)
    var = ((v - mean) ** 2).mean(-1, keepdim=True)
    return ((v - mean) * torch.rsqrt(var + eps) * weight
            + bias).to(torch.bfloat16)


@pytest.mark.parametrize("rows,cols,offset", [(7, 800, 0.0), (5, 64, 3.0),
                                              (3, 1024, -1.5), (4, 1041, 0.5),
                                              (3, 2048, -0.7)])
def test_layer_norm_matches_flax_bf16(rows, cols, offset):
    """The plain version and the kernel's arithmetic both give Flax's
    ``LayerNorm(epsilon=1e-5, dtype=bf16)`` from the same bf16 input and
    f32 parameters (scales near 1, biases no bf16 value holds), within 1
    bf16 ulp of each output: both round once, from f32 values that differ
    by summation order only.  Rows wider than 1024 or odd (1041, 2048)
    take the kernel's wide form, the same arithmetic."""
    import flax.linen as fnn

    x = (RNG.standard_normal((rows, cols)) + offset).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = (1 + 0.05 * RNG.standard_normal(cols)).astype(np.float32)
    bias = (0.5 * RNG.standard_normal(cols)).astype(np.float32)
    want = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8)))
                  - 7)
    xt = torch.from_numpy(x).bfloat16()
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    for got in (ln_op.layer_norm(xt, w, b, 1e-5),
                _layer_norm_like_kernel(xt, w, b, 1e-5)):
        assert got.dtype == torch.bfloat16 and got.shape == xt.shape
        assert (np.abs(got.float().numpy() - want) / ulp).max() <= 1.0


def test_layer_norm_function_gradients_are_the_plain_versions():
    """Through LayerNormFunction (forward: the kernel's arithmetic) the
    gradients of a bf16 input and of f32 parameters are those of the plain
    version, as the trainer's bf16 compute path takes them."""
    x = torch.from_numpy(RNG.standard_normal((6, 64)).astype(np.float32)
                         ).bfloat16().requires_grad_()
    w = torch.from_numpy((1 + 0.1 * RNG.standard_normal(64)).astype(
        np.float32)).requires_grad_()
    b = torch.from_numpy(RNG.standard_normal(64).astype(np.float32)
                         ).requires_grad_()
    g = torch.from_numpy(RNG.standard_normal((6, 64)).astype(np.float32)
                         ).bfloat16()
    out = ln_op.LayerNormFunction.apply(x, w, b, 1e-5,
                                        _layer_norm_like_kernel)
    got = torch.autograd.grad(out, (x, w, b), g)
    want = torch.autograd.grad(ln_op.layer_norm_reference(x, w, b, 1e-5),
                               (x, w, b), g)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    for a, e in zip(got, want):
        assert torch.equal(a, e)


# -- the attention backward kernels (csrc/attention_bwd.cu) -----------------

def _formula_vjp(q, k, v, do, scale):
    """Autograd's (dq, dk, dv) through attention_formula."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(att.attention_formula(*leaves, scale), leaves,
                               do)


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("b,h,nq,nk,d,scale", [
    (2, 10, 120, 120, 80, 800 ** -0.5), (1, 3, 37, 53, 16, 0.3)])
def test_attention_backward_reference_is_the_formula_vjp(b, h, nq, nk, d,
                                                         scale, dtype, tol):
    """In f64 and f32 the kernels' arithmetic is autograd's VJP of
    attention_formula up to summation order (its casts are no-ops there):
    each gradient within `tol` of its peak."""
    q, k, v = _torch(*_qkv(b, h, nq, nk, d), dtype=dtype)
    do = torch.from_numpy(RNG.standard_normal((b, h, nq, d))).to(dtype)
    got = att.attention_backward_reference(q, k, v, do, scale)
    for g, w in zip(got, _formula_vjp(q, k, v, do, scale)):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g - w).abs().max() / w.abs().max()
        assert err <= tol, err


@pytest.mark.parametrize("b,h,nq,nk,d,scale", [
    (2, 10, 120, 120, 80, 800 ** -0.5), (2, 4, 97, 97, 32, 0.25),
    (1, 3, 40, 56, 72, 0.5), (1, 2, 37, 37, 16, 1.0)])
def test_attention_backward_reference_bf16_within_the_formulas(b, h, nq, nk,
                                                               d, scale):
    """In bf16, against the f32 VJP of the same (bf16-valued) inputs, each
    gradient's relative L2 gap is within 3e-3 (one rounding of the output
    to bf16, 2^-9 relative, with room) and no wider than the gap of the
    formula's own bf16 VJP, the plain path's: the kernels round P and dS
    where the formula does, but keep dP, D and dS's scale in f32."""
    q, k, v = _torch(*_qkv(b, h, nq, nk, d), dtype=torch.bfloat16)
    do = torch.from_numpy(RNG.standard_normal((b, h, nq, d))).bfloat16()
    truth = _formula_vjp(*(t.float() for t in (q, k, v, do)), scale)
    got = att.attention_backward_reference(q, k, v, do, scale)
    plain = _formula_vjp(q, k, v, do, scale)
    for g, p, w in zip(got, plain, truth):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, w) <= 3e-3
        assert _rel_l2(g, w) <= _rel_l2(p, w)


def _tiled_backward(q, k, v, do, scale, tile=64):
    """The two backward kernels' loops in plain PyTorch (f32; their casts
    to bf16 left out): rows_kernel's two passes over 64-key tiles, the
    first keeping each row's running max, sum of exp2 and sum of exp2 *
    dP (log2 units, keys past Nk at -inf), the second forming dS and dQ;
    then columns_kernel's walk over query tiles of 64 rows with the
    stored statistics, forming P^T, dS^T, dV and dK.  Tiles past N are
    zero rows, as TMA's zero fill leaves them."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    log2e = 1.4426950408889634
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))
    tq, tk = -(-nq // tile), -(-nk // tile)
    qp, dop = pad(q, tile * tq), pad(do, tile * tq)
    kp, vp = pad(k, tile * tk), pad(v, tile * tk)
    m = torch.full((b, h, tile * tq), -torch.inf)
    l, a = torch.zeros_like(m), torch.zeros_like(m)
    tiles = [(kp[:, :, j * tile:(j + 1) * tile],
              vp[:, :, j * tile:(j + 1) * tile], nk - j * tile)
             for j in range(tk)]
    for kt, vt, valid in tiles:
        s = qp @ kt.transpose(-1, -2) * (scale * log2e)
        s[..., valid:] = -torch.inf
        dp = dop @ vt.transpose(-1, -2)
        mn = torch.maximum(m, s.amax(-1))
        e = torch.exp2(s - mn[..., None])
        alpha = torch.exp2(m - mn)
        l = l * alpha + e.sum(-1)
        a = a * alpha + (e * dp).sum(-1)
        m = mn
    delta, lse = a / l, m + torch.log2(l)
    dq = torch.zeros_like(qp)
    for kt, vt, valid in tiles:
        s = qp @ kt.transpose(-1, -2) * (scale * log2e)
        s[..., valid:] = -torch.inf
        dp = dop @ vt.transpose(-1, -2)
        ds = torch.exp2(s - lse[..., None]) * (dp - delta[..., None]) * scale
        dq += ds @ kt
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for i in range(tq):
        rows = slice(i * tile, (i + 1) * tile)
        valid = nq - i * tile
        qt, dot = qp[:, :, rows], dop[:, :, rows]
        st = kp @ qt.transpose(-1, -2) * (scale * log2e)
        dpt = vp @ dot.transpose(-1, -2)
        pt = torch.exp2(st - lse[:, :, None, rows])
        pt[..., valid:] = 0
        dst = pt * (dpt - delta[:, :, None, rows]) * scale
        dv += pt @ dot
        dk += dst @ qt
    return dq[:, :, :nq], dk[:, :, :nk], dv[:, :, :nk]


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 3, 120, 120, 80),
                                         (1, 2, 37, 200, 16),
                                         (1, 2, 130, 1, 24),
                                         (2, 2, 200, 70, 128)])
def test_backward_tiles_match_reference_f32(b, h, nq, nk, d):
    """The kernels' tiled schedule (partial tiles of queries and keys,
    Nq != Nk, a single key) gives the reference's gradients in f32 within
    summation order."""
    q, k, v = _torch(*_qkv(b, h, nq, nk, d))
    do = torch.from_numpy(RNG.standard_normal((b, h, nq, d)).astype(
        np.float32))
    want = att.attention_backward_reference(q, k, v, do, 0.3)
    for g, w in zip(_tiled_backward(q, k, v, do, 0.3), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2e-6 * float(w.abs().max()))


def _model_views(b, n, h, d, dtype=torch.bfloat16):
    """q, k, v as the model makes them: strided views of one fused QKV
    output [B, N, 3, H, D]."""
    return torch.empty(b, n, 3, h, d, dtype=dtype).permute(
        2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("b", [32, 8])  # one card; a dp4 rank
@pytest.mark.parametrize("n", [360, 240, 120])
def test_backward_kernels_take_the_flagships_training_calls(b, n):
    q, k, v = _model_views(b, n, 10, 80)
    assert att.backward_kernels(q, k, v) == att.BACKWARD_KERNELS
    assert all(name.startswith("mint_attention_bwd::")
               for name in att.BACKWARD_KERNELS)


def test_backward_kernels_leave_the_rest_to_the_plain_vjp():
    """f32, a head of 130, heads of 50 and 67 (hidden 800 over 16 heads,
    804 over 12: head strides off a 16-byte step) and a view of padded
    rows whose base is 2 bytes off go the plain way."""
    views = _model_views
    assert att.backward_kernels(*views(2, 360, 10, 80, torch.float32)) == ()
    assert att.backward_kernels(*views(2, 360, 8, 130)) == ()
    assert att.backward_kernels(*views(2, 360, 16, 50)) == ()
    assert att.backward_kernels(*views(2, 360, 12, 67)) == ()
    rows = torch.empty(2, 10, 360, 96, dtype=torch.bfloat16)[..., 1:81]
    assert att.backward_kernels(rows, rows, rows) == ()
    q, k, v = _model_views(2, 360, 8, 128)
    assert att.backward_kernels(q, k, v) == att.BACKWARD_KERNELS


def test_backward_route_is_the_c_entrys_rule():
    """backward_kernels refuses what the C entry mint_attention_bwd_bf16
    refuses: heads over its kMaxD (csrc/attention.cuh) or no multiple of
    8 wide, and any B, H or N stride off a 16-byte step, a dim of 1's
    included.  (The card tests run the entry on both sides of the rule.)"""
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "mint_tpu_torch", "csrc")
    with open(os.path.join(csrc, "attention.cuh")) as f:
        k_max_d = int(re.search(r"constexpr int kMaxD = (\d+);",
                                f.read()).group(1))
    with open(os.path.join(csrc, "attention_bwd.cu")) as f:
        entry = f.read().split('extern "C" int mint_attention_bwd_bf16')[1]
    assert "d > kMaxD || d % 8 != 0" in entry
    assert "for (int i = 0; i < 21; ++i)" in entry
    assert "if (strides[i] % 8 != 0)" in entry
    assert att.BACKWARD_MAX_HEAD_DIM == k_max_d
    base = torch.empty(4 * 2 * 360 * 80, dtype=torch.bfloat16)
    for stride, taken in ((3, False), (8, True), (2 * 360 * 80, True)):
        q = base.as_strided((1, 2, 360, 80), (stride, 360 * 80, 80, 1))
        assert bool(att.backward_kernels(q, q, q)) == taken, stride


def test_attention_function_backward_on_the_cpu_is_the_plain_vjp():
    """On the CPU the backward differentiates attention_formula, bf16
    included, and counts nothing (the counters are the card's)."""
    before = (att.backward_launches, att.backward_plain)
    q, k, v = _torch(*_qkv(1, 2, 24, 24, 16), dtype=torch.bfloat16)
    do = torch.from_numpy(RNG.standard_normal((1, 2, 24, 16))).bfloat16()
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = att.AttentionFunction.apply(*leaves, 0.3, att.attention_reference)
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, _formula_vjp(q, k, v, do, 0.3)):
        assert torch.equal(g, w)
    assert (att.backward_launches, att.backward_plain) == before
