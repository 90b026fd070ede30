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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.ops import attention as jax_attention
from mint_tpu.ops import mlp as jax_mlp
from mint_tpu_torch.ops import attention as att
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
    """The bf16 kernel holds a head's whole K in shared memory, so it takes
    at most max_keys keys (csrc/attention.cu, tc_smem_bytes); past that the
    wrapper raises before any launch.  The f32 kernel streams K: no
    limit."""
    assert att.bf16_max_keys(d) == max_keys
    q = torch.zeros(1, 2, 48, d, dtype=torch.bfloat16)
    for nk in (360, max_keys):
        k = torch.zeros(1, 2, nk, d, dtype=torch.bfloat16)
        assert att._operands(q, k, k)[-1].shape == q.shape
    k = torch.zeros(1, 2, max_keys + 1, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"at most {max_keys} keys"):
        att._operands(q, k, k)
    q32, k32 = q.float(), torch.zeros(1, 2, 4 * max_keys, d)
    assert att._operands(q32, k32, k32)[-1].shape == q.shape


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


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("m", [40, 257])
def test_two_pass_bf16_mlp_matches_pallas(m, split):
    """The bf16 CUDA path (csrc/mlp.cu): fc1 + b1 + GELU in f32 rounded to
    a bf16 scratch (the TPU kernel's own rounding point), then fc2 + b2 in
    f32 rounded to bf16; with split > 1 each pass sums 64-wide k-tiles in
    parts added in a fixed order, as at small M.  Against the fused Pallas
    kernel in bf16 (interpret mode), to 2 bf16 ulps of the output's
    peak."""
    params = _mlp_params(h=256, f=512, o=64)
    x = RNG.standard_normal((m, 256)).astype(np.float32)
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
    before = (att.launches, mlp.launches)
    q, k, v = _torch(*_qkv(1, 2, 4, 4, 8))
    att.attention(q, k, v, 0.5)
    mlp.fused_mlp(*_torch(RNG.standard_normal((3, 64)).astype(np.float32),
                          *_mlp_params()))
    assert (att.launches, mlp.launches) == before


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
