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
