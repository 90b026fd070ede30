"""The port's FACT forward against ``mint_tpu.models.fact.FACT.apply`` on
identical weights (CPU, f32: the kernels' plain versions run)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.models.fact import l2_loss as jax_l2_loss
from mint_tpu_torch.models import builder, layers
from mint_tpu_torch.models.fact import l2_loss
from test_torch_weights import geometry_config, paired, tiny_config

RNG = np.random.default_rng(7)
# f32 forward vs JAX: summation order only (the class of the 6e-6 the JAX
# package holds against the TF reference, docs/BENCHMARKS.md).
ATOL, RTOL = 1e-5, 1e-5


def _inputs(model, batch=2):
    return {
        "motion_input": RNG.standard_normal(
            (batch, model.motion_seq_length, model.motion_dim)
        ).astype(np.float32),
        "audio_input": RNG.standard_normal(
            (batch, model.audio_seq_length, model.audio_dim)
        ).astype(np.float32),
    }


@pytest.fixture(scope="module", params=["tiny", "geometry"])
def pair(request):
    cfg = tiny_config() if request.param == "tiny" else geometry_config()
    return paired(cfg, seed=2)


def _both(pair, inputs, **kw):
    jax_model, params, model = pair
    want = np.asarray(jax_model.apply(
        params, {k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()},
                    **kw).numpy()
    return got, want


def test_forward_matches_jax(pair):
    inputs = _inputs(pair[2])
    got, want = _both(pair, inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_first_n_out_is_the_first_rows(pair):
    _, _, model = pair
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(model).items()}
    with torch.no_grad():
        full = model(inputs)
        for n in (1, 5, 48):
            part = model(inputs, first_n_out=n)
            rows = min(n, full.shape[1])
            assert part.shape == (2, rows, full.shape[2])
            np.testing.assert_allclose(part.numpy(), full[:, :rows].numpy(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_queries", [7, None])
def test_attention_truncation_matches_jax(n_queries):
    """The port's Attention (heads split from the fused QKV projection as
    strided views, merged from the kernel's output layout) equals the JAX
    module's output on identical weights; with ``n_queries`` its rows are
    the first rows of that output."""
    from mint_tpu.models.layers import Attention as JaxAttention
    import jax

    x = RNG.standard_normal((2, 24, 32)).astype(np.float32)
    jax_mod = JaxAttention(32, 4)
    variables = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax_mod.apply(variables, jnp.asarray(x)))[:, :n_queries]
    p = variables["params"]
    mod = layers.Attention(32, 4)
    with torch.no_grad():
        mod.to_qkv.weight.copy_(torch.from_numpy(
            np.asarray(p["to_qkv"]["kernel"]).T.copy()))
        mod.to_out.weight.copy_(torch.from_numpy(
            np.asarray(p["to_out"]["kernel"]).T.copy()))
        mod.to_out.bias.copy_(torch.tensor(np.asarray(p["to_out"]["bias"])))
        got = mod(torch.from_numpy(x), n_queries=n_queries).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_l2_loss_matches_jax():
    target = RNG.standard_normal((3, 20, 9)).astype(np.float32)
    pred = RNG.standard_normal((3, 36, 9)).astype(np.float32)
    want = float(jax_l2_loss(jnp.asarray(target), jnp.asarray(pred)))
    got = l2_loss(torch.from_numpy(target), torch.from_numpy(pred)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_bf16_build_casts_once_and_runs():
    """build(dtype=bf16) holds bf16 weights (the values Flax's per-call
    cast gives) and its forward stays near the f32 one."""
    from mint_tpu.config import schema as S

    cfg = S.MultiModalModelConfig(fact_model=tiny_config())
    m32 = builder.build(cfg, is_training=False, device="cpu")
    m16 = builder.build(cfg, is_training=False, dtype=torch.bfloat16,
                        device="cpu")
    m16.load_state_dict(m32.state_dict())
    assert all(p.dtype == torch.bfloat16 for p in m16.parameters())
    assert not m16.training
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(m32).items()}
    with torch.no_grad():
        a = m32(inputs)
        b = m16(inputs)
    assert b.dtype == torch.bfloat16 and torch.isfinite(b.float()).all()
    assert (a - b.float()).abs().max() < 0.1 * max(1.0, a.abs().max())


def test_build_defaults_to_the_card():
    """Without ``device`` the builder asks for CUDA: where there is no
    card it raises, and never quietly builds on the CPU."""
    from mint_tpu_torch.config import schema as S

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default build succeeds")
    cfg = S.MultiModalModelConfig(fact_model=tiny_config())
    with pytest.raises(RuntimeError, match="cuda"):
        builder.build(cfg, is_training=False)


def test_gelu_is_tanh_form():
    x = torch.linspace(-4, 4, 101)
    want = 0.5 * x * (1 + torch.tanh(np.sqrt(2 / np.pi)
                                     * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(layers.gelu_tanh(x), want)
    assert not torch.allclose(layers.gelu_tanh(x),
                              torch.nn.functional.gelu(x), atol=1e-5)
