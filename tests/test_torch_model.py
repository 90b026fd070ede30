"""The port's FACT forward against ``mint_tpu.models.fact.FACT.apply`` on
identical weights (CPU, f32: the kernels' plain versions run)."""

import copy

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
    cast gives), LayerNorm's f32 ones (Flax keeps those), and its forward
    stays near the f32 one."""
    from mint_tpu.config import schema as S

    cfg = S.MultiModalModelConfig(fact_model=tiny_config())
    m32 = builder.build(cfg, is_training=False, device="cpu")
    m16 = builder.build(cfg, is_training=False, dtype=torch.bfloat16,
                        device="cpu")
    m16.load_state_dict(m32.state_dict())
    for name, p in m16.named_parameters():
        want = torch.float32 if ".norm_" in name else torch.bfloat16
        assert p.dtype == want, name
    assert sum(".norm_" in n for n, _ in m16.named_parameters()) == 24
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


# -- bf16 LayerNorm as Flax computes it --------------------------------------

def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits), at least that
    at 2^-8: below it the two sides' f32 rounding, not bf16's, rules."""
    mag = np.maximum(np.abs(x), 2.0 ** -8)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _hard_ln_params(x, rng):
    """f32 LayerNorm parameters no bf16 value holds: scales near 1 and
    biases that cancel row 0's normalised term up to a small remainder, so
    a bf16 copy's rounding of the bias (2^-9 relative) lands on a small
    output."""
    x64 = x.astype(np.float64)
    norm = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(
        x64.var(-1, keepdims=True) + 1e-5)
    scale = (1.0 + 0.01 * rng.standard_normal(x.shape[-1]))
    bias = -scale * norm[0] + 0.05 * rng.standard_normal(x.shape[-1])
    return scale.astype(np.float32), bias.astype(np.float32)


def test_bf16_layer_norm_matches_flax_within_one_ulp():
    """The whole-model bf16 cast keeps LayerNorm's parameters f32 and
    gives Flax's LayerNorm(dtype=bf16) output from the same f32 parameters
    and bf16 input, within 1 bf16 ulp; a bf16 copy of the parameters (the
    cast before LayerNorm was kept f32) does not."""
    import flax.linen as fnn
    import jax

    rng = np.random.default_rng(17)
    dim = 64
    x = jnp.asarray(rng.standard_normal((4, dim)) * 2 + 0.5, jnp.bfloat16)
    x_np = np.array(x.astype(jnp.float32))
    scale, bias = _hard_ln_params(x_np, rng)
    assert not np.array_equal(scale.astype(jnp.bfloat16).astype(np.float32),
                              scale)
    flax_ln = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    want = flax_ln.apply({"params": {"scale": scale, "bias": bias}}, x)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    ln = layers.LayerNorm(dim)  # f32, as the bf16 build keeps it
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    x_t = torch.from_numpy(x_np).to(torch.bfloat16)
    with torch.no_grad():
        got = ln(x_t)
        parent = copy.deepcopy(ln).to(torch.bfloat16)(x_t)
    assert got.dtype == parent.dtype == torch.bfloat16
    ulps = np.abs(got.float().numpy() - want) / _bf16_ulp(want)
    parent_ulps = np.abs(parent.float().numpy() - want) / _bf16_ulp(want)
    assert ulps.max() <= 1.0, ulps.max()
    # The bf16 copy of the parameters misses by many ulps on row 0.
    assert parent_ulps.max() > 4.0, parent_ulps.max()


def test_bf16_forward_matches_jax_compute_dtype():
    """The tiny config's whole-model bf16 forward against the JAX model's
    ``compute_dtype=bf16`` forward from the same f32 weights, every
    LayerNorm's parameters drawn so that no bf16 value holds them; a bf16
    copy of the LayerNorm parameters (the parent's cast) misses.

    To make that copy's rounding show past the two sides' own bf16 noise
    (the JAX model rounds fc1's output and the scores to bf16, the port's
    plain kernels keep them f32), every motion frame is one small one-hot
    row and the motion position table is zero, so every token of the
    motion transformer's first LayerNorm normalises to one vector n0, and
    that LayerNorm's bias cancels ``scale * n0`` up to 1e-3: its output is
    small, and a bias rounded to bf16 (2^-9 of |bias|, a few 1e-3) moves
    it, and the small residual stream after it, by tens of percent."""
    from mint_tpu.models.fact import FACT as JaxFACT
    from mint_tpu_torch.config import schema as S
    from mint_tpu_torch.models import weights
    from test_torch_weights import numpy_tree

    cfg = tiny_config()
    _, params, m32 = paired(cfg, seed=3)
    rng = np.random.default_rng(23)
    params = numpy_tree(params)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if set(v) == {"scale", "bias"}:
                    n = v["scale"].shape[0]
                    v["scale"] = (1 + 0.05 * rng.standard_normal(n)).astype(
                        np.float32)
                    v["bias"] = (0.5 * rng.standard_normal(n)).astype(
                        np.float32)
                else:
                    perturb(v)
    perturb(params)
    p = params["params"]
    p["motion_pos_embedding"]["pos_embedding"] = np.zeros_like(
        p["motion_pos_embedding"]["pos_embedding"])
    c = 2.0 ** -5  # a power of two: c * W rounds as W does
    x0 = (torch.from_numpy(c * p["motion_linear_embedding"]["dense"]["kernel"]
                           [0]).to(torch.bfloat16).double())
    n0 = ((x0 - x0.mean()) / torch.sqrt(x0.var(unbiased=False) + 1e-5)
          ).numpy()
    ln = p["motion_transformer"]["block_0"]["norm_attn"]
    ln["bias"] = (-ln["scale"].astype(np.float64) * n0
                  + 1e-3 * rng.standard_normal(n0.size)).astype(np.float32)
    r = np.random.default_rng(5)
    motion = np.zeros((2, m32.motion_seq_length, m32.motion_dim), np.float32)
    motion[..., 0] = c
    inputs = {"motion_input": motion, "audio_input": r.standard_normal(
        (2, m32.audio_seq_length, m32.audio_dim)).astype(np.float32)}
    want = np.asarray(JaxFACT(cfg, compute_dtype=jnp.bfloat16).apply(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
        .astype(jnp.float32))
    m16 = builder.build(S.MultiModalModelConfig(fact_model=cfg),
                        is_training=False, dtype=torch.bfloat16, device="cpu")
    m16.load_state_dict(weights.from_jax_params(params, m16))
    norms = [m for m in m16.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.weight.dtype == torch.float32 for m in norms)
    parent = copy.deepcopy(m16).to(torch.bfloat16)
    inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = m16(inputs)
        got_parent = parent(inputs)
    assert got.dtype == torch.bfloat16
    # bf16 through 6 blocks: the JAX model rounds at more points than the
    # port's plain kernels (fc1's output, the scores), and the next blocks
    # carry a rounding that fell the other way: 3 bf16 ulps at the
    # output's peak (over 8 seeds of this construction the worst was 1.5;
    # the parent's cast missed by 6 to 20).
    tol = 3 * _bf16_ulp(np.abs(want).max())
    err = np.abs(got.float().numpy() - want).max()
    err_parent = np.abs(got_parent.float().numpy() - want).max()
    assert err <= tol, (err, tol)
    assert err_parent > 2 * tol, (err_parent, tol)
