"""The port's model helpers (``mint_tpu_torch/models/model_utils.py``) and
``PatchEmbedding`` against ``mint_tpu.models.model_utils`` and the JAX
``PatchEmbedding``: the nine cases of ``tests/test_model_utils.py``, each
also held to the JAX function on the same seeded numpy inputs within
1e-6 in f32 (dropout by its semantics: torch draws other bits than
``jax.random``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mint_tpu.models import model_utils as jax_mu
from mint_tpu.models.layers import PatchEmbedding as JaxPatchEmbedding
from mint_tpu_torch.models import layers, weights
from mint_tpu_torch.models import model_utils as mu

RNG = np.random.default_rng(17)
TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL)


def test_look_ahead_mask():
    m = mu.create_look_ahead_mask(4)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.triu(np.ones((4, 4)), k=1))
    batched = mu.create_look_ahead_mask(4, batch_size=3)
    assert batched.shape == (3, 4, 4)
    _close(batched, jax_mu.create_look_ahead_mask(4, batch_size=3))


def test_padding_mask_broadcast():
    from_np = RNG.standard_normal((2, 5, 8)).astype(np.float32)
    to_np = np.asarray([[1, 1, 0], [1, 0, 0]])
    m = mu.create_attention_mask_from_input_mask(torch.from_numpy(from_np),
                                                 torch.from_numpy(to_np))
    assert m.shape == (2, 5, 3) and m.dtype == torch.float32
    np.testing.assert_array_equal(m[0, 0].numpy(), [1, 1, 0])
    np.testing.assert_array_equal(m[1, 3].numpy(), [1, 0, 0])
    _close(m, jax_mu.create_attention_mask_from_input_mask(
        jnp.asarray(from_np), jnp.asarray(to_np)))


def test_gelu_matches_reference_formula():
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    _close(mu.gelu(torch.from_numpy(x)), jax.nn.gelu(x, approximate=True))
    _close(mu.gelu(torch.from_numpy(x)), jax_mu.gelu(jnp.asarray(x)))


def test_activation_registry():
    assert mu.get_activation("linear") is None
    assert mu.get_activation("") is None
    assert mu.get_activation("gelu") is layers.gelu_tanh
    assert mu.get_activation("GELU") is layers.gelu_tanh
    assert mu.get_activation("relu") is torch.relu
    fn = lambda x: x  # noqa: E731
    assert mu.get_activation(fn) is fn
    with pytest.raises(ValueError, match="Unsupported activation"):
        mu.get_activation("swish5000")
    x = RNG.standard_normal(50).astype(np.float32)
    for name in ("gelu", "relu", "tanh"):
        _close(mu.get_activation(name)(torch.from_numpy(x)),
               jax_mu.get_activation(name)(jnp.asarray(x)))
    assert jax_mu.get_activation("linear") is None


def test_gather_indexes():
    seq = RNG.standard_normal((2, 4, 3)).astype(np.float32)
    pos = np.asarray([[0, 2], [1, 3]])
    out = mu.gather_indexes(torch.from_numpy(seq), torch.from_numpy(pos))
    np.testing.assert_array_equal(out[0, 0].numpy(), seq[0, 0])
    np.testing.assert_array_equal(out[0, 1].numpy(), seq[0, 2])
    np.testing.assert_array_equal(out[1, 1].numpy(), seq[1, 3])
    _close(out, jax_mu.gather_indexes(jnp.asarray(seq), jnp.asarray(pos)))
    assert mu.get_shape_list(out) == jax_mu.get_shape_list(
        jnp.asarray(seq[:, :2])) == [2, 2, 3]


def test_split_heads_3d_and_4d():
    x3 = RNG.standard_normal((2, 5, 8)).astype(np.float32)
    got3 = mu.split_heads(torch.from_numpy(x3), 4)
    assert got3.shape == (2, 4, 5, 2)
    _close(got3, jax_mu.split_heads(jnp.asarray(x3), 4))
    x4 = RNG.standard_normal((2, 5, 24, 8)).astype(np.float32)
    got4 = mu.split_heads(torch.from_numpy(x4), 4)
    assert got4.shape == (2, 5, 4, 24, 2)
    _close(got4, jax_mu.split_heads(jnp.asarray(x4), 4))
    with pytest.raises(ValueError, match="Unsupported input tensor"):
        mu.split_heads(torch.zeros(5, 8), 4)


def test_masked_sdpa_blocks_future():
    q = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    k = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    v = RNG.standard_normal((1, 1, 4, 8)).astype(np.float32)
    mask = mu.create_look_ahead_mask(4)
    out, w = mu.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask)
    w = w.numpy()[0, 0]
    assert np.abs(np.triu(w, k=1)).max() < 1e-6  # the future: no weight
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    for m in (mask, None):
        got = mu.scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), m)
        want = jax_mu.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m.numpy()))
        for g, w_ in zip(got, want):
            _close(g, w_)
    # Unmasked: softmax(q k^T / sqrt(d)) v, d the head dim (not the
    # model's 800 ** -0.5 of FACT's attention).
    out2, _ = mu.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    ref = torch.softmax(torch.from_numpy(q @ k.transpose(0, 1, 3, 2))
                        / np.sqrt(8.0), -1) @ torch.from_numpy(v)
    _close(out2, ref)


def test_dropout_semantics():
    x = torch.ones(100, 100)
    assert mu.dropout(x, 0.5) is x  # deterministic by default
    gen = torch.Generator().manual_seed(0)
    assert mu.dropout(x, 0.0, gen, deterministic=False) is x
    y = mu.dropout(x, 0.5, gen, deterministic=False).numpy()
    kept = y > 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_allclose(y[kept], 2.0)  # inverted scaling
    # The same semantics as the JAX function, whose bits differ: each
    # kept value scaled by 1 / (1 - rate), the kept share about 1 - rate.
    xs = RNG.standard_normal((200, 200)).astype(np.float32)
    for rate in (0.1, 0.7):
        got = mu.dropout(torch.from_numpy(xs), rate, gen,
                         deterministic=False).numpy()
        want = np.asarray(jax_mu.dropout(jnp.asarray(xs), rate,
                                         rng=jax.random.PRNGKey(1),
                                         deterministic=False))
        for out in (got, want):
            kept = out != 0
            assert abs(kept.mean() - (1 - rate)) < 0.01
            np.testing.assert_allclose(out[kept], xs[kept] / (1 - rate),
                                       rtol=1e-6)
    a = mu.dropout(x, 0.5, torch.Generator().manual_seed(3), False)
    b = mu.dropout(x, 0.5, torch.Generator().manual_seed(3), False)
    assert torch.equal(a, b)  # the generator decides the draws


def test_patch_embedding_shape():
    """PatchEmbedding through the weights bridge: the JAX module's Dense
    kernel ([in, out]) loads into ``patch_embed_layer``, and both give the
    same [B, patches, hidden] from the same image within 1e-6."""
    jax_mod = JaxPatchEmbedding(hidden_size=32, patch_size=4, num_channel=3)
    x = RNG.standard_normal((2, 16, 16, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax_mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["patch_embed_layer"]["bias"] = RNG.standard_normal(
        32).astype(np.float32)
    want = np.asarray(jax_mod.apply(params, jnp.asarray(x)))
    assert want.shape == (2, 16, 32)  # (16/4) * (16/4) patches
    mod = layers.PatchEmbedding(hidden_size=32, patch_size=4, num_channel=3)
    mod.load_state_dict(weights.from_jax_params(params, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.shape == (2, 16, 32)
    _close(got, want)
    back = weights.to_numpy_tree(mod)["params"]["patch_embed_layer"]
    np.testing.assert_array_equal(back["kernel"],
                                  params["params"]["patch_embed_layer"]
                                  ["kernel"])
    with pytest.raises(ValueError, match="is not"):
        mod(torch.zeros(2, 15, 16, 3))
    init = mu.create_initializer(0.02)(torch.empty(1000),
                                       torch.Generator().manual_seed(0))
    assert init.abs().max() <= 0.04 and 0.005 < init.std() < 0.02
