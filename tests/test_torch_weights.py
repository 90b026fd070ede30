"""Weights bridge and initialization of the PyTorch port
(mint_tpu_torch/models/weights.py, fact.init_params).

Also home of the helpers the other test_torch_* files share: the tiny and
FACT-geometry configs, and a JAX FACT paired with a port FACT holding the
same weights.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from mint_tpu.config import schema as S
from mint_tpu.models.fact import FACT as JaxFACT
from mint_tpu.models.fact import init_params as jax_init_params
from mint_tpu_torch.models import layers, weights
from mint_tpu_torch.models.fact import FACT, init_params


def tiny_config():
    """hidden 32, 4 heads, 2 layers, seqs 8/16 (motion 9-dim)."""
    return __graft_entry__._tiny_fact_config()


def geometry_config():
    """FACT's head geometry (hidden 800, 10 heads of 80, MLP 3072, 225-dim
    motion, 35-dim audio) at 1 layer per transformer and seqs 12/24."""
    def transformer():
        return S.TransformerConfig(hidden_size=800, num_hidden_layers=1,
                                   num_attention_heads=10,
                                   intermediate_size=3072)

    def modality(name, seq, dim):
        return S.ModalityConfig(
            feature_name=name, sequence_length=seq, feature_dim=dim,
            model=[S.ModalityModelConfig(transformer=transformer())])

    return S.FACTModelConfig(
        modality=[modality("audio", 24, 35), modality("motion", 12, 225)],
        cross_modal_model=S.CrossModalModelConfig(
            modality_a="motion", modality_b="audio",
            transformer=transformer(),
            output_layer=S.MLPConfig(out_dim=225)))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def paired(cfg, seed=0):
    """(jax model, jax params, port model in f32 eval mode) with the same
    weights, taken from the JAX initialization through the bridge."""
    jax_model = JaxFACT(cfg)
    params = jax_init_params(jax_model, jax.random.PRNGKey(seed))
    model = FACT(cfg).eval()
    model.load_state_dict(weights.from_jax_params(numpy_tree(params), model))
    return jax_model, params, model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module", params=["tiny", "geometry"])
def pair(request):
    cfg = tiny_config() if request.param == "tiny" else geometry_config()
    return request.param, paired(cfg)


def test_round_trip_is_exact(pair):
    _, (_, params, model) = pair
    want = _flat(numpy_tree(params))
    got = _flat(weights.to_numpy_tree(model))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_every_key_and_shape(pair):
    name, (_, params, model) = pair
    flat = _flat(numpy_tree(params))
    state = model.state_dict()
    assert len(flat) == len(state)
    n_blocks = 3 if name == "geometry" else 6
    block_leaves = [k for k in flat if "/block_" in k]
    assert len(block_leaves) == 11 * n_blocks
    # Dense kernels [in, out] land transposed in Linear.weight [out, in].
    kernel = flat["params/cross_modal_layer/transformer/block_0/attn/"
                  "to_qkv/kernel"]
    weight = state["cross_modal_layer.transformer.block_0.attn.to_qkv."
                   "weight"]
    assert tuple(weight.shape) == kernel.shape[::-1]
    np.testing.assert_array_equal(weight.numpy(), kernel.T)
    scale = flat["params/motion_transformer/block_0/norm_mlp/scale"]
    np.testing.assert_array_equal(
        state["motion_transformer.block_0.norm_mlp.weight"].numpy(), scale)
    np.testing.assert_array_equal(
        state["audio_pos_embedding.pos_embedding"].numpy(),
        flat["params/audio_pos_embedding/pos_embedding"])
    if name == "geometry":
        assert kernel.shape == (800, 2400)
        assert flat["params/cross_modal_layer/transformer/block_0/mlp/fc1/"
                    "kernel"].shape == (800, 3072)
        assert flat["params/cross_modal_layer/cross_output_layer/"
                    "kernel"].shape == (800, 225)


def test_flagship_tree_shape():
    """The flagship's 16 blocks of 11 leaves, plus embeddings and head."""
    from mint_tpu.config.schema import load_pipeline_config

    cfg = load_pipeline_config(__graft_entry__._CONFIG)
    with torch.device("meta"):
        model = FACT(cfg.multi_modal_model.fact_model)
    names = weights._leaf_names(model)
    assert sum("/block_" in p for p, _ in names.values()) == 16 * 11
    # + 2 linear embeddings (kernel, bias), 2 position tables, head.
    assert len(names) == 16 * 11 + 4 + 2 + 2


def test_rejects_missing_extra_and_misshaped():
    _, params, model = paired(tiny_config())
    tree = numpy_tree(params)["params"]

    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["motion_pos_embedding"]
    with pytest.raises(ValueError, match="motion_pos_embedding"):
        weights.from_jax_params(missing, model)

    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["audio_linear_embedding"]["dense"]["bogus"] = np.zeros(3)
    with pytest.raises(ValueError, match="bogus"):
        weights.from_jax_params(extra, model)

    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["cross_modal_layer"]["transformer"]["block_1"]["mlp"]["fc2"][
        "kernel"] = np.zeros((5, 7), np.float32)
    with pytest.raises(ValueError, match="block_1/mlp/fc2/kernel"):
        weights.from_jax_params(bad, model)


def test_init_params_distributions():
    """Keras initializers, checked by distribution on the FACT geometry."""
    model = init_params(FACT(geometry_config()),
                        torch.Generator().manual_seed(3))
    for name, mod in model.named_modules():
        if isinstance(mod, layers.Dense):
            w = mod.weight.detach()
            if name.endswith("cross_output_layer"):
                assert w.abs().max() <= 2 * 0.02 + 1e-7
                assert abs(w.std().item() - 0.0176) < 0.002, name
            else:
                fan_out, fan_in = w.shape
                bound = np.sqrt(6.0 / (fan_in + fan_out))
                assert w.abs().max() <= bound + 1e-7, name
                # Uniform on [-b, b]: std b / sqrt(3).
                assert abs(w.std().item() - bound / np.sqrt(3)) \
                    < 0.05 * bound, name
            if mod.bias is not None:
                assert torch.count_nonzero(mod.bias) == 0, name
        elif isinstance(mod, torch.nn.LayerNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
        elif isinstance(mod, layers.PositionEmbedding):
            p = mod.pos_embedding.detach()
            assert p.abs().max() <= 0.04 + 1e-7, name
            # sigma 0.02 truncated at 2 sigma has std 0.02 * 0.8796.
            assert abs(p.std().item() - 0.0176) < 0.002, name


def test_init_params_is_seeded():
    a = init_params(FACT(tiny_config()), torch.Generator().manual_seed(5))
    b = init_params(FACT(tiny_config()), torch.Generator().manual_seed(5))
    c = init_params(FACT(tiny_config()), torch.Generator().manual_seed(6))
    for (k, x), y, z in zip(a.state_dict().items(),
                            b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not all(torch.equal(x, z) for x, z in zip(
        a.state_dict().values(), c.state_dict().values()))


def test_jax_init_matches_port_init_distribution():
    """Same initializer family on both sides: per-leaf std within 5%."""
    jax_model = JaxFACT(geometry_config())
    params = _flat(numpy_tree(jax_init_params(jax_model,
                                              jax.random.PRNGKey(0))))
    model = init_params(FACT(geometry_config()),
                        torch.Generator().manual_seed(0))
    ours = _flat(weights.to_numpy_tree(model))
    for key, want in params.items():
        if want.std() == 0:  # biases: zero on both sides
            np.testing.assert_array_equal(ours[key], want, err_msg=key)
            continue
        assert abs(ours[key].std() - want.std()) < 0.05 * want.std(), key
