"""The port's LayerNorm-affine fold (``mint_tpu_torch/models/fold.py``) and
the affine-free bf16 LayerNorm it runs, against ``mint_tpu.models.fold``
and Flax on the CPU: the four cases of ``tests/test_fold.py`` on the port,
each also held to the JAX fold on the same bridged weights, and the fold
in the port's evaluator.

Tolerances: the folded f32 forward against the unfolded one 2e-4
absolute and 5e-4 relative (the JAX test's: the fold moves the rounding
of one product a weight); the port's folded leaves against the JAX
fold's 1e-6 (the same f32 products, summed in another order for the new
biases); the folded forwards of the two packages 1e-5 (summation order,
as ``test_torch_model.py``); decodes 5e-3 (the JAX test's, over 8
steps); the affine-free bf16 LayerNorm one bf16 ulp of Flax's output.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mint_tpu.config import load_pipeline_config as jax_load_config
from mint_tpu.infer.decoder import infer_auto_regressive as jax_decode
from mint_tpu.models import build as jax_build
from mint_tpu.models import init_params as jax_init_params
from mint_tpu.models.fold import fold_for_decode as jax_fold_for_decode
from mint_tpu.models.fold import fold_ln_affines as jax_fold_ln_affines
from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models import builder, fold, layers, weights
from mint_tpu_torch.ops import layer_norm as layer_norm_op
from mint_tpu_torch.parallel import mesh as mesh_lib
from test_torch_model import _bf16_ulp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")


def _small(cfg):
    """tests/test_fold.py's cut of the flagship: width 64, 2 blocks of 4
    heads, MLP 128, in every transformer (full windows)."""
    cfg = copy.deepcopy(cfg)
    tfs = [m.model[0].transformer for m in cfg.fact_model.modality]
    tfs.append(cfg.fact_model.cross_modal_model.transformer)
    for tf in tfs:
        tf.hidden_size = 64
        tf.num_hidden_layers = 2
        tf.num_attention_heads = 4
        tf.intermediate_size = 128
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def small_pair():
    """(JAX model, its params with the LayerNorm affines moved off 1 and
    0 as tests/test_fold.py moves them, the port's f32 model with the same
    weights)."""
    jax_model = jax_build(_small(jax_load_config(CONFIG).multi_modal_model),
                          is_training=False)
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_model, jax.random.PRNGKey(0), batch_size=2))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = "/".join(str(p) for p in path)
        if "norm" in name:
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = builder.build(_small(load_pipeline_config(CONFIG)
                                 .multi_modal_model), is_training=False,
                          device="cpu")
    model.load_state_dict(weights.from_jax_params(params, model))
    return jax_model, params, model


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return {"motion_input": rng.standard_normal((batch, 120, 225),
                                                np.float32),
            "audio_input": rng.standard_normal((batch, 240, 35),
                                               np.float32)}


def _forward(model, inputs):
    with torch.no_grad():
        return model({k: torch.from_numpy(v) for k, v in
                      inputs.items()}).float().numpy()


def test_folded_structure_matches_folded_init(small_pair):
    """The folded state_dict has the keys and shapes of a folded build (no
    norm_attn / norm_mlp, a to_qkv bias), and bridges to the folded JAX
    init's tree, leaf for leaf."""
    jax_model, params, model = small_pair
    folded_model, folded = fold.fold_for_decode(model, model.state_dict())
    init = builder.build(_small(load_pipeline_config(CONFIG)
                                .multi_modal_model), is_training=False,
                         device="cpu", ln_affine_folded=True)
    want = {k: tuple(v.shape) for k, v in init.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in folded.items()} == want
    assert folded_model.ln_affine_folded and not model.ln_affine_folded
    assert not any(".norm_" in k for k in folded)
    ref = jax.tree_util.tree_map(np.shape, jax_init_params(
        jax_model.clone(ln_affine_folded=True), jax.random.PRNGKey(1),
        batch_size=2))
    got = jax.tree_util.tree_map(np.shape,
                                 weights.to_numpy_tree(folded_model))
    assert got == ref


def test_fold_is_numerically_exact_f32(small_pair):
    """The folded f32 forward equals the unfolded one (2e-4 absolute, 5e-4
    relative); the port's folded leaves equal the JAX fold's (1e-6) and
    its folded forward the folded JAX forward (1e-5)."""
    jax_model, params, model = small_pair
    folded_model, folded = fold.fold_for_decode(model, model.state_dict())
    inputs = _inputs()
    out = _forward(model, inputs)
    out_folded = _forward(folded_model, inputs)
    np.testing.assert_allclose(out_folded, out, rtol=0, atol=2e-4)
    rel = np.abs(out - out_folded) / np.maximum(np.abs(out), 1e-3)
    assert rel.max() < 5e-4

    jax_folded = jax_fold_ln_affines(params)
    want = _flat(jax_folded["params"])
    got = _flat(weights.to_numpy_tree(folded_model)["params"])
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    jax_out = np.asarray(jax_model.clone(ln_affine_folded=True).apply(
        jax_folded, {k: jnp.asarray(v) for k, v in inputs.items()}))
    np.testing.assert_allclose(out_folded, jax_out, rtol=1e-5, atol=1e-5)


def test_fold_refuses_double_fold(small_pair):
    """fold_for_decode on a folded model is a no-op; folding folded
    weights again returns them unchanged, as the JAX fold does with the
    same folded weights; a half-folded state_dict (LayerNorms beside a
    to_qkv bias) is refused."""
    _, params, model = small_pair
    folded_model, folded = fold.fold_for_decode(model, model.state_dict())
    again_model, again = fold.fold_for_decode(folded_model, folded)
    assert again_model is folded_model and again is folded
    twice = fold.fold_ln_affines(folded)
    assert twice is not folded and list(twice) == list(folded)
    for key, leaf in folded.items():
        assert torch.equal(twice[key], leaf), key
    jax_folded = jax_fold_ln_affines(params)
    jax_twice = _flat(jax_fold_ln_affines(jax_folded)["params"])
    for path, leaf in _flat(jax_folded["params"]).items():
        np.testing.assert_array_equal(jax_twice[path], leaf, err_msg=path)
    twin = copy.deepcopy(folded_model)
    twin.load_state_dict(twice)
    got = _flat(weights.to_numpy_tree(twin)["params"])
    assert set(got) == set(jax_twice)
    for path in jax_twice:
        np.testing.assert_allclose(got[path], jax_twice[path], rtol=0,
                                   atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match="look folded already"):
        fold.fold_ln_affines(dict(model.state_dict(), **{
            "cross_modal_layer.transformer.block_0.attn.to_qkv.bias":
                torch.zeros(192)}))


def test_folded_decode_parity(small_pair):
    """An 8-step decode of the folded f32 model stays within 5e-3 of the
    unfolded one, and within 5e-3 of the folded JAX decode."""
    jax_model, params, model = small_pair
    folded_model, _ = fold.fold_for_decode(model, model.state_dict())
    rng = np.random.default_rng(3)
    inputs = {"motion_input": rng.standard_normal((1, 120, 225),
                                                  np.float32),
              "audio_input": rng.standard_normal((1, 260, 35), np.float32)}
    out = decoder.infer_auto_regressive(model, inputs, steps=8).numpy()
    out_f = decoder.infer_auto_regressive(folded_model, inputs,
                                          steps=8).numpy()
    np.testing.assert_allclose(out_f, out, rtol=0, atol=5e-3)
    jax_folded_model, jax_folded = jax_fold_for_decode(jax_model, params)
    want = np.asarray(jax_decode(jax_folded_model, jax_folded,
                                 {k: jnp.asarray(v)
                                  for k, v in inputs.items()}, steps=8))
    np.testing.assert_allclose(out_f, want, rtol=0, atol=5e-3)


def test_fold_of_a_rank_slice_is_the_slice_of_the_fold(small_pair):
    """A tensor-parallel rank's slice folds into the matching slice of the
    whole fold (its heads' rows of to_qkv and its bias, its fc1 rows)."""
    _, _, model = small_pair
    full = model.state_dict()
    heads = mesh_lib.attention_heads(model)
    whole = fold.fold_ln_affines(full)
    for r in range(2):
        mesh = mesh_lib.Mesh(1, 2, r)
        got = fold.fold_ln_affines(mesh_lib.shard_state_dict(full, mesh,
                                                             heads))
        want = mesh_lib.shard_state_dict(whole, mesh, heads)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_evaluator_fold_ln_writes_the_unfolded_clips(small_pair, tmp_path):
    """Evaluator(fold_ln=True) decodes with one folded twin, loaded in
    place each pass, and writes the clips of fold_ln=False within the
    decode tolerance; the model itself keeps its LayerNorms."""
    _, _, model = small_pair
    rng = np.random.default_rng(5)
    clips = [{"motion_input": rng.standard_normal((1, 120, 225),
                                                  np.float32),
              "audio_input": rng.standard_normal((1, 247, 35), np.float32),
              "motion_name": [f"m{i}".encode()],
              "audio_name": [b"a"]} for i in range(2)]
    outs = {}
    for fold_ln in (False, True):
        out_dir = tmp_path / str(fold_ln)
        ev = Evaluator(model, clips, output_dir=str(out_dir), steps=8,
                       fold_ln=fold_ln)
        twin = ev.replicas.models[0]
        assert (twin is model) != fold_ln and ev.model is model
        ev.evaluate(model.state_dict())
        ptr = twin.cross_modal_layer.transformer.block_0.attn.to_qkv.bias
        ptr = None if ptr is None else ptr.data_ptr()
        ev.evaluate()  # the model's own weights; the same clips again
        if fold_ln:
            assert (twin.cross_modal_layer.transformer.block_0.attn.to_qkv
                    .bias.data_ptr() == ptr)  # loaded in place
        outs[fold_ln] = [np.load(out_dir / f"m{i}_a.npy") for i in range(2)]
    assert model.cross_modal_layer.transformer.block_0.norm_attn.weight \
        is not None
    for a, b in zip(outs[False], outs[True]):
        assert a.shape == b.shape == (128, 225)
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-3)


def test_bf16_affine_free_layer_norm_matches_flax_within_one_ulp():
    """The plain version of the affine-free bf16 LayerNorm kernel, and the
    port's LayerNorm(affine=False) on a bf16 input, give Flax's
    LayerNorm(use_scale=False, use_bias=False, dtype=bf16) within one bf16
    ulp; in f32 the affine-free LayerNorm is one layer_norm call."""
    import flax.linen as fnn

    rng = np.random.default_rng(19)
    for rows, dim in ((4, 64), (9, 800)):
        x = jnp.asarray(rng.standard_normal((rows, dim)) * 2 + 0.5,
                        jnp.bfloat16)
        x_np = np.array(x.astype(jnp.float32))
        flax_ln = fnn.LayerNorm(epsilon=1e-5, use_scale=False,
                                use_bias=False, dtype=jnp.bfloat16)
        want = flax_ln.apply({"params": {}}, x)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        x_t = torch.from_numpy(x_np).to(torch.bfloat16)
        ln = layers.LayerNorm(dim, affine=False)
        assert ln.weight is None and ln.bias is None
        with torch.no_grad():
            for got in (layer_norm_op.layer_norm_reference(x_t, None, None,
                                                           1e-5),
                        layer_norm_op.layer_norm(x_t, None, None, 1e-5),
                        ln(x_t)):
                assert got.dtype == torch.bfloat16
                ulps = np.abs(got.float().numpy() - want) / _bf16_ulp(want)
                assert ulps.max() <= 1.0, ulps.max()
            f32 = ln(torch.from_numpy(x_np))
        assert f32.dtype == torch.float32
        torch.testing.assert_close(
            f32, torch.nn.functional.layer_norm(torch.from_numpy(x_np),
                                                (dim,), eps=1e-5),
            rtol=0, atol=0)


def test_bf16_folded_forward_runs_the_affine_free_layer_norm(small_pair):
    """The folded model cast to bf16 (LayerNorms without parameters, as
    builder.build keeps them) runs every Block LayerNorm affine-free and
    stays within bf16's tolerance of the f32 unfolded forward."""
    _, _, model = small_pair
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    for m in bf16.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.float()
    folded_model, _ = fold.fold_for_decode(bf16, model.state_dict())
    assert folded_model.dtype == torch.bfloat16
    norms = [m for m in folded_model.modules()
             if isinstance(m, layers.LayerNorm)]
    assert len(norms) == 12 and all(m.weight is None for m in norms)
    inputs = _inputs(seed=4)
    want = _forward(model, inputs)
    got = _forward(folded_model, inputs)
    assert np.isfinite(got).all()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 2e-2, err
