"""Checkpoints into the port: the reference TF checkpoint
(``mint_tpu_torch/tools/convert_checkpoint.py``) and the JAX trainer's
Orbax checkpoints (``scripts/convert_orbax_to_torch.py``), against the
JAX package on the CPU.

The TF name map is held to ``mint_tpu.tools.convert_checkpoint`` key by
key and on a synthetic TF checkpoint built as
``tests/test_convert_checkpoint.py`` builds one (where tensorflow
imports); conversions copy values, so the converted weights equal the
source bit for bit, and forwards from them equal the JAX forward within
1e-5 of the peak (f32, summation order).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mint_tpu.config.schema import load_pipeline_config as jax_load_config
from mint_tpu.models import build as jax_build
from mint_tpu.models.fact import init_params as jax_init_params
from mint_tpu.parallel import make_mesh
from mint_tpu.tools import convert_checkpoint as jax_convert
from mint_tpu.train import CheckpointManager as JaxCheckpointManager
from mint_tpu.train import Trainer as JaxTrainer
from mint_tpu.train import schedules as jax_schedules
from mint_tpu_torch.config.serialize import pipeline_to_text
from mint_tpu_torch.models import weights
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.tools import convert_checkpoint as cc
from mint_tpu_torch.train import CheckpointManager
from test_torch_train import _cli, _rows, tiny_pipeline_config, write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import convert_orbax_to_torch  # noqa: E402


def _jax_and_port(cfg):
    """(JAX model, params as numpy, the port's model with those weights)
    for a JAX MultiModalModelConfig."""
    jax_model = jax_build(cfg, is_training=False)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_model, jax.random.PRNGKey(3)))
    model = FACT(cfg.fact_model).eval()
    model.load_state_dict(weights.from_jax_params(params, model))
    return jax_model, params, model


def _forward_close(model, jax_model, params, rng):
    inputs = {"motion_input": rng.standard_normal(
                  (2, model.motion_seq_length, model.motion_dim), np.float32),
              "audio_input": rng.standard_normal(
                  (2, model.audio_seq_length, 35), np.float32)}
    want = np.asarray(jax_model.apply(
        params, {k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- the reference TF checkpoint ------------------------------------------------

def test_name_map_equals_jax_on_every_leaf():
    """The port's TF name of each of a 2-block model's leaves maps back to
    its Flax path, by the port's map and by the JAX converter's."""
    cfg = _tiny_jax_config()
    _, params, model = _jax_and_port(cfg)
    paths = weights._flatten(params["params"])
    assert len(paths) == len(weights._leaf_names(model))
    for path in paths:
        key = cc._tf_key_for(path.split("/"))
        assert cc._flax_key_for(key) == tuple(path.split("/")), key
        assert jax_convert._flax_key_for(key) == tuple(path.split("/"))
    for bad in ("optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE",
                "model/motion_linear_embedding/net/kernel",
                "model/foo/.ATTRIBUTES/VARIABLE_VALUE"):
        with pytest.raises(KeyError):
            cc._flax_key_for(bad)
        with pytest.raises(KeyError):
            jax_convert._flax_key_for(bad)


def _tiny_jax_config():
    import copy

    cfg = copy.deepcopy(jax_load_config(os.path.join(
        REPO, "configs", "fact_v5_deeper_t10_cm12.config")).multi_modal_model)
    fact = cfg.fact_model
    for mod in fact.modality:
        t = mod.model[0].transformer
        t.hidden_size, t.num_hidden_layers = 16, 2
        t.num_attention_heads, t.intermediate_size = 2, 24
    fact.modality_by_name("motion").sequence_length = 6
    fact.modality_by_name("motion").feature_dim = 225
    fact.modality_by_name("audio").sequence_length = 10
    cm = fact.cross_modal_model.transformer
    cm.hidden_size, cm.num_hidden_layers = 16, 2
    cm.num_attention_heads, cm.intermediate_size = 2, 24
    return cfg


def test_pure_converter_needs_no_tensorflow(tmp_path, monkeypatch):
    """Without tensorflow: the TF-named weights convert to the model's
    own state bit for bit, optimizer and foreign keys are reported, a
    missing leaf or a wrong shape raises, and reading a checkpoint raises
    a clear ImportError.  The written checkpoint serves as it is."""
    # As if tensorflow were not installed, also where another test of this
    # process has imported it (its submodules are cached).
    for name in [n for n in sys.modules
                 if n == "tensorflow" or n.startswith("tensorflow.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    cfg = _tiny_jax_config()
    jax_model, params, model = _jax_and_port(cfg)
    tf_vars = cc.tf_variables_of(model)
    extra = cc._tf_key_for(["motion_transformer", "block_7", "norm_mlp",
                            "scale"])
    tf_vars.update({"optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE":
                    np.zeros(()), extra: np.zeros(16, np.float32)})
    state, report = cc.convert_tf_variables(tf_vars, model)
    assert report == {"optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE":
                      "unmapped", extra: "extra (not in model)"}
    own = model.state_dict()
    assert set(state) == set(own)
    for k in own:
        assert torch.equal(state[k], own[k]), k

    cc.write_checkpoint(state, str(tmp_path / "run"))
    served = FACT(cfg.fact_model).eval()
    served.load_state_dict(CheckpointManager(str(tmp_path / "run"))
                           .restore_params(served.state_dict()))
    assert os.path.exists(tmp_path / "run" / "0" / "params.pt")
    _forward_close(served, jax_model, params, np.random.default_rng(0))

    missing = dict(tf_vars)
    del missing[cc._tf_key_for(["cross_modal_layer", "cross_output_layer",
                                "kernel"])]
    with pytest.raises(ValueError, match="missing"):
        cc.convert_tf_variables(missing, model)
    bad = dict(tf_vars)
    bad[cc._tf_key_for(["cross_modal_layer", "cross_output_layer",
                        "kernel"])] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        cc.convert_tf_variables(bad, model)
    with pytest.raises(ImportError, match="tensorflow is required"):
        cc.load_tf_variables(str(tmp_path / "ckpt"))


def test_tf_checkpoint_converts_as_the_jax_converter_does(tmp_path):
    """A synthetic TF2 checkpoint with the reference's object paths (built
    as tests/test_convert_checkpoint.py builds it): the port's converter
    gives the JAX converter's parameters, leaf for leaf and bit for bit,
    and the port's forward from them the JAX forward."""
    tf = pytest.importorskip("tensorflow")
    import test_convert_checkpoint as tcc

    cfg = tcc.tiny_pipeline()
    jax_model = jax_build(cfg, is_training=False)
    template = jax_init_params(jax_model, jax.random.PRNGKey(0))
    leaves = {"/".join(getattr(k, "key", str(k)) for k in kp): v
              for kp, v in jax.tree_util.tree_flatten_with_path(template)[0]}
    prefix = tf.train.Checkpoint(model=tcc._build_tf_like_fact(leaves)) \
        .save(str(tmp_path / "ckpt"))
    jax_params, jax_report = jax_convert.convert_tf_checkpoint(prefix,
                                                               template)
    model = FACT(cfg.fact_model).eval()
    tf_vars = cc.load_tf_variables(prefix)
    for key in tf_vars:
        assert cc._flax_key_for(key) == jax_convert._flax_key_for(key)
    state, report = cc.convert_tf_checkpoint(prefix, model)
    assert report == {k: v for k, v in jax_report.items()
                      if k.startswith("model/")}
    want = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params), model)
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    model.load_state_dict(state)
    _forward_close(model, jax_model, jax_params, np.random.default_rng(1))


# -- the JAX trainer's Orbax checkpoints ---------------------------------------

@pytest.fixture
def jax_run(tmp_path):
    """The port's tiny train config and corpus, and a JAX trainer's Orbax
    checkpoint of 3 steps on that config (make_mesh(2, 1), batch 8)."""
    write_corpus(str(tmp_path / "data"))
    pipeline = tiny_pipeline_config(str(tmp_path / "data" /
                                        "*_tfrecord-train*"))
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(pipeline))
    jax_cfg = jax_load_config(str(cfg_path))
    return tmp_path, str(cfg_path), jax_cfg


def _jax_train(jax_cfg, directory, steps=3, **kw):
    jax_model = jax_build(jax_cfg.multi_modal_model, is_training=True)
    params = jax_init_params(jax_model, jax.random.PRNGKey(4))
    trainer = JaxTrainer(jax_model, jax_schedules.constant(1e-3),
                         mesh=make_mesh(2, 1, devices=jax.devices()[:2]),
                         **kw)
    state = trainer.init_state(params)
    rng = np.random.default_rng(2)
    batch = {"motion_input": rng.standard_normal((8, 8, 225), np.float32),
             "audio_input": rng.standard_normal((8, 16, 35), np.float32),
             "target": rng.standard_normal((8, 2, 225), np.float32)}
    for _ in range(steps):
        state, _ = trainer.train_step(state, trainer.shard_batch(batch))
    manager = JaxCheckpointManager(str(directory), save_interval_steps=1)
    assert manager.save(steps, state)
    manager.wait_until_finished()
    manager.close()
    return jax_model, state


@pytest.mark.parametrize("kw", [{}, {"accumulate_steps": 2,
                                     "grad_clip_norm": 1.0}],
                         ids=["adam", "multisteps_clip"])
def test_orbax_checkpoint_converts_with_its_optimizer_state(jax_run, kw):
    """The converted step, parameters and Adam state (and MultiSteps'
    micro-step and accumulator) equal the JAX trainer's bit for bit, and
    the restored port model's forward is the JAX forward."""
    tmp_path, cfg_path, jax_cfg = jax_run
    jax_model, state = _jax_train(jax_cfg, tmp_path / "jax", **kw)
    convert_orbax_to_torch.main([f"--orbax_dir={tmp_path / 'jax'}",
                                 f"--config_path={cfg_path}",
                                 f"--output_dir={tmp_path / 'port'}"])
    model = cc.template_model(cfg_path).eval()
    path = tmp_path / "port" / "3"
    params = torch.load(path / "params.pt", weights_only=True)
    rest = torch.load(path / "opt_state.pt", weights_only=True)
    assert rest["step"] == 3

    def port(tree):
        return weights.from_jax_params(
            jax.tree_util.tree_map(np.asarray, tree), model)

    opt = state.opt_state
    if kw:  # MultiSteps: 3 micro-batches of 2 = one update, one pending
        adam = opt.inner_opt_state[1]
        assert rest["opt_state"]["mini_step"] == int(opt.mini_step) == 1
        pairs = [("acc", opt.acc_grads)]
    else:
        adam = opt[0]
        pairs = []
    assert rest["opt_state"]["count"] == int(adam.count)
    pairs += [("mu", adam.mu), ("nu", adam.nu)]
    for name, tree in [("params", state.params)] + pairs:
        got = params if name == "params" else rest["opt_state"][name]
        want = port(tree)
        assert set(got) == set(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    model.load_state_dict(params)
    _forward_close(model, jax_model, jax.tree_util.tree_map(
        np.asarray, state.params), np.random.default_rng(3))


def test_train_cli_resumes_a_jax_run(jax_run):
    """The port's train CLI, pointed at the converted checkpoint, resumes
    at the JAX step and trains on to its budget."""
    tmp_path, cfg_path, jax_cfg = jax_run
    _jax_train(jax_cfg, tmp_path / "jax")
    model_dir = str(tmp_path / "port")
    convert_orbax_to_torch.main([f"--orbax_dir={tmp_path / 'jax'}",
                                 f"--config_path={cfg_path}",
                                 f"--output_dir={model_dir}"])
    converted = torch.load(os.path.join(model_dir, "3", "params.pt"),
                           weights_only=True)
    _cli(cfg_path, model_dir, 5)
    assert [r["step"] for r in _rows(model_dir)] == [5]
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps == [3, 5]
    trained = torch.load(os.path.join(model_dir, "5", "params.pt"),
                         weights_only=True)
    assert any(not torch.equal(trained[k], converted[k]) for k in trained)
