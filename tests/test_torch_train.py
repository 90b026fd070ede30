"""The port's training path (mint_tpu_torch/train, tools/train.py and the
ops' autograd Functions) against the JAX package's, on the CPU.

The JAX Trainer runs on the 8-device CPU mesh of conftest.py, so batches
are 8.  Both sides start from the same weights (the JAX initialisation
through ``models/weights.py``) and numpy-seeded batches.  Tolerances:
f32 losses within 1e-5 relative and parameters within 1e-5 absolute (the
two frameworks sum in different orders; Adam normalises each update, so
the error does not grow with the rate); bf16 losses within 2e-2 relative
(the two round to bf16 at slightly different points: the JAX model's GELU
runs in bf16, the port's in f32 as the kernel does).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from mint_tpu.models.fact import FACT as JaxFACT
from mint_tpu.models.fact import init_params as jax_init_params
from mint_tpu.ops import attention as jax_attention
from mint_tpu.ops import mlp as jax_mlp
from mint_tpu.parallel import make_mesh
from mint_tpu.train import Trainer as JaxTrainer
from mint_tpu.train import schedules as jax_schedules
from mint_tpu_torch.config import schema as S
from mint_tpu_torch.config.serialize import pipeline_to_text
from mint_tpu_torch.data.example import encode_example
from mint_tpu_torch.data.prefetch import to_device
from mint_tpu_torch.data.tfrecord import TFRecordWriter
from mint_tpu_torch.models import builder, weights
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.ops import attention as att
from mint_tpu_torch.ops import mlp
from mint_tpu_torch.tools import train as train_cli
from mint_tpu_torch.train import Trainer, schedules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
SCALE = 800 ** -0.5


# -- the ops' autograd Functions ---------------------------------------------

def _kernel_like_attention(q, k, v, scale):
    """The plain version, returned as the CUDA kernel returns its result:
    a [B, H, Nq, D] view of new [B, Nq, H, D] storage."""
    b, h, nq, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype).transpose(1, 2)
    out.copy_(att.attention_reference(q, k, v, scale))
    return out


def _fused_qkv(rng, b, n, h, d, dtype=torch.float32):
    """q, k, v as the model makes them: strided views of one fused QKV
    output [B, N, 3, H, D] (a leaf that requires grad)."""
    buf = torch.tensor(rng.standard_normal((b, n, 3, h, d)),
                       dtype=dtype, requires_grad=True)
    q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
    return buf, q, k, v


def test_attention_function_grads_equal_plain_autograd():
    """Through AttentionFunction (forward: the kernel's output layout)
    the gradients equal plain autograd's through attention_reference (in
    f32 the formula the backward differentiates is the same function), the
    inputs are saved uncopied, and the head merge after it is a view."""
    rng = np.random.default_rng(0)
    buf, q, k, v = _fused_qkv(rng, 2, 24, 4, 16)
    out = att.AttentionFunction.apply(q, k, v, SCALE, _kernel_like_attention)
    saved = out.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in (q, k, v)]
    assert out.transpose(1, 2).is_contiguous()
    cot = torch.tensor(rng.standard_normal(out.shape), dtype=torch.float32)
    merged = out.transpose(1, 2).reshape(2, 24, 64)
    (merged * cot.transpose(1, 2).reshape(2, 24, 64)).sum().backward()
    got = buf.grad.clone()

    buf.grad = None
    ref = att.attention_reference(*buf.permute(2, 0, 3, 1, 4).unbind(0),
                                  SCALE)
    (ref * cot).sum().backward()
    np.testing.assert_allclose(got.numpy(), buf.grad.numpy(), atol=1e-6)


def test_mlp_function_grads_equal_plain_autograd():
    """Through MLPFunction the gradients of x and of nn.Linear weights
    passed as .t() views equal plain autograd's through mlp_reference;
    the views are saved uncopied."""
    torch.manual_seed(0)
    fc1, fc2 = torch.nn.Linear(32, 64), torch.nn.Linear(64, 32)
    x = torch.randn(10, 32, requires_grad=True)
    args = (x, fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias)
    out = mlp.MLPFunction.apply(*args, mlp.mlp_reference)
    saved = out.grad_fn.saved_tensors
    assert saved[1].data_ptr() == fc1.weight.data_ptr()
    assert saved[3].data_ptr() == fc2.weight.data_ptr()
    cot = torch.randn(out.shape)
    leaves = (x, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    got = torch.autograd.grad((out * cot).sum(), leaves)
    want = torch.autograd.grad((mlp.mlp_reference(*args) * cot).sum(),
                               leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


def test_functions_pass_gradcheck_f64():
    """In f64, with the formula the backward differentiates as the
    forward (the plain versions compute in f32)."""
    rng = np.random.default_rng(1)
    qkv = [torch.tensor(rng.standard_normal((1, 2, n, 8)),
                        dtype=torch.float64, requires_grad=True)
           for n in (5, 7, 7)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: att.AttentionFunction.apply(
            q, k, v, 0.3, att.attention_formula), qkv)
    args = [torch.tensor(rng.standard_normal(s) * 0.5, dtype=torch.float64,
                         requires_grad=True)
            for s in ((3, 8), (8, 16), (16,), (16, 8), (8,))]
    assert torch.autograd.gradcheck(
        lambda *a: mlp.MLPFunction.apply(*a, mlp.mlp_formula), args)


def test_attention_function_grads_match_jax_pallas():
    """Gradients within 1e-5 of jax.grad through pallas_attention (its
    custom VJP; interpret mode on the CPU), in f32."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 10, 36, 80)).astype(np.float32)
               for _ in range(3))
    cot = rng.standard_normal((2, 10, 36, 80)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(
        jax_attention.pallas_attention(a, b, c, SCALE) * cot),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = att.AttentionFunction.apply(tq, tk, tv, SCALE,
                                      _kernel_like_attention)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_mlp_function_grads_match_jax_fused_mlp(monkeypatch):
    """Gradients within 1e-5 of jax.grad through fused_mlp (its custom
    VJP; the Pallas kernel in interpret mode), in f32."""
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.1
              for s in ((40, 64), (64, 256), (256,), (256, 64), (64,))]
    cot = rng.standard_normal((40, 64)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_mlp.fused_mlp(*a) * cot),
                    argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = mlp.MLPFunction.apply(*leaves, mlp.mlp_reference)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _bf16_close(got, want):
    """Within 2% of the gradient's peak: both sides run the same bf16
    formula, but the two frameworks round the GEMM outputs and the GELU's
    steps to bf16 at different points (each rounding ~0.4%), and the
    backward chains several of them."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_functions_bf16_grads_match_jax():
    """In bf16 the backward differentiates the JAX VJP's own formulas
    (xla_attention, _reference_mlp) in bf16, as XLA does: the gradients
    follow jax.grad through pallas_attention and fused_mlp in bf16."""
    rng = np.random.default_rng(5)
    q, k, v, cot = (rng.standard_normal((1, 10, 40, 80)).astype(np.float32)
                    for _ in range(4))
    want = jax.grad(lambda a, b, c: jnp.sum(
        jax_attention.pallas_attention(a, b, c, SCALE).astype(jnp.float32)
        * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    leaves = [torch.tensor(t).bfloat16().requires_grad_() for t in (q, k, v)]
    out = att.AttentionFunction.apply(*leaves, SCALE, _kernel_like_attention)
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                              leaves)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, w)

    arrays = [rng.standard_normal(s).astype(np.float32) * 0.1
              for s in ((40, 64), (64, 256), (256,), (256, 64), (64,))]
    cot = rng.standard_normal((40, 64)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(
        jax_mlp.fused_mlp(*a).astype(jnp.float32) * cot),
        argnums=tuple(range(5)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in arrays]
    out = mlp.MLPFunction.apply(*leaves, mlp.mlp_reference)
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                              leaves)
    for g, w in zip(got, want):
        _bf16_close(g, w)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_off_cpu_the_function_is_taken_only_for_gradients(grad_mode,
                                                          monkeypatch):
    """Off the CPU both wrappers launch the kernel, inside their Function
    only when a gradient is wanted: under no_grad (the decode) the launch
    is direct and its result has no grad_fn.  (A stand-in launch on meta
    tensors plays the kernel here.)"""
    calls = []

    def fake_attention(q, k, v, scale):
        calls.append("attention")
        return torch.empty_like(q)

    def fake_mlp(x, w1, b1, w2, b2):
        calls.append("mlp")
        return x.new_empty((x.shape[0], w2.shape[1]))

    monkeypatch.setattr(att, "_launch", fake_attention)
    monkeypatch.setattr(mlp, "_launch", fake_mlp)
    q = torch.empty(1, 2, 4, 8, device="meta", requires_grad=True)
    x = torch.empty(3, 4, 8, device="meta", requires_grad=True)
    w1, b1 = torch.empty(8, 16, device="meta"), torch.empty(16, device="meta")
    w2, b2 = torch.empty(16, 8, device="meta"), torch.empty(8, device="meta")
    with torch.set_grad_enabled(grad_mode):
        a = att.attention(q, q, q, 0.5)
        m = mlp.fused_mlp(x, w1, b1, w2, b2)
    assert calls == ["attention", "mlp"]
    assert m.shape == (3, 4, 8)
    if grad_mode:
        assert type(a.grad_fn).__name__ == "AttentionFunctionBackward"
        assert "MLPFunctionBackward" in str(m.grad_fn.next_functions)
    else:
        assert a.grad_fn is None and m.grad_fn is None


# -- schedules ---------------------------------------------------------------

def _schedule_pairs():
    lr = S.LearningRateConfig
    manual = S.ManualStepLearningRate(
        initial_learning_rate=1e-4,
        schedule=[S.ManualStepSchedule(step=100, learning_rate=1e-5),
                  S.ManualStepSchedule(step=150, learning_rate=1e-6)])
    manual_warm = copy.deepcopy(manual)
    manual_warm.warmup = True
    return [
        ("manual", lr(manual_step_learning_rate=manual), {},
         [0, 1, 99, 100, 101, 149, 150, 151, 10**6]),
        ("manual_warmup", lr(manual_step_learning_rate=manual_warm), {},
         [0, 1, 7, 50, 99, 100, 101, 149, 150, 151]),
        ("polynomial_warmup", lr(
            exponential_decay_learning_rate=S.ExponentialDecayLearningRate(
                initial_learning_rate=0.5, decay_steps=40,
                min_learning_rate=1e-4, decay_factor=2.0)),
         {"initial_learning_rate": 3e-3, "warmup_steps": 10},
         [0, 1, 9, 10, 11, 29, 49, 50, 51, 1000]),
        ("polynomial", lr(
            exponential_decay_learning_rate=S.ExponentialDecayLearningRate(
                initial_learning_rate=0.5, decay_steps=40,
                min_learning_rate=1e-4, decay_factor=1.0)),
         {}, [0, 1, 20, 39, 40, 41]),
        ("cosine_warmup", lr(cosine_decay_learning_rate=S.CosineDecayLearningRate(
            total_steps=100)),
         {"initial_learning_rate": 2e-3, "warmup_steps": 10},
         [0, 1, 8, 9, 10, 11, 50, 99, 100, 101]),
        ("constant", lr(constant_learning_rate=S.ConstantLearningRate(
            learning_rate=3e-4)), {}, [0, 1, 10**5]),
    ]


@pytest.mark.parametrize("name,cfg,kw,steps", _schedule_pairs(),
                         ids=[p[0] for p in _schedule_pairs()])
def test_schedules_equal_jax(name, cfg, kw, steps):
    """Every path of from_config (the exponential and cosine ones take
    their base rate from the flag) gives the JAX schedule's f32 value
    around each boundary: exactly, or within 4 f32 ulps on the cosine path
    (XLA's and numpy's cos round apart by an ulp, which the products after
    it carry)."""
    from mint_tpu.config import schema as JS

    jax_cfg = JS.LearningRateConfig(**{
        f: getattr(JS, type(v).__name__)(**{
            k: ([JS.ManualStepSchedule(**vars(s)) for s in x]
                if k == "schedule" else x) for k, x in vars(v).items()})
        for f, v in vars(cfg).items() if v is not None})
    got_sched = schedules.from_config(cfg, **kw)
    want_sched = jax_schedules.from_config(jax_cfg, **kw)
    for step in steps:
        got = got_sched(step)
        want = float(np.asarray(want_sched(step), np.float32))
        assert isinstance(got, float)
        if name == "cosine_warmup":
            assert got == pytest.approx(want, rel=2 ** -21, abs=0), step
        else:
            assert got == want, (name, step, got, want)


def test_schedule_validation():
    with pytest.raises(ValueError, match="strictly increasing"):
        schedules.manual_stepping([10, 5], [1.0, 0.5, 0.1])
    with pytest.raises(ValueError, match="exceed"):
        schedules.manual_stepping([10], [1.0])
    with pytest.raises(ValueError, match="First step cannot be zero"):
        schedules.manual_stepping([0, 5], [1.0, 0.5, 0.1])
    with pytest.raises(ValueError, match="Empty"):
        schedules.from_config(S.LearningRateConfig(
            manual_step_learning_rate=S.ManualStepLearningRate()))


# -- the trainer against the JAX trainer -----------------------------------

def _pair(compute_dtype=None):
    """(jax model, jax params, port model) on the tiny config with the same
    weights; the port's parameters are f32 whatever `compute_dtype`."""
    cfg = __graft_entry__._tiny_fact_config()
    jax_model = JaxFACT(cfg, compute_dtype=(
        jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32))
    params = jax_init_params(jax_model, jax.random.PRNGKey(0))
    model = FACT(cfg, compute_dtype=compute_dtype)
    model.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), model))
    return jax_model, params, model


def _batches(n, seed=0, b=8):
    rng = np.random.default_rng(seed)
    return [{"motion_input": rng.standard_normal((b, 8, 9)).astype(np.float32),
             "audio_input": rng.standard_normal((b, 16, 35)).astype(
                 np.float32),
             "target": rng.standard_normal((b, 4, 9)).astype(np.float32)}
            for _ in range(n)]


def _schedule(lib):
    # Warmup over the first 3 updates, so the rate moves from update to
    # update and a miscounted schedule step shows.
    return lib.manual_stepping([3], [1e-4, 1e-3], warmup=True)


def _run_both(batches, compute_dtype=None, **kw):
    jax_model, params, model = _pair(compute_dtype)
    jt = JaxTrainer(jax_model, _schedule(jax_schedules), mesh=make_mesh(8, 1),
                    **kw)
    js = jt.init_state(params)
    jax_metrics = []
    for b in batches:
        js, m = jt.train_step(js, jt.shard_batch(b))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    tr = Trainer(model, _schedule(schedules), **kw)
    ts = tr.init_state(model)
    metrics = []
    for b in batches:
        ts, m = tr.train_step(ts, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return (jax_metrics, jax.tree_util.tree_map(np.asarray, js.params),
            metrics, ts, model)


def _port_tree(model, state):
    model.load_state_dict(state.params)
    return weights.to_numpy_tree(model)


def _global_grad_norm(batch):
    _, _, model = _pair()
    tr = Trainer(model, schedules.constant(0.0))
    _, grads = tr.loss_and_grads(tr.init_state(model).params, batch)
    return float(torch.sqrt(sum((g * g).sum() for g in grads.values())))


CASES = {"plain": {}, "clip": {"grad_clip_norm": 0.05},
         "accumulate_2": {"accumulate_steps": 2},
         "accumulate_3": {"accumulate_steps": 3}}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_f32(case):
    """5 f32 steps on the tiny config: losses within 1e-5 relative,
    parameters within 1e-5 absolute, the learning_rate metric equal (with
    accumulation it is schedule(step // k))."""
    kw = CASES[case]
    batches = _batches(5)
    if "grad_clip_norm" in kw:  # the limit really clips
        assert _global_grad_norm(batches[0]) > 2 * kw["grad_clip_norm"]
    jax_metrics, jax_params, metrics, state, model = _run_both(batches, **kw)
    for got, want in zip(metrics, jax_metrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["total_loss"] == got["loss"] and got["reg_loss"] == 0.0
        assert got["learning_rate"] == want["learning_rate"]
    assert state.step == 5
    got = jax.tree_util.tree_leaves(_port_tree(model, state))
    want = jax.tree_util.tree_leaves(jax_params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_trainer_bf16_keeps_f32_state_and_matches_jax():
    """compute_dtype bf16: the forward runs in bf16 while the parameters,
    gradients and Adam moments stay f32; losses within 2e-2 relative of
    the JAX bf16 trainer's."""
    batches = _batches(5, seed=1)
    jax_metrics, _, metrics, state, model = _run_both(
        batches, compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for tree in (state.params, state.opt_state["mu"], state.opt_state["nu"]):
        assert all(t.dtype == torch.float32 for t in tree.values())
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batches[0].items()
                     if k != "target"})
    assert out.dtype == torch.bfloat16
    for got, want in zip(metrics, jax_metrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-2)


def test_accumulation_applies_every_k():
    _, _, model = _pair()
    tr = Trainer(model, schedules.constant(1e-2), accumulate_steps=2)
    state = tr.init_state(model)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = _batches(1)[0]
    state, _ = tr.train_step(state, batch)
    assert all(torch.equal(before[k], v) for k, v in state.params.items())
    state, _ = tr.train_step(state, batch)
    assert any(not torch.equal(before[k], v) for k, v in state.params.items())
    assert state.opt_state["count"] == 1 and state.opt_state["mini_step"] == 0


def test_train_steps_equals_looped_train_step():
    batches = _batches(4, seed=3)
    _, _, model = _pair()
    tr = Trainer(model, _schedule(schedules), grad_clip_norm=0.05)
    a = tr.init_state(model)
    for b in batches:
        a, metrics_a = tr.train_step(a, b)
    b_state = tr.init_state(model)
    b_state, metrics_b = tr.train_steps(b_state, tr.stack_batches(batches))
    assert b_state.step == a.step == 4
    assert float(metrics_a["loss"]) == float(metrics_b["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b_state.params[k]), k


def test_init_state_copies_the_callers_parameters():
    _, _, model = _pair()
    tr = Trainer(model, schedules.constant(1e-2))
    state = tr.init_state(model)
    own = dict(model.named_parameters())
    assert all(state.params[k].data_ptr() != p.data_ptr()
               for k, p in own.items())
    before = {k: p.detach().clone() for k, p in own.items()}
    tr.train_step(state, _batches(1)[0])
    assert all(torch.equal(before[k], p) for k, p in own.items())


def test_stack_batches_keeps_numeric_features():
    _, _, model = _pair()
    tr = Trainer(model, schedules.constant(1e-2))
    batches = [dict(b, motion_name=np.asarray(["a"] * 8))
               for b in _batches(2)]
    stacked = tr.stack_batches(batches)
    assert sorted(stacked) == ["audio_input", "motion_input", "target"]
    assert stacked["target"].shape == (2, 8, 4, 9)
    assert "motion_name" not in to_device(batches[0], "cpu")


# -- the train CLI -------------------------------------------------------------

def write_corpus(directory, n_seq=4, length=40, seed=0):
    """AIST-shaped sequences (219-dim motion, 35-dim audio) as tfrecords
    named like the config's ``*_tfrecord-train*``."""
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "aist_tfrecord-train-00000-of-00001")
    with TFRecordWriter(path) as w:
        for s in range(n_seq):
            motion = rng.standard_normal((length, 219)).astype(np.float32)
            audio = rng.standard_normal((length, 35)).astype(np.float32)
            w.write(encode_example({
                "motion_sequence": motion.ravel(),
                "motion_sequence_shape": np.asarray(motion.shape, np.int64),
                "motion_name": [f"m{s}"],
                "audio_sequence": audio.ravel(),
                "audio_sequence_shape": np.asarray(audio.shape, np.int64),
                "audio_name": [f"a{s}"],
            }))
    return path


def tiny_pipeline_config(data_glob):
    """The flagship pipeline cut down: 1 block of width 32 per transformer,
    windows of 8 motion / 16 audio frames, target 2 frames 8 ahead, batch
    8."""
    from mint_tpu_torch.config.schema import load_pipeline_config

    pipe = load_pipeline_config(CONFIG)
    fact = pipe.multi_modal_model.fact_model
    for tf in [m.model[0].transformer for m in fact.modality] + [
            fact.cross_modal_model.transformer]:
        tf.hidden_size, tf.num_hidden_layers = 32, 1
        tf.num_attention_heads, tf.intermediate_size = 2, 64
    fact.modality_by_name("motion").sequence_length = 8
    fact.modality_by_name("audio").sequence_length = 16
    ds = pipe.train_dataset
    ds.input_length_sec, ds.target_length_sec, ds.target_shift_sec = 8, 2, 8
    ds.data_files = data_glob
    pipe.train_config.batch_size = 8
    return pipe


@pytest.fixture
def cli_setup(tmp_path):
    write_corpus(str(tmp_path / "data"))
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(tiny_pipeline_config(
        str(tmp_path / "data" / "*_tfrecord-train*"))))
    return tmp_path, str(cfg_path)


def _cli(cfg_path, model_dir, steps, *extra):
    train_cli.main([f"--config_path={cfg_path}", f"--model_dir={model_dir}",
                    f"--steps={steps}", "--device=cpu", "--steps_per_loop=2",
                    "--checkpoint_interval=2", "--summary_interval=1",
                    *extra])


def _rows(model_dir):
    path = os.path.join(model_dir, "train", "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("backend", ["python", "device"])
def test_train_cli_trains_checkpoints_and_resumes(cli_setup, backend):
    tmp_path, cfg_path = cli_setup
    model_dir = str(tmp_path / "run")
    _cli(cfg_path, model_dir, 4, f"--input_backend={backend}")
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps == [1, 3, 4]  # train(1), then boundaries 3 and the end
    assert os.path.exists(os.path.join(model_dir, "pipeline.config"))
    rows = _rows(model_dir)
    assert [r["step"] for r in rows] == [1, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert {"loss", "total_loss", "reg_loss", "learning_rate"} <= set(rows[0])

    # A second invocation resumes from step 4 and runs to 7.
    _cli(cfg_path, model_dir, 7, f"--input_backend={backend}")
    rows = _rows(model_dir)
    assert [r["step"] for r in rows] == [1, 3, 4, 6, 7]
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps == [1, 3, 4, 6, 7]


def test_train_cli_bf16_keeps_f32_checkpoints(cli_setup):
    tmp_path, cfg_path = cli_setup
    model_dir = str(tmp_path / "bf16")
    _cli(cfg_path, model_dir, 2, "--use_bfloat16", "--accumulate_steps=2",
         "--grad_clip_norm=1.0")
    params = torch.load(os.path.join(model_dir, "2", "params.pt"))
    assert all(t.dtype == torch.float32 for t in params.values())
    assert all(np.isfinite(r["loss"]) for r in _rows(model_dir))


def test_train_cli_defaults_to_the_card(cli_setup):
    """Without --device the CLI trains on CUDA: with no card it raises
    before any step, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tmp_path, cfg_path = cli_setup
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main([f"--config_path={cfg_path}",
                        f"--model_dir={tmp_path / 'card'}", "--steps=1"])
    assert not os.path.exists(tmp_path / "card" / "1")


def test_cpu_build_with_compute_dtype_runs_the_plain_versions():
    """builder.build(compute_dtype=bf16) keeps f32 parameters; a
    whole-model bf16 cast of the same weights gives the same forward."""
    cfg = S.MultiModalModelConfig(fact_model=__graft_entry__._tiny_fact_config())
    mixed = builder.build(cfg, is_training=True, device="cpu",
                          compute_dtype=torch.bfloat16)
    init_params(mixed, torch.Generator().manual_seed(0))
    whole = builder.build(cfg, is_training=False, device="cpu",
                          dtype=torch.bfloat16)
    whole.load_state_dict(mixed.state_dict())
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    rng = np.random.default_rng(4)
    inputs = {"motion_input": torch.from_numpy(
        rng.standard_normal((2, 8, 9)).astype(np.float32)),
        "audio_input": torch.from_numpy(
            rng.standard_normal((2, 16, 35)).astype(np.float32))}
    with torch.no_grad():
        a, b = mixed(inputs), whole(inputs)
    assert a.dtype == b.dtype == torch.bfloat16
    # Same bf16 weights and inputs; the LayerNorms differ only in taking
    # their affine in f32 (Flax's cast point) or in bf16.
    assert (a.float() - b.float()).abs().max() <= 0.05 * max(
        1.0, b.float().abs().max())
