"""The port's generation evaluator (``mint_tpu_torch/eval/evaluator.py``)
against ``mint_tpu.eval.evaluator.Evaluator`` on identical weights, the
JAX evaluator's own cases on the port, and the port's evaluate CLI (CPU,
f32: the kernels' plain versions run)."""

import copy
import json
import logging
import os

import numpy as np
import pytest
import torch

from mint_tpu.eval.evaluator import Evaluator as JaxEvaluator
from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.config.serialize import pipeline_to_text
from mint_tpu_torch.data.example import encode_example
from mint_tpu_torch.data.tfrecord import TFRecordWriter
from mint_tpu_torch.eval import evaluator as ev_lib
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models import builder
from mint_tpu_torch.models.fact import init_params
from mint_tpu_torch.tools import evaluate as evaluate_cli
from mint_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_train import CONFIG, _cli as train, tiny_pipeline_config
from test_torch_train import write_corpus
from test_torch_weights import paired, tiny_config

RNG = np.random.default_rng(13)


def _clips(n_clips, audio_len, motion_dim, motion_seq, name="motion"):
    """One-clip batches as the eval pipeline yields them (eval batch 1)."""
    for i in range(n_clips):
        yield {
            "motion_input": RNG.standard_normal(
                (1, motion_seq, motion_dim)).astype(np.float32),
            "audio_input": RNG.standard_normal(
                (1, audio_len, 35)).astype(np.float32),
            "motion_name": [f"{name}{i}".encode()],
            "audio_name": [f"audio{i}".encode()],
        }


def _named(batch, name):
    return dict(batch, motion_name=[name.encode()])


# -- against the JAX evaluator ------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return paired(tiny_config(), seed=6)


def test_saved_clips_match_jax_evaluator(pair, tmp_path, caplog):
    """Three buckets at steps_bucket=8 (true lengths 5; 9; 20, 22, 24),
    the last a partial batch padded to 4, and one clip too short for a
    window: the same files, shapes and frames (the decoder's tolerance
    over at most 24 steps)."""
    jax_model, params, model = pair
    audio_seq = model.audio_seq_length
    data = []
    for i, n in enumerate((24, 5, 20, 9, 22, -3)):
        batch = next(_clips(1, n + audio_seq - 1, model.motion_dim,
                            model.motion_seq_length))
        data.append(_named(batch, f"clip{i}"))
    kw = dict(steps=24, steps_bucket=8, decode_batch=4)
    JaxEvaluator(jax_model, data, output_dir=str(tmp_path / "jax"),
                 **kw).evaluate(params)
    with caplog.at_level(logging.WARNING, logger=ev_lib.__name__):
        Evaluator(model, data, output_dir=str(tmp_path / "port"),
                  **kw).evaluate()
    assert "skipping 1 clip(s)" in caplog.text and "clip5" in caplog.text
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert len(files) == 5
    for f in files:
        want = np.load(tmp_path / "jax" / f)
        got = np.load(tmp_path / "port" / f)
        assert got.dtype == np.float32 and got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                   err_msg=f)


def test_restored_params_are_loaded_for_the_pass(pair, tmp_path):
    """evaluate(params) decodes with those parameters, not the model's."""
    _, _, model = pair
    other = copy.deepcopy(model)
    init_params(other, torch.Generator().manual_seed(9))
    data = list(_clips(1, 20, model.motion_dim, model.motion_seq_length))
    Evaluator(copy.deepcopy(model), data, output_dir=str(tmp_path / "a"),
              steps=4).evaluate(other.state_dict())
    Evaluator(other, data, output_dir=str(tmp_path / "b"),
              steps=4).evaluate()
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "motion0_audio0.npy"),
                                  np.load(tmp_path / "b" / "motion0_audio0.npy"))


# -- the JAX evaluator's cases (tests/test_tools.py), on the port ------------

@pytest.fixture(scope="module")
def tiny_model():
    """tests/test_tools.py's tiny model: the flagship config at width 32,
    one block per transformer, 225-dim motion, windows of 12 / 24."""
    cfg = copy.deepcopy(load_pipeline_config(CONFIG).multi_modal_model)
    fact = cfg.fact_model
    for tf in [m.model[0].transformer for m in fact.modality] + [
            fact.cross_modal_model.transformer]:
        tf.hidden_size, tf.num_hidden_layers = 32, 1
        tf.num_attention_heads, tf.intermediate_size = 2, 64
    fact.modality_by_name("motion").sequence_length = 12
    fact.modality_by_name("motion").feature_dim = 225
    fact.modality_by_name("audio").sequence_length = 24
    model = builder.build(cfg, is_training=False, device="cpu")
    return init_params(model, torch.Generator().manual_seed(1))


def _dataset(n_clips=3, audio_len=40):
    return _clips(n_clips, audio_len, 225, 12)


def test_generates_and_saves_clips(tiny_model, tmp_path):
    ev = Evaluator(tiny_model, _dataset(), output_dir=str(tmp_path),
                   steps=10)
    assert ev.decode_batch == ev_lib.DECODE_BATCH
    assert ev.evaluate() == {}
    files = sorted(os.listdir(tmp_path))
    assert files == [f"motion{i}_audio{i}.npy" for i in range(3)]
    out = np.load(tmp_path / files[0])
    assert out.shape == (12 + 10, 225)  # seed + generated
    with pytest.raises(ValueError, match="decode_batch"):
        Evaluator(tiny_model, _dataset(), decode_batch=-1)


def test_protocol_clamps_to_audio_length(tiny_model, tmp_path):
    # audio 30 frames, window 24 -> the reference generates 7 frames.
    Evaluator(tiny_model, _dataset(n_clips=1, audio_len=30),
              output_dir=str(tmp_path), steps=1200).evaluate()
    assert np.load(tmp_path / "motion0_audio0.npy").shape == (12 + 7, 225)


def test_buckets_mixed_lengths(tiny_model, tmp_path):
    def mixed():
        yield from _dataset(n_clips=1, audio_len=30)           # 7 frames
        for batch in _dataset(n_clips=1, audio_len=40):
            yield _named(batch, "long")                        # 17 frames

    Evaluator(tiny_model, mixed(), output_dir=str(tmp_path),
              steps=1200).evaluate()
    assert np.load(tmp_path / "motion0_audio0.npy").shape[0] == 19
    assert np.load(tmp_path / "long_audio0.npy").shape[0] == 29


def test_partial_batch_pads_to_a_power_of_two(tiny_model, tmp_path,
                                              monkeypatch):
    """3 clips in one bucket at decode_batch 8 decode as a batch of 4 (the
    last clip repeated), and the pad clip is never saved."""
    seen = []
    real = decoder.infer_auto_regressive

    def spy(model, inputs, **kw):
        seen.append(inputs["motion_input"].shape[0])
        return real(model, inputs, **kw)

    monkeypatch.setattr(ev_lib.decoder, "infer_auto_regressive", spy)
    Evaluator(tiny_model, list(_dataset(n_clips=3)),
              output_dir=str(tmp_path), steps=5, decode_batch=8).evaluate()
    assert seen == [4]
    assert len(os.listdir(tmp_path)) == 3


def test_callable_corpus_cached_across_passes(tiny_model, tmp_path):
    calls = []

    def factory():
        calls.append(1)
        return _dataset(n_clips=2)

    ev = Evaluator(tiny_model, factory, output_dir=str(tmp_path / "a"),
                   steps=5)
    ev.evaluate()
    ev.evaluate()
    assert len(calls) == 1  # cached after the first pass
    assert len(os.listdir(tmp_path / "a")) == 2

    calls.clear()
    ev = Evaluator(tiny_model, factory, output_dir=str(tmp_path / "b"),
                   steps=5, cache_examples=False)
    ev.evaluate()
    ev.evaluate()
    assert len(calls) == 2  # the factory is called again every pass


def test_reiterable_honors_cache_opt_out(tiny_model, tmp_path):
    data = list(_dataset(n_clips=1))
    ev = Evaluator(tiny_model, data, output_dir=str(tmp_path / "grow"),
                   steps=5, cache_examples=False)
    ev.evaluate()
    data.extend(_dataset(n_clips=2))  # the corpus grew: clips 0, 1
    ev.evaluate()
    assert len(os.listdir(tmp_path / "grow")) == 2

    it = _dataset(n_clips=2)  # a generator: one-shot
    ev = Evaluator(tiny_model, it, output_dir=str(tmp_path / "oneshot"),
                   steps=5, cache_examples=False)
    ev.evaluate()
    ev.evaluate()  # reuses the cache, not an empty second drain
    assert len(os.listdir(tmp_path / "oneshot")) == 2


def test_steps_bucket_quantization_is_exact(tiny_model, tmp_path):
    """Zero-padded audio tails and per-clip trimming: every saved clip is
    IDENTICAL to the unbucketed run's (kept frames never read padding)."""
    data = []
    # True lengths 7, 12, 17 -> buckets {10: [7], 20: [12, 17]}.
    for j, alen in enumerate((30, 35, 40)):
        data += [_named(b, f"clip{j}")
                 for b in _dataset(n_clips=1, audio_len=alen)]
    # decode_batch=1 in both runs: batch composition changes the
    # summation order, which is not what this test pins.
    Evaluator(tiny_model, data, output_dir=str(tmp_path / "exact"),
              steps=1200, decode_batch=1).evaluate()
    Evaluator(tiny_model, data, output_dir=str(tmp_path / "bucketed"),
              steps=1200, steps_bucket=10, decode_batch=1).evaluate()
    files = sorted(os.listdir(tmp_path / "exact"))
    assert files == sorted(os.listdir(tmp_path / "bucketed"))
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "exact" / f),
                                      np.load(tmp_path / "bucketed" / f),
                                      err_msg=f)


def test_metrics_invariant_to_bucketing_and_batching(tiny_model):
    class LastFrameMean:
        name = "last_frame_mean"

        def __init__(self):
            self.total = 0.0

        def reset_states(self):
            self.total = 0.0

        def update_state(self, inputs, outputs):
            self.total += float(np.mean(outputs[:, -1]))

        def result(self):
            return self.total

    data = []
    for j, alen in enumerate((30, 35, 40, 35)):
        data += [_named(b, f"c{j}")
                 for b in _dataset(n_clips=1, audio_len=alen)]
    results = []
    for kwargs in ({"decode_batch": 1}, {"decode_batch": 4},
                   {"decode_batch": 4, "steps_bucket": 10}):
        m = LastFrameMean()
        Evaluator(tiny_model, data, metrics=[m], steps=1200,
                  **kwargs).evaluate()
        results.append(m.result())
    assert results[0] == pytest.approx(results[1], rel=1e-5)
    assert results[0] == pytest.approx(results[2], rel=1e-5)


# -- the evaluate CLI ---------------------------------------------------------

def _eval_corpus(directory, lengths, seed=1):
    """AIST-shaped eval sequences (219-dim motion, 35-dim audio of the
    given lengths) as tfrecords named like ``*_tfrecord-testval*``."""
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "aist_tfrecord-testval-00000-of-00001")
    with TFRecordWriter(path) as w:
        for s, n in enumerate(lengths):
            motion = rng.standard_normal((20, 219)).astype(np.float32)
            audio = rng.standard_normal((n, 35)).astype(np.float32)
            w.write(encode_example({
                "motion_sequence": motion.ravel(),
                "motion_sequence_shape": np.asarray(motion.shape, np.int64),
                "motion_name": [f"gBR_sBM_cAll_d04_mBR{s}_ch0{s}"],
                "audio_sequence": audio.ravel(),
                "audio_sequence_shape": np.asarray(audio.shape, np.int64),
                "audio_name": [f"mBR{s}"],
            }))


@pytest.fixture
def eval_setup(tmp_path):
    """A 2-step checkpoint of the tiny pipeline from the port's train CLI,
    and an eval corpus: clips of 6 and 11 generatable frames, and one too
    short for a window (audio 10 < 16)."""
    data = tmp_path / "data"
    data.mkdir()
    write_corpus(str(data))
    _eval_corpus(str(data), (21, 26, 10))
    pipe = tiny_pipeline_config(str(data / "*_tfrecord-train*"))
    pipe.eval_dataset.input_length_sec = 8  # the seed: 8 motion frames
    pipe.eval_dataset.data_files = str(data / "*_tfrecord-testval*")
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(pipe))
    model_dir = tmp_path / "run"
    train(str(cfg_path), str(model_dir), 2)
    return tmp_path, str(cfg_path), str(model_dir)


def _evaluate(cfg_path, model_dir, out_dir, *extra):
    return evaluate_cli.main([
        f"--config_path={cfg_path}", f"--model_dir={model_dir}",
        f"--output_dir={out_dir}", "--steps=30", "--timeout=0.3",
        "--poll_seconds=0.05", "--device=cpu", *extra])


def test_evaluate_cli_decodes_the_latest_checkpoint(eval_setup):
    tmp_path, cfg_path, model_dir = eval_setup
    out_dir = tmp_path / "outputs"
    _evaluate(cfg_path, model_dir, out_dir, "--steps_bucket=8")
    files = sorted(os.listdir(out_dir))
    assert files == ["gBR_sBM_cAll_d04_mBR0_ch00_mBR0.npy",
                     "gBR_sBM_cAll_d04_mBR1_ch01_mBR1.npy"]
    # The frames of a model holding the checkpoint's parameters.
    pipe = load_pipeline_config(cfg_path)
    model = builder.build(pipe.multi_modal_model, is_training=False,
                          device="cpu")
    model.load_state_dict(CheckpointManager(model_dir).restore_params(
        model.state_dict()))
    want_dir = tmp_path / "want"
    from mint_tpu_torch.data import pipeline as data_pipeline
    Evaluator(model, list(data_pipeline.create_input(
        pipe.eval_config, pipe.eval_dataset, is_training=False,
        use_tpu=False)), output_dir=str(want_dir), steps=30).evaluate()
    for f, n in zip(files, (6, 11)):
        got = np.load(out_dir / f)
        assert got.shape == (8 + n, 225) and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.load(want_dir / f), rtol=1e-5,
                                   atol=1e-6)
    # One summary line for the one checkpoint (step 2).
    with open(os.path.join(model_dir, "valid", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [2]


def test_evaluate_cli_bf16(eval_setup):
    """--use_bfloat16 decodes in the whole-model bf16 cast (LayerNorm f32)
    and saves f32 clips near the f32 ones."""
    tmp_path, cfg_path, model_dir = eval_setup
    _evaluate(cfg_path, model_dir, tmp_path / "f32")
    _evaluate(cfg_path, model_dir, tmp_path / "bf16", "--use_bfloat16")
    for f in sorted(os.listdir(tmp_path / "f32")):
        a = np.load(tmp_path / "f32" / f)
        b = np.load(tmp_path / "bf16" / f)
        assert b.dtype == np.float32 and b.shape == a.shape
        assert np.abs(a - b).max() < 0.1 * max(1.0, np.abs(a).max())


def test_evaluate_cli_defaults_to_the_card(eval_setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tmp_path, cfg_path, model_dir = eval_setup
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_cli.main([f"--config_path={cfg_path}",
                           f"--model_dir={model_dir}",
                           f"--output_dir={tmp_path / 'card'}",
                           "--timeout=0.1"])
    assert not os.path.exists(tmp_path / "card")
