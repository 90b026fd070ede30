"""The port's AR decoder against ``mint_tpu.infer.decoder`` on identical
weights (CPU, f32), and against its own reference loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.infer import decoder as jax_decoder
from mint_tpu_torch.infer import decoder
from test_torch_weights import paired, tiny_config

STEPS = 24


@pytest.fixture(scope="module")
def pair():
    return paired(tiny_config(), seed=4)


def _inputs(model, b=2, steps=STEPS, slack=3, seed=0):
    rng = np.random.default_rng(seed)
    audio_len = steps + model.audio_seq_length - 1 + slack
    return {
        "motion_input": rng.standard_normal(
            (b, model.motion_seq_length, model.motion_dim)
        ).astype(np.float32) * 0.5,
        "audio_input": rng.standard_normal(
            (b, audio_len, model.audio_dim)).astype(np.float32) * 0.5,
    }


def test_decode_matches_jax(pair):
    """24 f32 steps, at the tolerance class of tests/test_decoder.py."""
    jax_model, params, model = pair
    inputs = _inputs(model)
    want = np.asarray(jax_decoder.infer_auto_regressive(
        jax_model, params, {k: jnp.asarray(v) for k, v in inputs.items()},
        steps=STEPS))
    got = decoder.infer_auto_regressive(model, inputs, steps=STEPS)
    assert got.shape == (2, STEPS, model.motion_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_decode_matches_reference_loop(pair):
    _, _, model = pair
    inputs = _inputs(model, seed=1)
    ref = decoder.infer_auto_regressive_reference(model, inputs,
                                                  steps=STEPS)
    got = decoder.infer_auto_regressive(model, inputs, steps=STEPS)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_chunks_and_rows_do_not_change_frames(pair):
    _, _, model = pair
    inputs = _inputs(model, steps=11, slack=0, seed=2)
    whole = decoder.infer_auto_regressive(model, inputs, steps=11)
    for chunk in (0, 1, 4, 11, 100):
        got = decoder.infer_auto_regressive(model, inputs, steps=11,
                                            dispatch_chunk=chunk)
        torch.testing.assert_close(got, whole, rtol=0, atol=0)
    for rows in (1, 16, 1000):
        got = decoder.infer_auto_regressive(model, inputs, steps=11,
                                            last_block_rows=rows)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="dispatch_chunk"):
        decoder.infer_auto_regressive(model, inputs, steps=11,
                                      dispatch_chunk=-1)


def test_rejects_short_audio(pair):
    _, _, model = pair
    inputs = {
        "motion_input": np.zeros((1, model.motion_seq_length,
                                  model.motion_dim), np.float32),
        "audio_input": np.zeros((1, model.audio_seq_length,
                                 model.audio_dim), np.float32),
    }
    with pytest.raises(ValueError, match="audio too short"):
        decoder.infer_auto_regressive(model, inputs, steps=5)


def test_step_rules_match_jax(pair):
    jax_model, _, model = pair
    for audio_len in range(0, 60, 3):
        for requested in (1, 7, 100, 1200):
            assert decoder.max_steps(model, audio_len, requested) == \
                jax_decoder.max_steps(jax_model, audio_len, requested)
    for n in range(1, 300, 7):
        for bucket in (1, 16, 128):
            for cap in (None, 100, 1200):
                assert decoder.quantize_steps(n, bucket, cap) == \
                    jax_decoder.quantize_steps(n, bucket, cap)
    for n in range(1, 70):
        for cap in (None, 4, 20, 64):
            assert decoder.padded_batch_size(n, cap=cap) == \
                jax_decoder.padded_batch_size(n, cap=cap)
