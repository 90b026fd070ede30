"""The port's AR decoder against ``mint_tpu.infer.decoder`` on identical
weights (CPU, f32), and against its own reference loop."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.infer import decoder as jax_decoder
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.utils import graphs
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


# -- the static-tensor step body and its CUDA graph --------------------------

STEPS_60 = 60


def test_static_body_matches_jax_60_steps(pair):
    """The static-tensor body (the graph's, run uncaptured on the CPU)
    over 60 f32 steps, at test_decode_matches_jax's tolerance."""
    jax_model, params, model = pair
    inputs = _inputs(model, steps=STEPS_60, seed=5)
    want = np.asarray(jax_decoder.infer_auto_regressive(
        jax_model, params, {k: jnp.asarray(v) for k, v in inputs.items()},
        steps=STEPS_60))
    got = decoder._decode(model, inputs, STEPS_60, None,
                          decoder.DECODE_LAST_BLOCK_ROWS, graphed=False)
    assert got.shape == (2, STEPS_60, model.motion_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_body_frames_same_across_chunks_and_batch_padding(pair):
    """Chunks are runs of the same steps, and a batch padded to a power of
    two (the last clip repeated, as the server and evaluator pad) gives
    the real clips the frames they get alone in a batch of their own."""
    _, _, model = pair
    inputs = _inputs(model, b=3, steps=13, slack=0, seed=6)
    whole = decoder.infer_auto_regressive(model, inputs, steps=13)
    for chunk in (1, 5, 13):
        got = decoder.infer_auto_regressive(model, inputs, steps=13,
                                            dispatch_chunk=chunk)
        torch.testing.assert_close(got, whole, rtol=0, atol=0)
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in inputs.items()}
    got = decoder.infer_auto_regressive(model, padded, steps=13)
    assert got.shape[0] == decoder.padded_batch_size(3) == 4
    np.testing.assert_allclose(got[:3].numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got[3], got[2], rtol=0, atol=0)


class NoCuda:
    """Stands in for torch.cuda in utils/graphs.py: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"torch.cuda.{name} used on the CPU")


class FakeCuda:
    """The CUDA calls of utils/graphs.py played on the CPU: the "capture"
    runs the step once for real (no graph records it) and a replay calls
    nothing.  `fail` names the call that raises: "graph" (the capture) or
    "replay"."""

    class _Stream:
        def wait_stream(self, other):
            pass

    class _Graph:
        def __init__(self, fail):
            self.fail = fail

        def replay(self):
            if self.fail == "replay":
                raise RuntimeError("replay refused")

    def __init__(self, fail=None):
        self.fail = fail

    def current_stream(self, device=None):
        return self._Stream()

    def Stream(self, device=None):  # noqa: N802 (torch.cuda's name)
        return self._Stream()

    def stream(self, stream):
        return contextlib.nullcontext()

    def synchronize(self, device=None):
        pass

    def empty_cache(self):
        pass

    def memory_reserved(self, device=None):
        return 0

    def graph_pool_handle(self):
        return (0, 1)

    def CUDAGraph(self):  # noqa: N802 (torch.cuda's name)
        return self._Graph(self.fail)

    @contextlib.contextmanager
    def graph(self, graph, pool=None, stream=None):
        if self.fail == "graph":
            raise RuntimeError("capture refused")
        yield


def test_cpu_decode_never_touches_cuda_graphs(pair, monkeypatch):
    _, _, model = pair
    monkeypatch.setattr(graphs, "_cuda", NoCuda())
    inputs = _inputs(model, steps=4, slack=0, seed=7)
    got = decoder.infer_auto_regressive(model, inputs, steps=4)
    assert got.shape == (2, 4, model.motion_dim)
    assert not graphs.of(model).steps


@pytest.mark.parametrize("fail", ["graph", "replay"])
def test_graph_failure_raises_and_never_runs_eagerly(pair, monkeypatch,
                                                     fail):
    """On a (faked) card a capture or a replay that fails raises out of
    the decode: the loop does not go on with eager steps.  The body runs
    once eagerly (the warm-up), once more for the fake capture, and no
    more."""
    _, _, model = pair
    calls = []
    body = decoder._Loop.body

    def counted(self):
        calls.append(1)
        body(self)

    monkeypatch.setattr(graphs, "_cuda", FakeCuda(fail))
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(decoder._Loop, "body", counted)
    monkeypatch.setattr(model, "_graphs", graphs.Graphs(), raising=False)
    inputs = _inputs(model, steps=6, slack=0, seed=8)
    refused = "capture" if fail == "graph" else "replay"
    with pytest.raises(RuntimeError, match=f"{refused} refused"):
        decoder.infer_auto_regressive(model, inputs, steps=6)
    assert len(calls) == (1 if fail == "graph" else 2)


def test_graphs_follow_the_parameters(pair, monkeypatch):
    """On a (faked) card the decode caches one graph per key; weights
    loaded into the parameters keep it, parameters replaced by other
    tensors drop it (a replay would read the old ones' addresses)."""
    _, _, model = pair
    monkeypatch.setattr(graphs, "_cuda", FakeCuda())
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(model, "_graphs", graphs.Graphs(), raising=False)
    inputs = _inputs(model, steps=3, slack=0, seed=9)
    decoder.infer_auto_regressive(model, inputs, steps=3)
    cache = graphs.of(model)
    (key, (_, step)), = cache.steps.items()
    assert cache.captures == 1
    model.load_state_dict(model.state_dict())
    decoder.infer_auto_regressive(model, inputs, steps=3)
    assert cache.steps[key][1] is step and cache.captures == 1
    head = model.cross_modal_layer.cross_output_layer
    monkeypatch.setattr(head, "bias", torch.nn.Parameter(head.bias.clone()))
    decoder.infer_auto_regressive(model, inputs, steps=3)
    assert cache.steps[key][1] is not step and cache.captures == 2
