"""The port's batching service and HTTP endpoint (CPU, tiny model)."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.serving import GenerationService, serve
from test_torch_weights import tiny_config

RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def service():
    model = init_params(FACT(tiny_config()).eval(),
                        torch.Generator().manual_seed(1))
    svc = GenerationService(model, batch_window_ms=200, default_steps=8,
                            steps_bucket=16)
    yield svc
    svc.close()


def _audio(frames):
    return RNG.standard_normal((frames, 35)).astype(np.float32)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return buf.getvalue()


def _concurrent(svc, audios, steps):
    results = [None] * len(audios)
    errors = []

    def call(i):
        try:
            results[i] = svc.generate(audios[i], steps=steps, timeout=120)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(audios))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return results


def test_concurrent_requests_co_batch_and_match_decoder(service):
    """Three requests in one length bucket ride one dispatch, and each
    result equals the decoder's output for that clip alone."""
    audio_seq = service.model.audio_seq_length
    audios = [_audio(n + audio_seq - 1) for n in (5, 9, 12)]
    before = service.stats_snapshot()
    results = _concurrent(service, audios, steps=100)
    after = service.stats_snapshot()
    assert after["batches"] - before["batches"] == 1
    assert after["requests"] - before["requests"] == 3
    assert after["decode_steps"] - before["decode_steps"] == 16
    for audio, out, n in zip(audios, results, (5, 9, 12)):
        assert out.shape == (n, service.motion_dim)
        assert np.isfinite(out).all()
        zeros = np.zeros((1, service.model.motion_seq_length,
                          service.motion_dim), np.float32)
        want = decoder.infer_auto_regressive(
            service.model, {"motion_input": zeros,
                            "audio_input": audio[None]}, steps=n)
        np.testing.assert_allclose(out, want[0].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_seed_is_used(service):
    audio = _audio(40)
    seed = RNG.standard_normal((service.model.motion_seq_length,
                                service.motion_dim)).astype(np.float32)
    base = service.generate(audio, steps=5)
    seeded = service.generate(audio, seed=seed, steps=5)
    want = decoder.infer_auto_regressive(
        service.model, {"motion_input": seed[None],
                        "audio_input": audio[None]}, steps=5)
    np.testing.assert_allclose(seeded, want[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(base, seeded)


@pytest.mark.parametrize("audio,seed,match", [
    (np.zeros(40, np.float32), None, "audio features"),
    (np.zeros((40, 7), np.float32), None, "audio features"),
    (np.zeros((40, 35), np.float32), np.zeros((11, 225), np.float32),
     "seed motion"),
    (np.zeros((10, 35), np.float32), None, "audio too short"),
])
def test_bad_request_raises_value_error(service, audio, seed, match):
    with pytest.raises(ValueError, match=match):
        service.generate(audio, seed=seed, steps=5)


def test_warmup_co_batches(service):
    before = service.stats_snapshot()
    assert service.warmup(steps=8, batch=4) > 0
    after = service.stats_snapshot()
    assert after["requests"] - before["requests"] == 4
    assert after["batches"] - before["batches"] == 1


def test_http_round_trip(service):
    server = serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        audio = _audio(40)
        req = urllib.request.Request(f"{url}/generate?steps=6",
                                     data=_npy(audio), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = np.load(io.BytesIO(r.read()))
        assert out.shape == (6, service.motion_dim)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, service.generate(audio, steps=6),
                                   rtol=1e-6, atol=1e-6)
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok"
        assert info["motion_dim"] == service.motion_dim
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            assert json.loads(r.read())["generated_frames"] > 0
        bad = urllib.request.Request(f"{url}/generate", method="POST",
                                     data=_npy(np.zeros((5, 7))))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_cli_parses_the_jax_flag_names():
    from mint_tpu_torch.serving.server import _parser

    args = _parser().parse_args([
        "--config_path=c", "--port=0", "--steps=64", "--warmup_batch=4",
        "--warmup_all_buckets", "--use_bfloat16", "--batch_window_ms=5",
        "--max_batch=16", "--request_timeout=10", "--no-warmup",
        "--device=cpu"])
    assert (args.port, args.steps, args.max_batch, args.warmup) == \
        (0, 64, 16, False)
    assert args.use_bfloat16 and args.warmup_all_buckets


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_serves_the_latest_checkpoint(tmp_path, bf16):
    """--checkpoint_dir: the server's model holds the latest checkpoint's
    parameters (a params-only restore of the port's train CLI output), and
    GenerationService gives the frames of a model loaded with them; bf16
    keeps LayerNorm's parameters f32, the checkpoint's values."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.config.serialize import pipeline_to_text
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.serving import server
    from test_torch_train import _cli as train
    from test_torch_train import tiny_pipeline_config, write_corpus

    (tmp_path / "data").mkdir()
    write_corpus(str(tmp_path / "data"))
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(tiny_pipeline_config(
        str(tmp_path / "data" / "*_tfrecord-train*"))))
    run = tmp_path / "run"
    train(str(cfg_path), str(run), 3)
    flags = [f"--config_path={cfg_path}", f"--checkpoint_dir={run}",
             "--device=cpu"] + (["--use_bfloat16"] if bf16 else [])
    model = server.load_model(server._parser().parse_args(flags))

    saved = torch.load(run / "3" / "params.pt")
    dtype = torch.bfloat16 if bf16 else torch.float32
    for name, p in model.state_dict().items():
        want = saved[name]
        if ".norm_" not in name:
            want = want.to(dtype)
        assert p.dtype == want.dtype, name
        torch.testing.assert_close(p, want, rtol=0, atol=0)
    # Without --checkpoint_dir: the seeded initialization, other weights.
    seeded = server.load_model(server._parser().parse_args(
        flags[:1] + flags[2:]))
    key = "cross_modal_layer.transformer.block_0.mlp.fc1.weight"
    assert not torch.equal(seeded.state_dict()[key], model.state_dict()[key])

    ref = builder.build(load_pipeline_config(str(cfg_path)).multi_modal_model,
                        is_training=False, dtype=dtype, device="cpu")
    ref.load_state_dict(saved)
    svc = GenerationService(model, batch_window_ms=1, default_steps=5)
    try:
        audio = _audio(5 + model.audio_seq_length - 1)
        out = svc.generate(audio, steps=5, timeout=120)
    finally:
        svc.close()
    zeros = np.zeros((1, model.motion_seq_length, svc.motion_dim),
                     np.float32)
    want = decoder.infer_auto_regressive(
        ref, {"motion_input": zeros, "audio_input": audio[None]}, steps=5)
    np.testing.assert_array_equal(out, want[0].float().numpy())
