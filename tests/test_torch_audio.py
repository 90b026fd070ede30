"""The port's audio frontend against the JAX package's (CPU): the host
copies (``wav``, ``resample``, ``onset``, ``beat``, the tuning and CENS
steps) bit for bit; the device parts (STFT, mel, MFCC, onset flux, CQT) on
the same seeded signals within a tolerance relative to each output's peak;
and the 35-column feature of 24 s click tracks at two AIST++ tempos, its
step-function columns (tuning, onset peaks, beats) exactly.

Tolerances: 1e-5 of the peak for every continuous output (the two FFTs and
matmuls sum in another order; measured margins here: 4e-7 STFT, 3e-7 mel,
1.7e-6 MFCC, 2.3e-7 envelope, 1e-6 CQT); 1e-5 absolute for CENS (unit-norm
rows; the quantiser is a step function, so it is exact when its inputs do
not straddle a threshold, as they do not here).
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mint_tpu.audio import beat as jax_beat
from mint_tpu.audio import cqt as jax_cqt
from mint_tpu.audio import frontend as jax_frontend
from mint_tpu.audio import onset as jax_onset
from mint_tpu.audio import resample as jax_resample
from mint_tpu.audio import spectral as jax_spectral
from mint_tpu.audio import wav as jax_wav
from mint_tpu_torch.audio import (AudioFeatureExtractor, beat, cqt,
                                  extract_audio_features, frontend, onset,
                                  resample, spectral, wav)

SR = 30720
PEAK_TOL = 1e-5
CENS_TOL = 1e-5


def click_track(bpm, seconds, sr=SR, seed=0, tones=(220.0, 329.63)):
    """Noise-burst clicks on every beat of `bpm` over sustained tones,
    peak 0.5, f32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    y = sum(0.1 * np.sin(2 * np.pi * f * t) for f in tones)
    for k in range(int(seconds * bpm / 60) + 1):
        s = int(round(k * 60 * sr / bpm))
        m = min(300, n - s)
        if m > 0:
            y[s:s + m] += np.exp(-np.arange(m) / 60.0) * rng.choice([-1, 1], m)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def assert_close_to_peak(got, want, tol=PEAK_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


# -- wav and resample: host copies, bit for bit ------------------------------

def _riff(path, payload, tag, channels, rate, bits, extensible=False):
    """A WAV file of raw `payload` bytes with the given fmt chunk."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels,
                      rate, rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) \
            + b"\x00" * 14
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload
            + (b"\x00" if len(payload) % 2 else b""))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _pcm24(x):
    v = x.astype(np.int32) & 0xFFFFFF
    return np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                    -1).astype(np.uint8).tobytes()


_WAVS = {
    "pcm8": lambda r: (r.integers(0, 256, 301, np.uint8).tobytes(), 1, 1, 8),
    "pcm16": lambda r: (r.integers(-2**15, 2**15, 300).astype("<i2")
                        .tobytes(), 1, 1, 16),
    "pcm24": lambda r: (_pcm24(r.integers(-2**23, 2**23, 300)), 1, 1, 24),
    "pcm32": lambda r: (r.integers(-2**31, 2**31, 300).astype("<i4")
                        .tobytes(), 1, 1, 32),
    "float32": lambda r: (r.uniform(-1, 1, 300).astype("<f4").tobytes(), 3,
                          1, 32),
    "float64": lambda r: (r.uniform(-1, 1, 300).astype("<f8").tobytes(), 3,
                          1, 64),
    "stereo16": lambda r: (r.integers(-2**15, 2**15, 601).astype("<i2")
                           .tobytes(), 1, 2, 16),
    "extensible24_stereo": lambda r: (_pcm24(r.integers(-2**23, 2**23, 600)),
                                      1, 2, 24),
}


@pytest.mark.parametrize("kind", sorted(_WAVS))
def test_read_wav_equals_jax(tmp_path, kind):
    payload, tag, channels, bits = _WAVS[kind](np.random.default_rng(1))
    path = str(tmp_path / f"{kind}.wav")
    _riff(path, payload, tag, channels, 44100, bits,
          extensible=kind.startswith("extensible"))
    for mono in (True, False):
        got, rate = wav.read_wav(path, mono=mono)
        want, want_rate = jax_wav.read_wav(path, mono=mono)
        assert rate == want_rate == 44100
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        if channels > 1 and not mono:
            assert got.shape[1] == channels


def test_read_wav_refuses_what_jax_refuses(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    for reader in (wav.read_wav, jax_wav.read_wav):
        with pytest.raises(ValueError, match="not a RIFF/WAVE"):
            reader(str(bad))


@pytest.mark.parametrize("orig_sr", [48000, 44100, 22050, SR])
def test_resample_equals_jax(orig_sr):
    y = np.random.default_rng(orig_sr).uniform(-1, 1, 4001).astype(np.float32)
    got = resample.resample(y, orig_sr, SR)
    want = jax_resample.resample(y, orig_sr, SR)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- spectral: on the device, against the JAX functions ---------------------

@pytest.fixture(scope="module")
def signals():
    return {"track": click_track(120, 10.0, seed=3),
            "short": click_track(120, 0.03, seed=4)[:900],
            "tiny": np.float32([0.25])}


@pytest.mark.parametrize("n", [1, 2, 700, 1024, 1025, 5000])
def test_frame_signal_equals_jax(n):
    """Reflect padding: torch's for signals longer than n_fft // 2, NumPy's
    repeated reflection on the host for the rest, as jnp.pad reflects."""
    y = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = spectral.frame_signal(torch.from_numpy(y), 2048, 512)
    want = np.asarray(jax_spectral.frame_signal(jnp.asarray(y), 2048, 512))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("signal", ["track", "short", "tiny"])
@pytest.mark.parametrize("name", ["stft_power", "stft_magnitude",
                                  "melspectrogram", "mfcc",
                                  "onset_strength"])
def test_spectral_matches_jax(signals, name, signal):
    y = signals[signal]
    args = () if name.startswith("stft") else (SR,)
    got = getattr(spectral, name)(torch.from_numpy(y), *args)
    want = np.asarray(getattr(jax_spectral, name)(jnp.asarray(y), *args))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert_close_to_peak(got.numpy(), want, what=f"{name} {signal}")


def test_host_matrices_equal_jax():
    np.testing.assert_array_equal(spectral.mel_filterbank(SR, 2048, 128),
                                  jax_spectral.mel_filterbank(SR, 2048, 128))
    np.testing.assert_array_equal(
        spectral.mel_filterbank(SR, 2048, 128, fmax=11025.0),
        jax_spectral.mel_filterbank(SR, 2048, 128, fmax=11025.0))
    np.testing.assert_array_equal(spectral.dct_matrix(20, 128),
                                  jax_spectral.dct_matrix(20, 128))


# -- CQT, tuning, chroma -----------------------------------------------------

@pytest.mark.parametrize("signal", ["track", "short"])
def test_cqt_magnitude_matches_jax(signals, signal):
    """The track's 601 frames run as two 512-frame chunks with context;
    the short signal (<= n_fft // 2 of the 65536-point FFT) takes the host
    reflection and one chunk."""
    y = signals[signal]
    got = cqt.cqt_magnitude(y, SR, tuning=0.01, device="cpu")
    want = jax_cqt.cqt_magnitude(y, SR, tuning=0.01)
    assert got.shape == want.shape == (len(y) // 512 + 1, 252)
    assert_close_to_peak(got, want, what=f"cqt {signal}")


def test_cqt_chunking_is_exact():
    """Chunk boundaries are invisible: 200-frame chunks equal one chunk."""
    y = click_track(100, 3.0, seed=5)
    one = cqt.cqt_magnitude(y, SR, device="cpu", chunk=1024)
    many = cqt.cqt_magnitude(y, SR, device="cpu", chunk=64)
    assert_close_to_peak(many, one, tol=1e-6)


@pytest.mark.parametrize("cents", [0.0, 23.0])
def test_estimate_tuning_equals_jax(cents):
    f = 440.0 * 2 ** (cents / 1200)
    y = click_track(110, 4.0, seed=6, tones=(f, 1.5 * f))
    got = cqt.estimate_tuning(y, SR, device="cpu")
    assert got == jax_cqt.estimate_tuning(y, SR)
    if cents:
        assert got != 0.0


def test_chroma_cens_matches_jax(signals):
    y = signals["track"]
    got = cqt.chroma_cens(y, SR, device="cpu")
    want = jax_cqt.chroma_cens(y, SR)
    np.testing.assert_allclose(got, want, rtol=0, atol=CENS_TOL)
    chroma = np.random.default_rng(7).uniform(0, 1, (80, 12))
    np.testing.assert_array_equal(cqt.cens_from_chroma(chroma),
                                  jax_cqt.cens_from_chroma(chroma))


# -- onset and beat: host copies on one envelope -----------------------------

@pytest.fixture(scope="module")
def envelope():
    y = click_track(125, 12.0, seed=8)
    return np.asarray(jax_spectral.onset_strength(jnp.asarray(y), SR))


def test_onset_detect_equals_jax(envelope):
    got = onset.onset_detect(envelope, SR)
    np.testing.assert_array_equal(got, jax_onset.onset_detect(envelope, SR))
    assert len(got) > 20


@pytest.mark.parametrize("start_bpm", [120.0, 125.0])
def test_beat_track_equals_jax(envelope, start_bpm):
    tempo, beats = beat.beat_track(envelope, SR, start_bpm=start_bpm,
                                   tightness=100.0)
    want_tempo, want_beats = jax_beat.beat_track(
        envelope, SR, start_bpm=start_bpm, tightness=100.0)
    assert tempo == want_tempo
    np.testing.assert_array_equal(beats, want_beats)
    assert abs(np.median(np.diff(beats)) - 3600 / 125) <= 1.5


# -- the 35-column feature ---------------------------------------------------

@pytest.fixture(scope="module", params=["mBR2", "mHO3"])
def features(request):
    """24 s click tracks at the tempo of an AIST++ name (100 and 125 BPM)
    with two tones: (name, bpm, port features, JAX features)."""
    name = request.param
    bpm = frontend.tempo_from_name(name)
    y = click_track(bpm, 24.0, seed=bpm)
    got = extract_audio_features(y, SR, start_bpm=bpm, device="cpu")
    want = jax_frontend.extract_audio_features(y, SR, start_bpm=bpm)
    return name, bpm, got, want


def test_features_continuous_columns_match_jax(features):
    name, _, got, want = features
    assert got.shape == want.shape == (1441, 35)
    assert got.dtype == np.float32
    assert_close_to_peak(got[:, 0], want[:, 0], what=f"{name} envelope")
    assert_close_to_peak(got[:, 1:21], want[:, 1:21], what=f"{name} MFCC")
    np.testing.assert_allclose(got[:, 21:33], want[:, 21:33], rtol=0,
                               atol=CENS_TOL, err_msg=f"{name} CENS")


def test_features_onehot_columns_equal_jax(features):
    name, bpm, got, want = features
    np.testing.assert_array_equal(got[:, 33:], want[:, 33:], err_msg=name)
    beats = np.flatnonzero(got[:, 34])
    assert len(beats) > 20 and got[:, 33].sum() > 20
    assert abs(np.median(np.diff(beats)) - 3600 / bpm) <= 1.5


def test_frontend_names_and_tempo_rule():
    assert (frontend.SR, frontend.HOP_LENGTH, frontend.FPS) == (SR, 512, 60)
    for name in ("mBR0", "mHO5", "mJB9", "mWA2"):
        assert frontend.tempo_from_name(name) == \
            jax_frontend.tempo_from_name(name)
    with pytest.raises(ValueError):
        frontend.tempo_from_name("mXX0")


def _write_track(path, bpm, seconds, rate=48000):
    """A 16-bit stereo WAV of a click track at `rate` (the channels differ
    by a little noise, so the mixdown matters)."""
    y = click_track(bpm, seconds, sr=rate, seed=bpm)
    noise = np.random.default_rng(bpm).uniform(-1e-3, 1e-3, len(y))
    pcm = np.stack([y + noise, y - noise], -1) * 32767
    _riff(path, pcm.astype("<i2").tobytes(), 1, 2, rate, 16)


def test_extractor_cache_layout_matches_jax(tmp_path):
    audio = tmp_path / "music"
    audio.mkdir()
    _write_track(str(audio / "mPO5.wav"), 130, 6.0)
    port = AudioFeatureExtractor(str(audio), cache_dir=str(tmp_path / "port"),
                                 device="cpu")
    got = port("mPO5")
    assert os.listdir(tmp_path / "port") == ["mPO5.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "mPO5.npy"),
                                  got)
    want = jax_frontend.AudioFeatureExtractor(
        str(audio), cache_dir=str(tmp_path / "jax"))("mPO5")
    assert os.listdir(tmp_path / "jax") == ["mPO5.npy"]
    assert got.shape == want.shape == (361, 35)
    assert_close_to_peak(got[:, :21], want[:, :21])
    np.testing.assert_allclose(got[:, 21:33], want[:, 21:33], rtol=0,
                               atol=CENS_TOL)
    np.testing.assert_array_equal(got[:, 33:], want[:, 33:])
    # The second call reads the cache: the WAV is no longer needed.
    os.remove(audio / "mPO5.wav")
    np.testing.assert_array_equal(port("mPO5"), got)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The default device is the card: without one, no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = click_track(120, 2.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        extract_audio_features(y, SR)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        AudioFeatureExtractor(str(tmp_path))
    assert extract_audio_features(y, SR, device="cpu").shape == (121, 35)
