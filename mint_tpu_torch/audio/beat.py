"""Tempo estimation and the Ellis dynamic-programming beat tracker; the
port's copy of ``mint_tpu/audio/beat.py``.

Equivalent of the reference's
``librosa.beat.beat_track(onset_envelope=envelope, sr=SR, hop_length=512,
start_bpm=<from music name>, tightness=100)`` call
(reference ``tools/preprocessing.py:109-113``):

- tempo: windowed-autocorrelation tempogram (8 s window), time-averaged,
  weighted by a log-normal prior centered at ``start_bpm`` (std 1 octave),
  argmax over the period axis  [Ellis 2007; librosa.beat.tempo]
- beats: Gaussian-smoothed local score + DP over inter-beat penalties
  ``-tightness * log(interval/period)^2``, backtrace from the best
  terminal beat, then trim weak leading/trailing beats
  [librosa.beat.__beat_tracker]

The DP is an O(T * period) host-side scan (SURVEY.md §2.1(1)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mint_tpu_torch.audio.spectral import hann_window

_TINY = np.finfo(np.float64).tiny  # librosa util.tiny for float64 inputs


def tempo_frequencies(n: int, sr: int, hop_length: int) -> np.ndarray:
    """BPM of each autocorrelation lag; lag 0 -> inf."""
    bpms = np.zeros(n)
    bpms[0] = np.inf
    bpms[1:] = 60.0 * sr / (hop_length * np.arange(1, n))
    return bpms


def tempogram(onset_envelope: np.ndarray, win_length: int) -> np.ndarray:
    """Local autocorrelation tempogram [win_length, frames].

    Each frame's windowed onset autocorrelation, inf-norm normalized
    (librosa.feature.tempogram with hop 1).
    """
    env = np.asarray(onset_envelope, np.float64).ravel()
    n = len(env)
    # Center-pad with a linear ramp to zero (librosa pad mode).
    pad = win_length // 2
    env = np.pad(env, pad, mode="linear_ramp", end_values=0)
    # Frames [win_length, n] with hop 1.
    idx = np.arange(win_length)[:, None] + np.arange(n)[None, :]
    # librosa windows with get_window('hann', ..., fftbins=True): PERIODIC.
    frames = env[idx] * hann_window(win_length, fftbins=True)[:, None]
    # Autocorrelation along axis 0 via rFFT (librosa pads to 2N+1; any
    # n_fft >= 2N-1 yields the identical linear autocorrelation).
    n_fft = 2 * win_length + 1
    spec = np.fft.rfft(frames, n_fft, axis=0)
    ac = np.fft.irfft(spec * np.conj(spec), n_fft, axis=0)[:win_length]
    norm = np.abs(ac).max(axis=0, keepdims=True)
    return ac / np.where(norm < _TINY, 1.0, norm)


def tempo(onset_envelope: np.ndarray, sr: int, hop_length: int = 512,
          start_bpm: float = 120.0, std_bpm: float = 1.0,
          ac_size: float = 8.0, max_tempo: float = 320.0) -> float:
    """Global tempo estimate in BPM (librosa.beat.tempo).

    librosa's exact selection arithmetic: argmax over
    ``log1p(1e6 * tg) + logprior`` with a log-normal prior, lags faster
    than ``max_tempo`` killed with -inf, and the lag-0 winner falling
    back to ``start_bpm``.
    """
    # librosa's time_to_frames FLOORS (8 s at sr/hop); round() would
    # shift every tempogram lag/BPM bin at non-integral rates.
    win_length = int(np.floor(ac_size * sr / hop_length))
    tg = tempogram(onset_envelope, win_length).mean(axis=1)
    bpms = tempo_frequencies(win_length, sr, hop_length)
    with np.errstate(divide="ignore"):
        logprior = -0.5 * ((np.log2(bpms) - np.log2(start_bpm))
                           / std_bpm) ** 2
    if max_tempo is not None:
        logprior[bpms > max_tempo] = -np.inf
    best = int(np.argmax(np.log1p(1e6 * tg) + logprior))
    if best == 0:  # lag 0 (bpm inf): librosa falls back to start_bpm
        return float(start_bpm)
    return float(bpms[best])


def _beat_local_score(onset_envelope: np.ndarray,
                      period: int) -> np.ndarray:
    """Gaussian-smoothed onset envelope (librosa __beat_local_score)."""
    std = onset_envelope.std(ddof=1)
    # librosa divides only when std > 0 (a constant envelope is used raw).
    env = onset_envelope / std if std > 0 else onset_envelope
    window = np.exp(-0.5 * (np.arange(-period, period + 1) * 32.0
                            / period) ** 2)
    return np.convolve(env, window, mode="same")


def _dp_track(localscore: np.ndarray, period: int,
              tightness: float) -> Tuple[np.ndarray, np.ndarray]:
    """DP over beat placements -> (backlink, cumscore)."""
    n = len(localscore)
    backlink = np.zeros(n, np.int64)
    cumscore = np.zeros(n)
    # Candidate previous-beat offsets: -2*period .. -period/2.
    window = np.arange(-2 * period, -int(np.round(period / 2)) + 1)
    txwt = -tightness * (np.log(-window / period) ** 2)
    first_beat = True
    max_local = localscore.max()
    for i in range(n):
        # Offsets reaching before frame 0 contribute transition cost only
        # (cumscore treated as 0), matching the Ellis/librosa recursion.
        z_pad = max(0, min(-(window[0] + i), len(window)))
        candidates = txwt.copy()
        candidates[z_pad:] += cumscore[window[z_pad:] + i]
        best = int(np.argmax(candidates))
        cumscore[i] = localscore[i] + candidates[best]
        if first_beat and localscore[i] < 0.01 * max_local:
            backlink[i] = -1
        else:
            backlink[i] = window[best] + i
            first_beat = False
    return backlink, cumscore


def _last_beat(cumscore: np.ndarray) -> int:
    """Last strong local max of cumscore (librosa __last_beat)."""
    lm = np.zeros(len(cumscore), bool)
    lm[1:-1] = ((cumscore[1:-1] > cumscore[:-2])
                & (cumscore[1:-1] >= cumscore[2:]))
    if len(cumscore) > 1:
        lm[-1] = cumscore[-1] > cumscore[-2]
    if not lm.any():
        return len(cumscore) - 1
    med_score = np.median(cumscore[lm])
    # librosa: argwhere(cumscore * localmax * 2 > medscore).max() — the
    # elementwise product (not a boolean &) also admits non-localmax
    # zeros when the median score is negative.
    candidates = np.flatnonzero(cumscore * lm * 2 > med_score)
    return int(candidates.max()) if len(candidates) else len(cumscore) - 1


def _trim_beats(localscore: np.ndarray, beats: np.ndarray) -> np.ndarray:
    """Drop weak leading/trailing beats (librosa __trim_beats, trim=True)."""
    if len(beats) == 0:
        return beats
    w = hann_window(5, fftbins=False)
    smooth_boe = np.convolve(localscore[beats], w, mode="same")
    threshold = 0.5 * ((smooth_boe ** 2).mean() ** 0.5)
    valid = np.argwhere(smooth_boe > threshold)
    if len(valid) == 0:
        return np.asarray([], np.int64)
    return beats[int(valid.min()):int(valid.max()) + 1]


def beat_track(onset_envelope: np.ndarray, sr: int, hop_length: int = 512,
               start_bpm: float = 120.0, tightness: float = 100.0,
               trim: bool = True, bpm: float = None
               ) -> Tuple[float, np.ndarray]:
    """(tempo_bpm, beat frame indices) — librosa.beat.beat_track."""
    env = np.asarray(onset_envelope, np.float64).ravel()
    if not env.any():
        return 0.0, np.asarray([], np.int64)
    if bpm is None:
        bpm = tempo(env, sr, hop_length, start_bpm=start_bpm)
    period = int(np.round(60.0 * sr / (hop_length * bpm)))
    localscore = _beat_local_score(env, period)
    backlink, cumscore = _dp_track(localscore, period, tightness)
    b = _last_beat(cumscore)
    beats = [b]
    while backlink[b] >= 0:
        b = backlink[b]
        beats.append(b)
    beats = np.asarray(beats[::-1], np.int64)
    if trim:
        beats = _trim_beats(localscore, beats)
    return float(bpm), beats
