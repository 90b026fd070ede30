"""Onset peak picking (librosa.onset.onset_detect / util.peak_pick); the
port's copy of ``mint_tpu/audio/onset.py``.

Host-side NumPy: the picking logic is a tiny sequential scan over a
~60 Hz envelope (SURVEY.md §2.1(1) keeps peak-picking host-side).
Parameter defaults follow librosa's onset_detect time-based defaults
evaluated at the reference's sr=30720, hop=512 (60 envelope frames/sec).
"""

from __future__ import annotations

import numpy as np


def peak_pick(x: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, delta: float, wait: int) -> np.ndarray:
    """Indices i where x[i] is the max of [i-pre_max, i+post_max), is at
    least mean([i-pre_avg, i+post_avg)) + delta, and i is > `wait` past
    the previously selected peak (librosa.util.peak_pick, 0.8.x).

    Window statistics mirror librosa exactly: sliding max with
    ``mode='constant', cval=-inf`` (truncated windows at the edges), and
    a sliding mean whose boundary entries are explicitly recomputed as
    truncated-window means (librosa's begin/end correction loops) — a
    replicated-edge mean would flip borderline peaks near boundaries.
    """
    from scipy import ndimage

    x = np.asarray(x, np.float64)
    n = len(x)
    max_len = max(1, pre_max + post_max)
    avg_len = max(1, pre_avg + post_avg)
    # librosa uses origin = ceil(0.5 * (pre - post)) for both filters.
    mov_max = ndimage.maximum_filter1d(
        x, max_len, mode="constant", cval=-np.inf,
        origin=int(np.ceil(0.5 * (pre_max - post_max))))
    mov_avg = ndimage.uniform_filter1d(
        x, avg_len, mode="nearest",
        origin=int(np.ceil(0.5 * (pre_avg - post_avg))))
    # Boundary corrections: librosa overwrites the leading entries
    # (i < pre_avg) and trailing entries (i >= n - post_avg) with the
    # true truncated-window means mean(x[max(0, i-pre_avg) : i+post_avg]).
    i = 0
    while i - pre_avg < 0 and i < n:
        start = max(0, i - pre_avg)
        mov_avg[i] = np.mean(x[start:i + post_avg])
        i += 1
    i = max(0, n - post_avg)
    while i < n:
        start = max(0, i - pre_avg)
        mov_avg[i] = np.mean(x[start:i + post_avg])
        i += 1
    # librosa: detections = x*(x == mov_max); keep where >= mov_avg+delta.
    detections = x * (x == mov_max)
    detections = detections * (detections >= mov_avg + delta)
    peaks = []
    last = -np.inf
    for i in np.nonzero(detections)[0]:
        if i > last + wait:
            last = int(i)
            peaks.append(last)
    return np.asarray(peaks, np.int64)


def onset_detect(onset_envelope: np.ndarray, sr: int,
                 hop_length: int = 512) -> np.ndarray:
    """Frame indices of onsets (librosa.onset.onset_detect defaults).

    The envelope is shift-min / scale-max normalized to [0, 1] before
    picking, as librosa does.
    """
    env = np.asarray(onset_envelope, np.float64).ravel()
    if not env.any() or not np.all(np.isfinite(env)):
        return np.asarray([], np.int64)
    env = env - env.min()
    # librosa max-scales with a tiny-offset denominator (never branches).
    env = env / (env.max() + np.finfo(env.dtype).tiny)
    # librosa's time-based defaults, in frames (integer floor division):
    pre_max = int(0.03 * sr // hop_length)        # 30 ms
    post_max = int(0.0 * sr // hop_length + 1)    # 0 ms
    pre_avg = int(0.10 * sr // hop_length)        # 100 ms
    post_avg = int(0.10 * sr // hop_length + 1)   # 100 ms
    wait = int(0.03 * sr // hop_length)           # 30 ms
    delta = 0.07
    return peak_pick(env, pre_max, post_max, pre_avg, post_avg, delta, wait)
