"""High-quality rational polyphase resampling (windowed-sinc, Kaiser).

The reference resamples every music track to SR = 30720 Hz inside
``librosa.load`` (reference ``tools/preprocessing.py:98``), whose backend is
a Kaiser-windowed sinc resampler ("kaiser_best": 64 zero crossings,
beta ~= 14.77, rolloff ~= 0.9476).  This module builds the same family of
filter on the exact rational L/M grid (e.g. 48000 -> 30720 is 16/25) and
applies it with scipy's polyphase ``upfirdn`` on the host.  The port's
copy of ``mint_tpu/audio/resample.py``.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

# "kaiser_best" filter family constants.
_NUM_ZEROS = 64
_KAISER_BETA = 14.769656459379492
_ROLLOFF = 0.9475937167399596


def _sinc_filter(up: int, down: int, num_zeros: int = _NUM_ZEROS,
                 beta: float = _KAISER_BETA,
                 rolloff: float = _ROLLOFF) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for rational up/down resampling.

    Cutoff at ``rolloff * min(1, up/down) * Nyquist`` on the upsampled grid.
    Length covers `num_zeros` zero crossings on the slower of the two grids.
    """
    cutoff = rolloff * min(1.0, up / down)
    # Half-length in upsampled samples: num_zeros zero crossings of the
    # sinc at the (possibly reduced) cutoff.
    half = int(math.ceil(num_zeros * up / cutoff))
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n / up)
    taps *= np.kaiser(len(taps), beta)
    return taps


def resample(x: np.ndarray, orig_sr: int, target_sr: int,
             max_denominator: int = 10000) -> np.ndarray:
    """Resample 1-D float signal from `orig_sr` to `target_sr`.

    Output length matches ``ceil(len(x) * target_sr / orig_sr)`` (librosa
    convention).
    """
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    # Integer sample rates always have an exact rational ratio; only cap
    # the denominator as a pathological-input safety valve (44.1 kHz ->
    # 30720 is 512/735 and MUST be exact or audio drifts off-rate).
    frac = Fraction(target_sr, orig_sr)
    if frac.denominator > max_denominator:
        frac = frac.limit_denominator(max_denominator)
    up, down = frac.numerator, frac.denominator

    x = np.asarray(x, np.float64)
    taps = _sinc_filter(up, down)
    half = (len(taps) - 1) // 2

    # Output j sits at upsampled index j*down and is
    #   sum_k taps[j*down - k*up + half] * x[k].
    # scipy's C polyphase upfirdn computes y[n] = sum_k h[n*down - k*up]
    # x[k]; left-pad the taps by z so the filter center lands on a
    # multiple of `down`, then read every output at offset
    # (half + z) / down.
    from scipy.signal import upfirdn
    z = (-half) % down
    h = np.concatenate([np.zeros(z), taps])
    y = upfirdn(h, x, up, down)
    offset = (half + z) // down
    n_out = int(math.ceil(len(x) * up / down))
    out = y[offset:offset + n_out]
    if len(out) < n_out:  # tail beyond upfirdn's support -> zeros
        out = np.pad(out, (0, n_out - len(out)))
    return out.astype(np.float32)


def load(path: str, sr: int = 22050, mono: bool = True):
    """librosa.load equivalent for WAV files: read + mono + resample.

    Returns (y, sr).
    """
    from mint_tpu_torch.audio.wav import read_wav

    y, orig_sr = read_wav(path, mono=mono)
    if sr is not None and orig_sr != sr:
        y = resample(y, orig_sr, sr)
    return y, (sr or orig_sr)
