"""STFT / mel / MFCC / onset strength on torch tensors (the port's
counterpart of ``mint_tpu/audio/spectral.py``).

Numerics follow the librosa defaults at the reference's call sites
(reference ``tools/preprocessing.py:98-102``):

- STFT: n_fft=2048, hop=512, centered (reflect padding), Hann window.
- melspectrogram: power 2.0, n_mels=128, Slaney mel scale + Slaney area
  normalization, fmin=0, fmax=sr/2.
- power_to_db: 10*log10(max(S, 1e-10)), top_db=80 floor relative to max.
- MFCC: DCT-II orthonormal over power_to_db(melspectrogram), first 20.
- onset_strength: mean over mel bands of positive first difference of the
  dB mel spectrogram (lag 1), padded with n_fft//(2*hop)+lag leading zeros
  and trimmed to the frame count.

The filterbank and DCT matrices are built in NumPy on the host, as in the
JAX package; the FFT and the two projections (``torch.fft.rfft`` and
``torch.matmul``, f32) run on the device of the signal tensor.  The dB
floor is global over the spectrogram, so ``mfcc`` and ``onset_strength``
see the whole track at once.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, fftbins: bool = True) -> np.ndarray:
    """scipy.signal.get_window('hann', n, fftbins) equivalent."""
    if n == 1:
        return np.ones(1)
    m = n if fftbins else n - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / m)
    return w


def _hz_to_mel(freq, htk: bool = False):
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    mel = np.where(above,
                   min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                   / logstep,
                   mel)
    return mel


def _mel_to_hz(mel, htk: bool = False):
    mel = np.asanyarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mel >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    freq)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft//2] (librosa.filters.mel)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    mel_f = _mel_to_hz(mel_pts, htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fftpack.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(build, device: torch.device, *args) -> torch.Tensor:
    """``build(*args)``, a host-built matrix (window, filterbank, DCT), as
    an f32 tensor on `device`, copied once per (matrix, arguments,
    device)."""
    return torch.from_numpy(build(*args).astype(np.float32)).to(device)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """`y` [T] padded by `pad` samples of reflection on both sides, as
    ``np.pad(y, pad, mode="reflect")`` pads it.  torch's reflect pad takes
    only ``pad < T``; a shorter signal reflects repeatedly, which NumPy
    does on the host (such a signal is at most `pad` samples long)."""
    if y.shape[0] > pad:
        return F.pad(y[None], (pad, pad), mode="reflect")[0]
    return torch.from_numpy(np.pad(y.cpu().numpy(), pad, mode="reflect")
                            ).to(y.device)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """[T] -> [frames, n_fft] with centered reflect padding: a strided view
    of the padded signal."""
    if center:
        y = reflect_pad(y, n_fft // 2)
    return y.unfold(0, n_fft, hop)


def _stft(y: torch.Tensor, n_fft: int, hop: int,
          center: bool) -> torch.Tensor:
    frames = frame_signal(y, n_fft, hop, center)
    win = _on_device(hann_window, y.device, n_fft)
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1)


def stft_power(y: torch.Tensor, n_fft: int = 2048, hop: int = 512,
               center: bool = True) -> torch.Tensor:
    """|STFT|^2 -> [frames, 1 + n_fft//2], Hann window."""
    return _stft(y, n_fft, hop, center).abs() ** 2


def stft_magnitude(y: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                   center: bool = True) -> torch.Tensor:
    return _stft(y, n_fft, hop, center).abs()


def power_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa.power_to_db: 10*log10(max(amin,S)/max(amin,ref)), top_db floor."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def melspectrogram(y: torch.Tensor, sr: int, n_fft: int = 2048,
                   hop: int = 512, n_mels: int = 128,
                   fmax: Optional[float] = None) -> torch.Tensor:
    """Power mel spectrogram [frames, n_mels]."""
    S = stft_power(y, n_fft, hop)
    mel = _on_device(mel_filterbank, y.device, sr, n_fft, n_mels, 0.0, fmax)
    return S @ mel.T


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int = 20, n_fft: int = 2048,
         hop: int = 512, n_mels: int = 128) -> torch.Tensor:
    """MFCCs [frames, n_mfcc] (librosa.feature.mfcc with dct_type=2 ortho)."""
    S_db = power_to_db(melspectrogram(y, sr, n_fft, hop, n_mels))
    dct = _on_device(dct_matrix, y.device, n_mfcc, n_mels)
    return S_db @ dct.T


def onset_strength(y: torch.Tensor, sr: int, n_fft: int = 2048,
                   hop: int = 512, lag: int = 1, n_mels: int = 128,
                   center: bool = True,
                   fmax: Optional[float] = 11025.0) -> torch.Tensor:
    """Spectral-flux onset envelope [frames] (librosa.onset.onset_strength).

    Mean over mel bands of the positive lag-difference of the dB mel
    spectrogram, shifted by ``n_fft // (2*hop) + lag`` frames (librosa's
    centered compensation) and trimmed to the frame count.

    ``fmax`` defaults to 11025.0 Hz — librosa 0.8.x's
    ``onset_strength_multi`` hardcodes ``kwargs.setdefault("fmax",
    11025.0)`` for its internal melspectrogram regardless of ``sr`` (the
    reference's era; later librosa switched to sr/2).  At the reference's
    sr=30720 this shapes the mel bank and hence the envelope, onset peaks,
    and beats.
    """
    S = power_to_db(melspectrogram(y, sr, n_fft, hop, n_mels, fmax=fmax))
    diff = S[lag:] - S[:-lag]
    env = torch.clamp(diff, min=0.0).mean(dim=-1)
    pad = lag + (n_fft // (2 * hop) if center else 0)
    env = F.pad(env, (pad, 0))
    return env[:S.shape[0]]
