"""Constant-Q transform, chroma, and CENS features (the port's counterpart
of ``mint_tpu/audio/cqt.py``).

Implements the feature chain behind the reference's
``librosa.feature.chroma_cens(data, sr, hop_length=512, n_chroma=12)`` call
(reference ``tools/preprocessing.py:100-102``):

1. tuning estimation from pitch-tracked STFT peaks (piptrack + histogram),
2. a constant-Q transform (7 octaves x 36 bins from C1, Q-matched
   Hann-windowed complex sinc kernels, L1-normalized, 1/sqrt(len) scaling),
   computed with the Brown-Puckette frequency-domain kernel method: one big
   rFFT per frame and a complex [frames, bins] projection per octave band —
   the single-resolution exact form of librosa's recursive-downsampling CQT,
3. fold to 12 pitch classes (merge 3 adjacent bins, C-aligned),
4. CENS: per-frame L1 normalize, 4-level quantization
   ({0.05,0.1,0.2,0.4} thresholds, 0.25 weight each), length-43 Hann
   smoothing, per-frame L2 normalize.

The STFT of the pitch tracker, the CQT's rFFT and its projections (four
real f32 matmuls per octave band) run on the `device` the caller names, in
512-frame chunks so a long track's memory stays bounded; the kernels are
built in NumPy (f64, kept in f32) once per (sr, tuning) and cached on the
device.  Peak picking in the tracker, the tuning histogram, the chroma fold
and CENS are host NumPy, copied from the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mint_tpu_torch.audio.spectral import hann_window, stft_magnitude

C1_HZ = 32.70319566257483  # note_to_hz('C1')
_TINY = np.finfo(np.float64).tiny  # librosa util.tiny for float64


# ---------------------------------------------------------------------------
# Tuning estimation (librosa.estimate_tuning / piptrack / pitch_tuning)
# ---------------------------------------------------------------------------


def piptrack(y: np.ndarray, sr: int, n_fft: int = 2048,
             hop: int = 512, fmin: float = 150.0, fmax: float = 4000.0,
             threshold: float = 0.1, device: torch.device | str = "cuda"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Parabolic-interpolation pitch tracking on STFT magnitude peaks (the
    STFT on `device`, the rest on the host).

    Returns (pitches, mags), each [n_bins, frames].
    """
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    S = stft_magnitude(y, n_fft, hop).cpu().numpy().T
    fmax = min(fmax, sr / 2.0)

    # Parabolic interpolation around each bin.
    avg = np.zeros_like(S)
    shift = np.zeros_like(S)
    avg[1:-1] = 0.5 * (S[2:] - S[:-2])
    shift[1:-1] = 2 * S[1:-1] - S[2:] - S[:-2]
    shift = avg / (shift + (np.abs(shift) < np.finfo(S.dtype).tiny))

    pitches = np.zeros_like(S)
    mags = np.zeros_like(S)
    freq_bins = np.arange(S.shape[0])
    ref = threshold * S.max(axis=0, keepdims=True)
    # librosa: local maxima of the THRESHOLDED spectrum S*(S > ref) along
    # frequency (edge-padded, so the top bin can be a max), restricted to
    # fmin <= f < fmax (strict upper bound).
    St = S * (S > ref)
    Sp = np.pad(St, ((1, 1), (0, 0)), mode="edge")
    localmax = (St > Sp[:-2]) & (St >= Sp[2:])
    fft_freqs = np.linspace(0, sr / 2, S.shape[0])
    in_range = ((fft_freqs >= fmin) & (fft_freqs < fmax))[:, None]
    idx = np.where(localmax & in_range)
    pitches[idx] = (freq_bins[idx[0]] + shift[idx]) * sr / n_fft
    mags[idx] = S[idx] + 0.5 * avg[idx] * shift[idx]
    return pitches, mags


def pitch_tuning(frequencies: np.ndarray, resolution: float = 0.01,
                 bins_per_octave: int = 36) -> float:
    """Histogram-mode tuning deviation in fractional bins."""
    frequencies = np.atleast_1d(frequencies)
    frequencies = frequencies[frequencies > 0]
    if not len(frequencies):
        return 0.0
    octs = np.log2(frequencies / (440.0 / 16))  # hz_to_octs
    residual = np.mod(bins_per_octave * octs, 1.0)
    residual[residual >= 0.5] -= 1.0
    bins = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, edges = np.histogram(residual, bins)
    return float(edges[np.argmax(counts)])


def estimate_tuning(y: np.ndarray, sr: int, bins_per_octave: int = 36,
                    device: torch.device | str = "cuda", **kwargs) -> float:
    """librosa.estimate_tuning.  ``bins_per_octave`` defaults to 36: the
    chroma_cens -> chroma_cqt -> cqt chain estimates tuning at the CQT's
    bin resolution (librosa cqt passes its own bins_per_octave through)."""
    pitches, mags = piptrack(y, sr, device=device, **kwargs)
    mask = pitches > 0
    threshold = np.median(mags[mask]) if mask.any() else 0.0
    return pitch_tuning(pitches[(mags >= threshold) & mask],
                        bins_per_octave=bins_per_octave)


# ---------------------------------------------------------------------------
# Constant-Q transform (Brown-Puckette kernel method, single resolution)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                 filter_scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray,
                                                     int]:
    """Frequency-domain CQT kernels.

    Returns (fft_basis [n_bins, n_fft//2+1] complex64, lengths [n_bins],
    n_fft).  Filter construction transcribes librosa filters.constant_q +
    __cqt_filter_fft: complex exponentials over ``arange(-ilen//2,
    ilen//2)`` of the FLOAT length (so filters span ceil(length) samples),
    windowed with a PERIODIC Hann (get_window fftbins=True), L1
    normalized, center-padded into the power-of-two n_fft, and scaled by
    length/n_fft.
    """
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = q * sr / freqs
    n_fft = 1 << int(math.ceil(math.log2(max(lengths))))

    basis = np.zeros((n_bins, n_fft), np.complex128)
    for k, (f, flen) in enumerate(zip(freqs, lengths)):
        t = np.arange(-flen // 2, flen // 2, dtype=np.float64)
        sig = np.exp(2j * np.pi * f * t / sr)
        sig = sig * hann_window(len(sig), fftbins=True)
        sig /= np.sum(np.abs(sig))  # L1 norm
        start = (n_fft - len(sig)) // 2
        basis[k, start:start + len(sig)] = sig * (flen / n_fft)
    fft_basis = np.fft.fft(basis, n_fft, axis=1)[:, :n_fft // 2 + 1]
    return fft_basis.astype(np.complex64), lengths.astype(np.float32), n_fft


@functools.lru_cache(maxsize=8)
def _cqt_band_groups(sr: int, fmin: float, n_bins: int,
                     bins_per_octave: int,
                     energy_keep: float = 0.9999) -> tuple:
    """Band-limited projection blocks, one per octave.

    Each CQT kernel's spectrum is concentrated around its center
    frequency, so projecting the full rFFT against all 252 kernels wastes
    >95% of the matmul.  Group kernels by octave and keep only the
    contiguous frequency-bin range carrying `energy_keep` of every row's
    L1 energy (librosa sparsifies its kernels the same way).

    Returns ((row_lo, row_hi, col_lo, col_hi) ...) plus the dense basis —
    see :func:`_cqt_kernels` for the basis itself.
    """
    fft_basis, _, n_fft = _cqt_kernels(sr, fmin, n_bins, bins_per_octave)
    groups = []
    for row_lo in range(0, n_bins, bins_per_octave):
        row_hi = min(n_bins, row_lo + bins_per_octave)
        block = np.abs(fft_basis[row_lo:row_hi])
        # Per-row L1-energy band, then the union across the octave.
        lo, hi = block.shape[1], 0
        for row in block:
            order = np.argsort(row)[::-1]
            csum = np.cumsum(row[order])
            keep = order[:max(1, int(np.searchsorted(
                csum, energy_keep * csum[-1])) + 1)]
            lo = min(lo, int(keep.min()))
            hi = max(hi, int(keep.max()) + 1)
        groups.append((row_lo, row_hi, lo, hi))
    return tuple(groups)


@functools.lru_cache(maxsize=8)
def _device_bands(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                  device: torch.device) -> tuple:
    """((col_lo, col_hi, real block, imaginary block), ...): each octave's
    band of the basis as two f32 [rows, band] tensors on `device`."""
    fft_basis, _, _ = _cqt_kernels(sr, fmin, n_bins, bins_per_octave)
    out = []
    for row_lo, row_hi, col_lo, col_hi in _cqt_band_groups(
            sr, fmin, n_bins, bins_per_octave):
        block = fft_basis[row_lo:row_hi, col_lo:col_hi]
        out.append((col_lo, col_hi,
                    torch.from_numpy(np.real(block).copy()).to(device),
                    torch.from_numpy(np.imag(block).copy()).to(device)))
    return tuple(out)


def cqt_magnitude(y: np.ndarray, sr: int, hop: int = 512,
                  fmin: float = C1_HZ, n_bins: int = 252,
                  bins_per_octave: int = 36, tuning: float = 0.0,
                  scale: bool = True, chunk: int = 512,
                  device: torch.device | str = "cuda") -> np.ndarray:
    """|CQT| -> [frames, n_bins], computed on `device`."""
    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    _, lengths, n_fft = _cqt_kernels(sr, fmin, n_bins, bins_per_octave)
    if len(y) == 0:
        raise ValueError("empty input to CQT")
    device = torch.device(device)
    bands = _device_bands(sr, fmin, n_bins, bins_per_octave, device)
    total = len(y)
    n_frames = total // hop + 1
    if total <= n_fft // 2:
        # Shorter than half the longest kernel: the in-kernel single
        # reflection cannot fill a centered frame.  librosa's recursive
        # CQT pads per octave at downsampled rates and handles such
        # inputs; the single-resolution equivalent is repeated reflection
        # at full rate — numpy's 'reflect' pad does exactly that, and the
        # signal is short so the padded host copy is cheap.  All frames
        # fit one chunk ([n_frames, n_fft] with n_frames <= 65).
        ypad = np.pad(np.asarray(y, np.float32), n_fft // 2,
                      mode="reflect" if total > 1 else "edge")
        C = _cqt_chunk(torch.from_numpy(ypad).to(device), bands, n_fft, hop,
                       0, n_frames).cpu().numpy()
    else:
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        outs = []
        step_frames = max(1, chunk)
        for f0 in range(0, n_frames, step_frames):
            f1 = min(n_frames, f0 + step_frames)
            s0 = f0 * hop
            s1 = (f1 - 1) * hop + 1
            # Pass enough left/right context so interior chunks see the
            # exact centered frames; reflect padding only applies at track
            # edges.
            lo = max(0, s0 - n_fft // 2)
            hi = min(total, s1 + n_fft // 2)
            pad_l = n_fft // 2 - (s0 - lo)
            outs.append(_cqt_chunk(yd[lo:hi], bands, n_fft, hop, pad_l,
                                   f1 - f0))
        C = torch.cat(outs).cpu().numpy()
    if scale:
        C = C / np.sqrt(lengths)[None, :]
    return C


def _cqt_chunk(seg: torch.Tensor, bands: tuple, n_fft: int, hop: int,
               pad_l: int, n_frames: int) -> torch.Tensor:
    """rFFT the frames once, then one band-limited complex product per
    octave block (bands from :func:`_device_bands`), as four real f32
    matmuls."""
    if pad_l > 0:
        seg = torch.cat([seg[1:pad_l + 1].flip(0), seg])
    need = (n_frames - 1) * hop + n_fft
    if seg.shape[0] < need:
        extra = need - seg.shape[0]
        seg = torch.cat([seg, seg[-extra - 1:-1].flip(0)])
    spec = torch.fft.rfft(seg.unfold(0, n_fft, hop)[:n_frames], n=n_fft,
                          dim=-1)
    parts = []
    for col_lo, col_hi, br, bi in bands:
        sub = spec[:, col_lo:col_hi]
        sr_, si_ = sub.real, sub.imag
        real = sr_ @ br.T - si_ @ bi.T
        imag = sr_ @ bi.T + si_ @ br.T
        parts.append(torch.sqrt(real * real + imag * imag))
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# Chroma + CENS
# ---------------------------------------------------------------------------


def _normalize(X: np.ndarray, norm: float, axis: int) -> np.ndarray:
    """librosa.util.normalize: sub-threshold columns left unscaled."""
    if norm == 1:
        length = np.abs(X).sum(axis=axis, keepdims=True)
    elif norm == 2:
        length = np.sqrt((X * X).sum(axis=axis, keepdims=True))
    else:
        raise ValueError(norm)
    length = np.where(length < _TINY, 1.0, length)
    return X / length


def chroma_cqt(y: np.ndarray, sr: int, hop: int = 512, n_chroma: int = 12,
               n_octaves: int = 7, bins_per_octave: int = 36,
               tuning: Optional[float] = None,
               device: torch.device | str = "cuda") -> np.ndarray:
    """[frames, n_chroma] chroma from |CQT| (norm=None, like chroma_cens
    uses it)."""
    if tuning is None:
        # librosa's cqt passes ITS bins_per_octave to the tuning estimate
        # — the tuning offset is in units of this resolution's bins.
        tuning = estimate_tuning(y, sr, bins_per_octave=bins_per_octave,
                                 device=device)
    C = cqt_magnitude(y, sr, hop=hop, tuning=tuning,
                      n_bins=n_octaves * bins_per_octave,
                      bins_per_octave=bins_per_octave, device=device)
    return fold_cq_to_chroma(C, n_octaves, n_chroma, bins_per_octave)


def fold_cq_to_chroma(C: np.ndarray, n_octaves: int, n_chroma: int,
                      bins_per_octave: int) -> np.ndarray:
    """Fold [frames, n_octaves*bins_per_octave] |CQT| to [frames,
    n_chroma] per librosa ``filters.cq_to_chroma``.

    Two rolls in the librosa basis: (a) the axis-1 BIN-CENTERING roll
    ``np.roll(M, -(n_merge // 2), axis=1)`` ("roll it left to center on
    the target bin") — pitch class c sums bins {c*m - m//2, ...,
    c*m + m - 1 - m//2} (for 36→12: {3c-1, 3c, 3c+1}), equivalent to
    rolling the CQT bins RIGHT by m//2 before a contiguous fold; (b) the
    axis-0 base-C alignment roll, which is 0 for the C1 basis
    (``round(mod(hz_to_midi(C1), 12) * n_chroma/12) = 0``)."""
    n_merge = bins_per_octave // n_chroma
    C = np.roll(C, n_merge // 2, axis=1)
    C = C.reshape(C.shape[0], n_octaves, n_chroma, n_merge)
    return C.sum(axis=(1, 3))


def cens_from_chroma(chroma: np.ndarray,
                     win_len_smooth: int = 41) -> np.ndarray:
    """The CENS post-chain on a raw [frames, n_chroma] chroma
    (librosa.feature.chroma_cens after its chroma_cqt call): per-frame L1
    normalize, 4-level quantization (steps {0.4,0.2,0.1,0.05}, weight 0.25
    each, strict >), symmetric-Hann(win+2) temporal smoothing with zero
    ('fill') boundaries, per-frame L2 normalize."""
    chroma = _normalize(chroma, norm=1, axis=1)

    steps = np.array([0.4, 0.2, 0.1, 0.05])
    weights = np.array([0.25, 0.25, 0.25, 0.25])
    quant = np.zeros_like(chroma)
    for s, w in zip(steps, weights):
        quant += w * (chroma > s)

    win = hann_window(win_len_smooth + 2, fftbins=False)
    win /= win.sum()
    # convolve1d along time, zero-padded ('constant') boundaries.
    pad = len(win) // 2
    padded = np.pad(quant, ((pad, pad), (0, 0)))
    out = np.empty_like(chroma)
    for c in range(chroma.shape[1]):
        out[:, c] = np.convolve(padded[:, c], win, mode="valid")[
            :chroma.shape[0]]
    return _normalize(out, norm=2, axis=1)


def chroma_cens(y: np.ndarray, sr: int, hop: int = 512,
                n_chroma: int = 12, win_len_smooth: int = 41,
                tuning: Optional[float] = None,
                device: torch.device | str = "cuda") -> np.ndarray:
    """CENS chroma [frames, n_chroma] (librosa.feature.chroma_cens)."""
    chroma = chroma_cqt(y, sr, hop=hop, n_chroma=n_chroma, tuning=tuning,
                        device=device)
    return cens_from_chroma(chroma, win_len_smooth)
