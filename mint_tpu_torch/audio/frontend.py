"""The 35-dim AIST++ audio feature frontend (the port's counterpart of
``mint_tpu/audio/frontend.py``).

Assembles per-frame features exactly as the reference caches them
(reference ``tools/preprocessing.py:77-118``): at SR = 60 fps x 512 hop =
30720 Hz,

  [onset envelope (1) | MFCC (20) | CENS chroma (12) | onset-peak one-hot
   (1) | beat one-hot (1)]  ->  [T, 35] float32

including the music-name -> start-BPM seeding rule for the beat tracker
(``_get_tempo``, preprocessing.py:82-90).

The STFT, mel, MFCC, onset flux and the CQT run on ``device``: the card by
default, the CPU when the caller asks for it (``device="cpu"``, as the
tests do); without a card the default raises.  Resampling, peak picking,
the beat tracker, the tuning histogram and CENS are host NumPy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mint_tpu_torch.audio import beat as beat_lib
from mint_tpu_torch.audio import cqt as cqt_lib
from mint_tpu_torch.audio import onset as onset_lib
from mint_tpu_torch.audio import resample as resample_lib
from mint_tpu_torch.audio import spectral
from mint_tpu_torch.utils.device import resolve

FPS = 60
HOP_LENGTH = 512
SR = FPS * HOP_LENGTH  # 30720


def tempo_from_name(audio_name: str) -> int:
    """AIST++ music-name -> BPM rule (preprocessing.py:82-90)."""
    assert len(audio_name) == 4, audio_name
    genre = audio_name[:3]
    if genre in ("mBR", "mPO", "mLO", "mMH", "mLH", "mWA", "mKR", "mJS",
                 "mJB"):
        return int(audio_name[3]) * 10 + 80
    if genre == "mHO":
        return int(audio_name[3]) * 5 + 110
    raise ValueError(f"unknown AIST++ music name: {audio_name}")


def extract_audio_features(y: np.ndarray, sr: int = SR,
                           start_bpm: Optional[float] = None,
                           device: torch.device | str = "cuda"
                           ) -> np.ndarray:
    """[T] mono audio at `sr` -> [T_frames, 35] feature matrix."""
    device = resolve(device, "extract_audio_features")
    if sr != SR:
        y = resample_lib.resample(y, sr, SR)
    y = np.asarray(y, np.float32)
    yd = torch.from_numpy(y).to(device)
    envelope = spectral.onset_strength(yd, SR).cpu().numpy()      # [T]
    mfcc = spectral.mfcc(yd, SR, n_mfcc=20).cpu().numpy()         # [T, 20]
    chroma = cqt_lib.chroma_cens(y, SR, hop=HOP_LENGTH, n_chroma=12,
                                 device=device)                   # [T, 12]

    peak_idxs = onset_lib.onset_detect(envelope, SR, HOP_LENGTH)
    peak_onehot = np.zeros_like(envelope, dtype=np.float32)
    peak_onehot[peak_idxs] = 1.0

    _, beat_idxs = beat_lib.beat_track(
        envelope, SR, HOP_LENGTH,
        start_bpm=float(start_bpm) if start_bpm else 120.0,
        tightness=100.0)
    beat_onehot = np.zeros_like(envelope, dtype=np.float32)
    beat_onehot[beat_idxs] = 1.0

    t = min(len(envelope), mfcc.shape[0], chroma.shape[0])
    return np.concatenate([
        envelope[:t, None].astype(np.float32),
        mfcc[:t].astype(np.float32),
        chroma[:t].astype(np.float32),
        peak_onehot[:t, None],
        beat_onehot[:t, None],
    ], axis=-1)


class AudioFeatureExtractor:
    """File-level extractor with the reference's .npy cache layout,
    extracting on `device`."""

    def __init__(self, audio_dir: str, cache_dir: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        self.audio_dir = audio_dir
        self.cache_dir = cache_dir
        self.device = resolve(device, "AudioFeatureExtractor")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __call__(self, audio_name: str) -> np.ndarray:
        if self.cache_dir:
            cache_path = os.path.join(self.cache_dir, f"{audio_name}.npy")
            if os.path.exists(cache_path):
                return np.load(cache_path)
        y, _ = resample_lib.load(
            os.path.join(self.audio_dir, f"{audio_name}.wav"), sr=SR)
        feats = extract_audio_features(
            y, SR, start_bpm=tempo_from_name(audio_name), device=self.device)
        if self.cache_dir:
            np.save(cache_path, feats)
        return feats
