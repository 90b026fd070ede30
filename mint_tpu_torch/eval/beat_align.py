"""Beat Alignment Score (AIST++ / AI Choreographer evaluation); the port's
copy of ``mint_tpu/eval/beat_align.py``.

Measures how well kinematic beats (pauses in the motion, i.e. local
minima of the mean joint-velocity envelope) align with music beats:

  BA = mean over music beats t_m of exp(-min_k ||t_k - t_m||^2 / (2 s^2))

with s = 3 frames at 60 FPS (the paper's setting).  Music beats come from
column 34 of the cached 35-dim audio features (the beat one-hot,
reference ``tools/preprocessing.py:109-117``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def velocity_envelope(joints: np.ndarray) -> np.ndarray:
    """[T, 24, 3] joints -> [T-1] mean joint speed per frame."""
    vel = np.linalg.norm(np.diff(joints, axis=0), axis=-1)  # [T-1, 24]
    return vel.mean(axis=-1)


def kinematic_beats(joints: np.ndarray,
                    smooth: int = 3) -> np.ndarray:
    """Frame indices of motion beats: local minima of the (optionally
    box-smoothed) velocity envelope."""
    env = velocity_envelope(joints)
    if smooth > 1:
        kernel = np.ones(smooth) / smooth
        env = np.convolve(env, kernel, mode="same")
    minima = np.flatnonzero(
        (env[1:-1] < env[:-2]) & (env[1:-1] <= env[2:])) + 1
    return minima


def beat_alignment_score(music_beats: Sequence[int],
                         motion_beats: Sequence[int],
                         sigma: float = 3.0) -> float:
    """BA score in [0, 1]; 1.0 = every music beat has a coincident
    kinematic beat.  Empty inputs score 0."""
    music_beats = np.asarray(music_beats, np.float64)
    motion_beats = np.asarray(motion_beats, np.float64)
    if len(music_beats) == 0 or len(motion_beats) == 0:
        return 0.0
    dists = np.abs(music_beats[:, None] - motion_beats[None, :]).min(axis=1)
    return float(np.mean(np.exp(-(dists ** 2) / (2.0 * sigma ** 2))))


def clip_beat_alignment(joints: np.ndarray,
                        audio_features: np.ndarray,
                        start_frame: int = 0,
                        sigma: float = 3.0) -> Optional[float]:
    """BA for one generated clip.

    Args:
      joints: [T, 24, 3] SMPL joints of the generated frames.
      audio_features: [T_audio, 35] cached features; column 34 is the beat
        one-hot.  `start_frame` aligns the audio to the first generated
        frame (the scorer drops the 120-frame seed, whose audio starts at
        feature frame 0 — generated frame i corresponds to audio frame
        start_frame + i).

    Returns:
      BA score, or None if no music beats fall in the clip window.
    """
    t = joints.shape[0]
    beat_col = audio_features[start_frame:start_frame + t, 34]
    music = np.flatnonzero(beat_col > 0.5)
    if len(music) == 0:
        return None
    motion = kinematic_beats(joints)
    return beat_alignment_score(music, motion, sigma=sigma)
