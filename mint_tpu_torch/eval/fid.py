"""Fréchet distance for motion feature distributions (the port's copy of
``mint_tpu/eval/fid.py``).

Numerics match the reference scorer (``tools/calculate_scores.py:82-189``):
z-normalize both feature sets by the REAL set's mean/std (+1e-10), then
d^2 = ||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) with scipy ``sqrtm`` and
the eps-on-diagonal fallback for near-singular products.

Host-side NumPy/SciPy, as in the reference (offline scoring).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (calculate_scores.py:82-151)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape
    diff = mu1 - mu2

    # Without ``disp``, which later SciPy releases removed: the same root.
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def normalize_by_reference(real: np.ndarray, gen: np.ndarray):
    """z-normalize both sets by the real set's stats
    (calculate_scores.py:177-181)."""
    mean = np.mean(real, axis=0)
    std = np.std(real, axis=0) + 1e-10
    return (real - mean) / std, (gen - mean) / std


def frechet_feature_distance(real_features: Sequence[np.ndarray],
                             gen_features: Sequence[np.ndarray]) -> float:
    """FID over per-clip feature vectors
    (calculate_scores.py:173-189)."""
    real = np.stack(real_features)
    gen = np.stack(gen_features)
    if len(real) < 2 or len(gen) < 2:
        raise ValueError(
            f"FID needs >= 2 clips per side for a covariance; got "
            f"{len(real)} real / {len(gen)} generated")
    real, gen = normalize_by_reference(real, gen)
    return frechet_distance(
        mu1=np.mean(real, axis=0), sigma1=np.cov(real, rowvar=False),
        mu2=np.mean(gen, axis=0), sigma2=np.cov(gen, rowvar=False))
