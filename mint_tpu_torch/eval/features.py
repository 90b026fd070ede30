"""Motion feature extractors for FID scoring (the port's copy of
``mint_tpu/eval/features.py``: the same host NumPy code).

Re-derives, line-faithfully, the two feature families the reference scorer
imports from the public ``aist_plusplus_api`` package
(``tools/calculate_scores.py:8-10,164-170``; package source:
github.com/google/aistplusplus_api, ``aist_plusplus/features/kinetic.py``,
``aist_plusplus/features/manual.py``, ``aist_plusplus/features/utils.py``):

- **Kinetic features** (FID_k): per-joint average horizontal/vertical
  kinetic energy and average energy expenditure, after Onuma, Faloutsos &
  Hodgins "FMDistance" (Eurographics 2008) — 24 joints x 3 = 72 dims.
- **Manual (geometric) features** (FID_g): Muller's boolean relational
  features ("Efficient Motion Search in Large Motion Capture Databases",
  VLDB 2005) in the AIST++ selection — 32 pose booleans sampled every 30th
  frame, averaged over samples.

Inputs are world-space joint positions [T, 24, 3] at 60 FPS (y-up), as
produced by :func:`mint_tpu_torch.motion.smpl.smpl_joints` (SMPL joint order,
matching the package's ``SMPL_JOINT_NAMES``).

The package is not a dependency of this repository, so exactness is
maintained by derivation discipline instead of an import test:

- every function below documents the upstream function it mirrors;
- semantics that differ from the "obvious" implementation are preserved
  deliberately and called out inline — the frame-1..T-1 ranges, the
  sliding-window edge handling, the ``cross(j3-j1, j2-j1)`` normal
  orientation, the hardcoded canonical-rest-pose limb lengths (upstream
  ``manual.py`` does NOT measure the input skeleton), the 30-frame
  sampling stride, and strict inequalities on thresholds/angles;
- ``tests/test_features.py`` pins each against an independent scalar
  transcription of the upstream loops, and ``tests/test_torch_scores.py``
  holds this copy to it.

Vectorized NumPy (host-side offline scoring, like the reference).
"""

from __future__ import annotations

import numpy as np

from mint_tpu_torch.motion.smpl import SMPL_JOINT_NAMES

_FPS = 60.0
_FRAME_TIME = 1.0 / _FPS
_J = {name: i for i, name in enumerate(SMPL_JOINT_NAMES)}

# Canonical SMPL rest-pose landmarks hardcoded by upstream
# ``manual.py::ManualFeatures.__init__`` (NOT measured from the input
# motion) — transcribed constants, joint labels per upstream comments.
_CANON_LSHOULDER = np.array([0.1959, 0.2387, -0.01465])
_CANON_LELBOW = np.array([0.4272, 0.2345, -0.02173])
_CANON_RSHOULDER = np.array([-0.1998, 0.2310, -0.01625])
_CANON_LHIP = np.array([0.05640, -0.3258, 0.01141])
_CANON_RHIP = np.array([-0.06091, -0.3310, 0.008064])

# Humerus length / shoulder width / hip width thresholds' length units.
HL = float(np.linalg.norm(_CANON_LSHOULDER - _CANON_LELBOW))
SW = float(np.linalg.norm(_CANON_LSHOULDER - _CANON_RSHOULDER))
HW = float(np.linalg.norm(_CANON_LHIP - _CANON_RHIP))

# Upstream ``manual.py`` advances 30 frames per sample (0.5 s at 60 FPS).
_MANUAL_STRIDE = 30


# ---------------------------------------------------------------------------
# Kinetic features (upstream kinetic.py + utils.py)
# ---------------------------------------------------------------------------


def _sliding_velocity(positions: np.ndarray, window: int = 2) -> np.ndarray:
    """Mean-velocity vectors for frames 1..T-1 -> [T-1, J, 3].

    Upstream ``utils.calc_average_velocity``: for frame i, sum the raw
    displacements ``p[i+j] - p[i+j-1]`` over offsets j in [-w, w] with
    ``i+j-1 >= 0`` and ``i+j < T``, divide by (count * frame_time).
    """
    diffs = positions[1:] - positions[:-1]  # diffs[k] = p[k+1] - p[k]
    t = diffs.shape[0]  # = T-1; row i' corresponds to frame i = i'+1
    acc = np.zeros_like(diffs)
    cnt = np.zeros((t, 1, 1))
    for j in range(-window, window + 1):
        lo, hi = max(0, -j), min(t, t - j)
        acc[lo:hi] += diffs[lo + j:hi + j]
        cnt[lo:hi] += 1
    return acc / (cnt * _FRAME_TIME)


def _sliding_acceleration(positions: np.ndarray,
                          window: int = 2) -> np.ndarray:
    """Mean-acceleration vectors for frames 1..T-1 -> [T-1, J, 3].

    Upstream ``utils.calc_average_acceleration``: for frame i, average
    the second differences ``(p[k+1] - 2 p[k] + p[k-1]) / frame_time**2``
    centered at k = i+j over offsets j in [-w, w] with ``i+j-1 >= 0`` and
    ``i+j+1 < T``.  NOTE the range runs to frame T-1 inclusive (its window
    is just truncated to j < 0), and the final division is by the count
    only — the frame_time factors live inside the second difference.
    """
    acc2 = (positions[2:] - 2 * positions[1:-1]
            + positions[:-2]) / (_FRAME_TIME ** 2)  # center frame k = idx+1
    n2 = acc2.shape[0]  # = T-2
    t = positions.shape[0] - 1  # rows for frames 1..T-1
    out = np.zeros((t,) + positions.shape[1:])
    cnt = np.zeros((t, 1, 1))
    for j in range(-window, window + 1):
        # row i' (frame i = i'+1) needs acc2 index i'+j in [0, n2).
        lo, hi = max(0, -j), min(t, n2 - j)
        if lo >= hi:
            continue
        out[lo:hi] += acc2[lo + j:hi + j]
        cnt[lo:hi] += 1
    return out / cnt


def extract_kinetic_features(positions: np.ndarray) -> np.ndarray:
    """[T, 24, 3] joints -> 72-dim kinetic feature vector (float32).

    Upstream ``kinetic.py::extract_kinetic_features``: per joint, hstack of
    [average horizontal kinetic energy, average vertical kinetic energy,
    average energy expenditure], each a mean over frames 1..T-1; y-up
    (``up_vec="y"``), frame_time 1/60, sliding_window 2.
    """
    positions = np.asarray(positions, np.float64)
    assert positions.ndim == 3, positions.shape
    v = _sliding_velocity(positions)       # [T-1, J, 3]
    a = _sliding_acceleration(positions)   # [T-1, J, 3]
    # calc_average_velocity_horizontal(up_vec="y"): norm of (x, z).
    v_h = np.linalg.norm(v[..., [0, 2]], axis=-1)
    # calc_average_velocity_vertical(up_vec="y"): norm of (y,) = |y|.
    v_v = np.abs(v[..., 1])
    e_h = (v_h ** 2).mean(axis=0)
    e_v = (v_v ** 2).mean(axis=0)
    e_a = np.linalg.norm(a, axis=-1).mean(axis=0)
    feats = np.stack([e_h, e_v, e_a], axis=-1)   # [J, 3], joint-major
    return feats.reshape(-1).astype(np.float32)  # 72


# ---------------------------------------------------------------------------
# Manual (geometric / Muller relational) features (upstream manual.py)
# ---------------------------------------------------------------------------


class _Frame:
    """Joint access for one frame, with upstream's virtual joints
    (``manual.py::ManualFeatures.transform_and_fetch_position``)."""

    def __init__(self, pos_t: np.ndarray):
        self.pos = pos_t  # [24, 3]

    def get(self, name: str) -> np.ndarray:
        if name == "zero":
            return np.zeros(3)
        if name == "y_unit":
            return np.array([0.0, 1.0, 0.0])
        if name == "minus_y_unit":
            return np.array([0.0, -1.0, 0.0])
        if name == "y_min":
            # [0, min over joints of y at the CURRENT frame, 0].
            return np.array([0.0, self.pos[:, 1].min(), 0.0])
        return self.pos[_J[name]]


def _angle(f: _Frame, j1, j2, k1, k2, lo_deg, hi_deg) -> float:
    """f_angle -> utils.angle_within_range: strict inequalities on the
    angle between (j2-j1) and (k2-k1) in degrees."""
    u = f.get(j2) - f.get(j1)
    w = f.get(k2) - f.get(k1)
    nu, nw = np.linalg.norm(u), np.linalg.norm(w)
    if nu < 1e-12 or nw < 1e-12:
        return 0.0  # upstream divides by 0 -> nan -> comparison False
    ang = np.degrees(np.arccos(np.clip(np.dot(u, w) / (nu * nw), -1, 1)))
    return float(lo_deg < ang < hi_deg)


def _plane(f: _Frame, j1, j2, j3, j4, threshold) -> float:
    """f_plane -> utils.distance_from_plane: signed distance of j4 from
    the plane through j1 with normal cross(j3-j1, j2-j1) — note the
    argument order (ca x ba), which sets the sign."""
    p1, p2, p3, p4 = f.get(j1), f.get(j2), f.get(j3), f.get(j4)
    n = np.cross(p3 - p1, p2 - p1)
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return 0.0
    return float(np.dot(n, p4 - p1) / nn > threshold)


def _nplane(f: _Frame, j1, j2, j3, j4, threshold) -> float:
    """f_nplane -> utils.distance_from_plane_normal: signed distance of
    j4 from the plane through j3 with normal direction (j2-j1)."""
    p1, p2, p3, p4 = f.get(j1), f.get(j2), f.get(j3), f.get(j4)
    n = p2 - p1
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return 0.0
    return float(np.dot(n, p4 - p3) / nn > threshold)


def _move(f: _Frame, fp: _Frame, j1, j2, j3, j4, threshold) -> float:
    """f_move -> utils.velocity_direction_above_threshold: velocity of j4
    relative to j3, projected on direction (j2-j1), per second."""
    n = f.get(j2) - f.get(j1)
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return 0.0
    v = (f.get(j4) - fp.get(j4)) - (f.get(j3) - fp.get(j3))
    return float(np.dot(v, n / nn) / _FRAME_TIME > threshold)


def _nmove(f: _Frame, fp: _Frame, j1, j2, j3, j4, threshold) -> float:
    """f_nmove -> utils.velocity_direction_above_threshold_normal:
    velocity of j4 projected on cross(j3-j1, j2-j1) — j31 FIRST, which
    sets the sign."""
    p1 = f.get(j1)
    n = np.cross(f.get(j3) - p1, f.get(j2) - p1)
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return 0.0
    v = f.get(j4) - fp.get(j4)
    return float(np.dot(v, n / nn) / _FRAME_TIME > threshold)


def _fast(f: _Frame, fp: _Frame, j, threshold) -> float:
    """f_fast -> utils.velocity_above_threshold."""
    v = np.linalg.norm(f.get(j) - fp.get(j)) / _FRAME_TIME
    return float(v > threshold)


def _pose_features(f: _Frame, fp: _Frame) -> list:
    """The 32 expressions of upstream ``extract_manual_features``, in
    order, with upstream's thresholds in canonical-rest-pose units."""
    return [
        _nmove(f, fp, "neck", "rhip", "lhip", "rwrist", 1.8 * HL),
        _nmove(f, fp, "neck", "lhip", "rhip", "lwrist", 1.8 * HL),
        _nplane(f, "chest", "neck", "neck", "rwrist", 0.2 * HL),
        _nplane(f, "chest", "neck", "neck", "lwrist", 0.2 * HL),
        _move(f, fp, "belly", "chest", "chest", "rwrist", 1.8 * HL),
        _move(f, fp, "belly", "chest", "chest", "lwrist", 1.8 * HL),
        _angle(f, "relbow", "rshoulder", "relbow", "rwrist", 0, 110),
        _angle(f, "lelbow", "lshoulder", "lelbow", "lwrist", 0, 110),
        _nplane(f, "lshoulder", "rshoulder", "lwrist", "rwrist", 2.5 * SW),
        _move(f, fp, "lwrist", "rwrist", "rwrist", "lwrist", 1.4 * HL),
        _move(f, fp, "rwrist", "root", "lwrist", "root", 1.4 * HL),
        _move(f, fp, "lwrist", "root", "rwrist", "root", 1.4 * HL),
        _fast(f, fp, "rwrist", 2.5 * HL),
        _fast(f, fp, "lwrist", 2.5 * HL),
        _plane(f, "root", "lhip", "ltoes", "rankle", 0.38 * HL),
        _plane(f, "root", "rhip", "rtoes", "lankle", 0.38 * HL),
        _nplane(f, "zero", "y_unit", "y_min", "rankle", 1.2 * HL),
        _nplane(f, "zero", "y_unit", "y_min", "lankle", 1.2 * HL),
        _nplane(f, "lhip", "rhip", "lankle", "rankle", 2.1 * HW),
        _angle(f, "rknee", "rhip", "rknee", "rankle", 0, 110),
        _angle(f, "lknee", "lhip", "lknee", "lankle", 0, 110),
        _fast(f, fp, "rankle", 2.5 * HL),
        _fast(f, fp, "lankle", 2.5 * HL),
        _angle(f, "neck", "root", "rshoulder", "relbow", 25, 180),
        _angle(f, "neck", "root", "lshoulder", "lelbow", 25, 180),
        _angle(f, "neck", "root", "rhip", "rknee", 50, 180),
        _angle(f, "neck", "root", "lhip", "lknee", 50, 180),
        _plane(f, "rankle", "neck", "lankle", "root", 0.5 * HL),
        _angle(f, "neck", "root", "zero", "y_unit", 70, 110),
        _nplane(f, "zero", "minus_y_unit", "y_min", "rwrist", -1.2 * HL),
        _nplane(f, "zero", "minus_y_unit", "y_min", "lwrist", -1.2 * HL),
        _fast(f, fp, "root", 2.3 * HL),
    ]


def extract_manual_features(positions: np.ndarray) -> np.ndarray:
    """[T, 24, 3] joints -> 32-dim feature vector (float32).

    Upstream ``manual.py::extract_manual_features``: evaluate the 32 pose
    booleans at frames 1, 31, 61, ... (stride 30 — ``next_frame`` advances
    30), each against the immediately previous frame, then mean over the
    sampled frames.  Thresholds use the hardcoded canonical limb lengths
    (HL/SW/HW above), not the input skeleton's.
    """
    positions = np.asarray(positions, np.float64)
    assert positions.ndim == 3, positions.shape
    rows = []
    for t in range(1, positions.shape[0], _MANUAL_STRIDE):
        f = _Frame(positions[t])
        fp = _Frame(positions[t - 1])
        rows.append(_pose_features(f, fp))
    return np.asarray(rows, np.float32).mean(axis=0)
