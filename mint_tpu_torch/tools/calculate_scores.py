"""FID scoring CLI of the port (counterpart of
``mint_tpu/tools/calculate_scores.py``, the reference
tools/calculate_scores.py).

    python -m mint_tpu_torch.tools.calculate_scores \\
        --result_files='outputs/*.npy' --feature_dir=data/aist_features \\
        [--smpl_model_path=SMPL_MALE.pkl] [--audio_cache_dir=...]

Reads generated clips of shape [120 + N, 225] (or [1, 120 + N, 225]),
drops the 120-frame seed, recovers axis-angles and translation
(SVD-projected rotations), runs SMPL forward kinematics once per clip, takes
kinetic and manual features from those joints and prints FID_k / FID_g
against the cached ground-truth features, and with ``--audio_cache_dir``
the Beat Alignment Score.  The rotations and the kinematics run in f32 on
``--device`` (the card by default; ``--device=cpu`` for the CPU); the
features and the distances are host NumPy/SciPy, as in the reference.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.eval.beat_align import clip_beat_alignment
from mint_tpu_torch.eval.features import (extract_kinetic_features,
                                          extract_manual_features)
from mint_tpu_torch.eval.fid import frechet_feature_distance
from mint_tpu_torch.motion.rotation import recover_to_axis_angles
from mint_tpu_torch.motion.smpl import SMPLModel, load_smpl, smpl_joints

log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--result_files", default="outputs/*.npy",
                   help="Glob of generated motion clips.")
    p.add_argument("--feature_dir", default="./data/aist_features/",
                   help="Cached ground-truth feature .npy dir (from "
                        "extract_features).")
    p.add_argument("--smpl_model_path", default="",
                   help="SMPL .pkl (e.g. SMPL_MALE.pkl); rest-joint "
                        "approximation used if empty.")
    p.add_argument("--seed_frames", type=int, default=120,
                   help="Leading seed frames to drop before scoring.")
    p.add_argument("--audio_cache_dir", default="",
                   help="Cached 35-dim audio feature dir; when set, also "
                        "reports the Beat Alignment Score (music beats from "
                        "feature column 34 vs kinematic beats).")
    p.add_argument("--device", default="cuda",
                   help="Device of the rotations and the kinematics: "
                        "'cuda' (the default) or 'cpu'.")
    return p.parse_args(argv)


def load_model(smpl_model_path: str) -> Optional[SMPLModel]:
    """The SMPL model at the path, or None: ``smpl_joints``' approximate
    rest joints."""
    if smpl_model_path:
        return load_smpl(smpl_model_path)
    log.warning("no --smpl_model_path; using approximate rest joints")
    return None


def joints_of(motion: np.ndarray, model: Optional[SMPLModel],
              device: torch.device | str) -> np.ndarray:
    """[1, T, 225] -> [T, 24, 3] joints (calculate_scores.py:154-162)."""
    aa, transl = recover_to_axis_angles(
        torch.as_tensor(motion, dtype=torch.float32, device=device))
    return smpl_joints(aa[0], transl[0], model, device=device).cpu().numpy()


def extract_feature(motion: np.ndarray, model: Optional[SMPLModel],
                    mode: str, joints: Optional[np.ndarray] = None,
                    device: torch.device | str = "cuda") -> np.ndarray:
    """[1, T, 225] -> the `mode` ("kinetic" or "manual") feature vector
    (the reference's per-mode API, calculate_scores.py:154-170).  Pass
    precomputed `joints` to share one FK run between both families, as
    :func:`scores` does.  Any other `mode` gives the manual feature, as
    in the JAX package."""
    if joints is None:
        joints = joints_of(motion, model, device)
    if mode == "kinetic":
        return extract_kinetic_features(joints)
    return extract_manual_features(joints)


def scores(result_files: str, feature_dir: str, smpl_model_path: str = "",
           seed_frames: int = 120, audio_cache_dir: str = "",
           device: torch.device | str = "cuda") -> Dict[str, float]:
    """FID_k, FID_g and, with `audio_cache_dir`, the Beat Alignment Score
    (``beat_align``, over ``beat_clips`` clips) of the clips that match
    `result_files` against the features in `feature_dir`."""
    real_features = {
        "kinetic": [np.load(f) for f in sorted(glob.glob(
            os.path.join(feature_dir, "*_kinetic.npy")))],
        "manual": [np.load(f) for f in sorted(glob.glob(
            os.path.join(feature_dir, "*_manual.npy")))],
    }
    if not real_features["kinetic"]:
        raise FileNotFoundError(
            f"no ground-truth features in {feature_dir}; run "
            "python -m mint_tpu_torch.tools.extract_features first")

    model = load_model(smpl_model_path)
    result_features = {"kinetic": [], "manual": []}
    beat_scores = []
    paths = sorted(glob.glob(result_files))
    if not paths:
        raise FileNotFoundError(f"no results match {result_files}")
    for i, path in enumerate(paths):
        log.info("scoring %d / %d: %s", i + 1, len(paths), path)
        motion = np.load(path)
        if motion.ndim == 2:
            motion = motion[None]
        motion = motion[:, seed_frames:]
        joints = joints_of(motion, model, device)  # one FK, both families
        for mode, feats in result_features.items():
            feats.append(extract_feature(motion, model, mode, joints))
        if audio_cache_dir:
            # {motion_name}_{audio_name}.npy -> audio_name (last field).
            audio_name = os.path.basename(path)[:-4].split("_")[-1]
            feat_path = os.path.join(audio_cache_dir, f"{audio_name}.npy")
            if os.path.exists(feat_path):
                ba = clip_beat_alignment(joints, np.load(feat_path),
                                         start_frame=seed_frames)
                if ba is not None:
                    beat_scores.append(ba)

    out = {"fid_k": frechet_feature_distance(real_features["kinetic"],
                                             result_features["kinetic"]),
           "fid_g": frechet_feature_distance(real_features["manual"],
                                             result_features["manual"])}
    if beat_scores:
        out["beat_align"] = float(np.mean(beat_scores))
        out["beat_clips"] = len(beat_scores)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    out = scores(args.result_files, args.feature_dir, args.smpl_model_path,
                 args.seed_frames, args.audio_cache_dir, args.device)
    # Reference expectation: FID_k ~38, FID_g ~27 (calculate_scores.py:223).
    print("\nEvaluation: FID_k: {:.4f}, FID_g: {:.4f}\n".format(
        out["fid_k"], out["fid_g"]))
    if "beat_align" in out:
        print("Beat Alignment Score: {:.4f} over {} clips\n".format(
            out["beat_align"], out["beat_clips"]))
    return out


if __name__ == "__main__":
    main()
