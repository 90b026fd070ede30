"""AIST++ annotation access (splits, ignore list, SMPL motion pickles); the
port's copy of ``mint_tpu/data/aist.py``.

Replaces the reference's ``aist_plusplus.loader.AISTDataset`` usage
(``tools/preprocessing.py:10,151-158``) with a dependency-free loader for
the same on-disk layout:

  anno_dir/
    splits/crossmodal_{train,val,test}.txt
    ignore_list.txt
    motions/{seq_name}.pkl   # {'smpl_poses': [T, 72],
                             #  'smpl_scaling': [1], 'smpl_trans': [T, 3]}
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np


def load_split(anno_dir: str, split: str) -> List[str]:
    """Sequence names for 'train'/'testval' etc., minus the ignore list
    (reference tools/preprocessing.py:127-143)."""
    seq_names: List[str] = []
    for part in ("train", "val", "test"):
        if part in split:
            path = os.path.join(anno_dir, "splits",
                                f"crossmodal_{part}.txt")
            # atleast_1d: a single-line file loads as a 0-d string array.
            seq_names += np.atleast_1d(
                np.loadtxt(path, dtype=str)).tolist()
    ignore_path = os.path.join(anno_dir, "ignore_list.txt")
    if os.path.exists(ignore_path):
        ignore = set(np.atleast_1d(
            np.loadtxt(ignore_path, dtype=str)).tolist())
        seq_names = [n for n in seq_names if n not in ignore]
    return seq_names


def load_motion(motion_dir: str, seq_name: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (smpl_poses [T, 72], smpl_scaling [1], smpl_trans [T, 3])."""
    with open(os.path.join(motion_dir, f"{seq_name}.pkl"), "rb") as f:
        data = pickle.load(f)
    return (np.asarray(data["smpl_poses"], np.float64),
            np.asarray(data["smpl_scaling"], np.float64).reshape(-1),
            np.asarray(data["smpl_trans"], np.float64))


def audio_name_of(seq_name: str) -> str:
    """AIST++ naming: the music id is the second-to-last underscore field."""
    return seq_name.split("_")[-2]
