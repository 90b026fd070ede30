"""Ground-truth feature extraction CLI of the port (counterpart of
``mint_tpu/tools/extract_features.py``, the reference
tools/extract_aist_features.py).

    python -m mint_tpu_torch.tools.extract_features \\
        --anno_dir=/path/to/aist_plusplus_final --save_dir=data/aist_features

For every AIST++ sequence of the train, val and test splits not on the
ignore list: SMPL joints by forward kinematics, then kinetic and manual
features saved as ``{save_dir}/{seq_name}_{kinetic,manual}.npy``.

The kinematics run on ``--device``: the card by default, one sequence after
the other in this process; with ``--device=cpu``, ``--workers`` spawned
processes share the sequences (``--workers=0``: inline).  Workers never
open the card.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.data import aist
from mint_tpu_torch.eval.features import (extract_kinetic_features,
                                          extract_manual_features)
from mint_tpu_torch.motion.smpl import SMPLModel, smpl_joints
from mint_tpu_torch.tools.calculate_scores import load_model

log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--anno_dir", default="/mnt/data/aist_plusplus_final/",
                   help="AIST++ annotation dir.")
    p.add_argument("--smpl_model_path", default="",
                   help="SMPL .pkl; approximation used if empty.")
    p.add_argument("--save_dir", default="./data/aist_features/",
                   help="Output feature dir.")
    p.add_argument("--workers", type=int, default=12,
                   help="Process pool size with --device=cpu (0 = inline); "
                        "on the card the sequences run inline.")
    p.add_argument("--device", default="cuda",
                   help="Device of the kinematics: 'cuda' (the default) or "
                        "'cpu'.")
    return p.parse_args(argv)


def _worker_init() -> None:
    # One thread a worker: the pool is the parallelism.
    torch.set_num_threads(1)


def _process(seq_name: str, motion_dir: str, model: Optional[SMPLModel],
             save_dir: str, device: str) -> None:
    log.info("processing %s", seq_name)
    poses, scaling, trans = aist.load_motion(motion_dir, seq_name)
    t = poses.shape[0]
    joints = smpl_joints(poses.reshape(t, 24, 3), trans / scaling, model,
                         device=device).cpu().numpy()
    np.save(os.path.join(save_dir, f"{seq_name}_kinetic.npy"),
            extract_kinetic_features(joints))
    np.save(os.path.join(save_dir, f"{seq_name}_manual.npy"),
            extract_manual_features(joints))


def extract(args: argparse.Namespace) -> None:
    """Write the features of every sequence of the splits."""
    os.makedirs(args.save_dir, exist_ok=True)
    model = load_model(args.smpl_model_path)
    seq_names = (aist.load_split(args.anno_dir, "train")
                 + aist.load_split(args.anno_dir, "testval"))
    motion_dir = os.path.join(args.anno_dir, "motions")
    jobs = [(s, motion_dir, model, args.save_dir, args.device)
            for s in seq_names]
    if args.workers and torch.device(args.device).type == "cpu":
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.workers, initializer=_worker_init) as pool:
            pool.starmap(_process, jobs)
    else:
        for job in jobs:
            _process(*job)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    extract(parse_args(argv))


if __name__ == "__main__":
    main()
