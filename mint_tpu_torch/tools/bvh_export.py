"""BVH export of the port (counterpart of ``mint_tpu/tools/bvh_export.py``,
the reference tools/bvh_writer.py + templates/smpl_header.txt).

    python -m mint_tpu_torch.tools.bvh_export --motion_pkl=motion.pkl \\
        --output=motion.bvh [--skeleton_csv=...] [--frame_rate=60]

Writes SMPL motion (either raw ``smpl_poses``/``smpl_trans`` or predicted
``pred_motion`` 9D rotmats, SVD-projected) as a BVH file: ZYX rotation
channels in degrees, 6-channel root, End Sites at the leaf joints.

The rotation conversions run in f32 on ``device`` (``--device``): the card
by default, the CPU when asked (``cpu``); without a card the default
raises.  The text is written on the host.

Differences from the reference, deliberate:
- the joint hierarchy is generated from the SMPL kinematic tree (24
  joints, :data:`mint_tpu_torch.motion.smpl.SMPL_PARENTS`) instead of a Mako
  template + skeleton CSV (neither data file ships with the reference);
  a skeleton CSV can still override the rest offsets.
- the axis-angle -> Euler conversion goes aa -> rotmat -> euler
  (R = Rz Ry Rx); the reference's ``BVHData`` assigns a 9-dim rotmat
  into a 3-dim euler slot (``bvh_writer.py:50-52``), which cannot run —
  this implements the evident intent.
"""

from __future__ import annotations

import argparse
import csv
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.motion.rotation import (aa2rotmat, euler_from_rotmat,
                                            get_closest_rotmat, rotmat2aa)
from mint_tpu_torch.motion.smpl import (SMPL_JOINT_NAMES, SMPL_PARENTS,
                                        default_rest_joints)
from mint_tpu_torch.utils.device import resolve

_BVH_NAMES = {
    "root": "Hips", "lhip": "LeftHip", "rhip": "RightHip",
    "belly": "Spine", "lknee": "LeftKnee", "rknee": "RightKnee",
    "spine": "Spine1", "lankle": "LeftFoot", "rankle": "RightFoot",
    "chest": "Spine2", "ltoes": "LeftToe", "rtoes": "RightToe",
    "neck": "Neck", "linshoulder": "LeftCollar",
    "rinshoulder": "RightCollar", "head": "Head",
    "lshoulder": "LeftShoulder", "rshoulder": "RightShoulder",
    "lelbow": "LeftElbow", "relbow": "RightElbow",
    "lwrist": "LeftWrist", "rwrist": "RightWrist",
    "lhand": "LeftHand", "rhand": "RightHand",
}


def _children(parents: np.ndarray) -> Dict[int, List[int]]:
    ch: Dict[int, List[int]] = {i: [] for i in range(len(parents))}
    for i in range(1, len(parents)):
        ch[int(parents[i])].append(i)
    return ch


class BVHWriter:
    """BVH writer over the SMPL 24-joint tree (reference BVHWriter API)."""

    def __init__(self, model_name: str = "smpl",
                 skeleton_csv_filename: Optional[str] = None,
                 motion_pkl_filename: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        if model_name != "smpl":
            raise ValueError(f"Model: {model_name} not supported yet.")
        self.device = resolve(device, "BVHWriter")
        self.rest_joints = self._read_skeleton_csv(skeleton_csv_filename)
        self.parents = SMPL_PARENTS
        self.header_content = ""
        self.motion_content = ""
        self.axis_angles: Optional[np.ndarray] = None
        self.trans: Optional[np.ndarray] = None
        if motion_pkl_filename:
            self.load_motion_pkl(motion_pkl_filename)

    # -- inputs ----------------------------------------------------------

    def _read_skeleton_csv(self, path: Optional[str]) -> np.ndarray:
        """CSV rows: name, index, parent_index, x, y, z (reference
        bvh_writer.py:113-133); falls back to the default rest pose."""
        if path is None:
            return default_rest_joints()
        joints = np.zeros((24, 3))
        with open(path, "rt") as f:
            for row in csv.reader(f, skipinitialspace=True, delimiter=","):
                if len(row) == 6:
                    joints[int(row[1])] = [float(row[3]), float(row[4]),
                                           float(row[5])]
        return joints

    def load_motion_pkl(self, path: str) -> None:
        """pkl with smpl_poses/smpl_trans or pred_motion/pred_trans
        (reference bvh_writer.py:144-169)."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.set_motion_from_dict(data)

    def set_motion_from_dict(self, data: Dict) -> None:
        if "smpl_poses" in data:
            self.axis_angles = np.reshape(data["smpl_poses"], (-1, 24, 3))
            trans = data.get("smpl_trans")
            self.trans = (np.zeros((len(self.axis_angles), 3), np.float32)
                          if trans is None else np.reshape(trans, (-1, 3)))
        else:
            rotmats = self._tensor(np.reshape(data["pred_motion"],
                                              (-1, 24, 3, 3)))
            self.axis_angles = rotmat2aa(get_closest_rotmat(rotmats)
                                         ).cpu().numpy()
            self.trans = np.reshape(data["pred_trans"], (-1, 3))

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # -- header ----------------------------------------------------------

    def fill_header(self, frame_rate: float = 60.0) -> None:
        offsets = self.rest_joints.copy()
        offsets[1:] -= self.rest_joints[np.maximum(self.parents[1:], 0)]
        children = _children(self.parents)
        lines = ["HIERARCHY"]

        def emit(joint: int, depth: int) -> None:
            pad = "  " * depth
            name = _BVH_NAMES[SMPL_JOINT_NAMES[joint]]
            if joint == 0:
                lines.append(f"ROOT {name}")
                channels = ("CHANNELS 6 Xposition Yposition Zposition "
                            "Zrotation Yrotation Xrotation")
            else:
                lines.append(f"{pad}JOINT {name}")
                channels = "CHANNELS 3 Zrotation Yrotation Xrotation"
            lines.append(pad + "{")
            o = offsets[joint]
            lines.append(f"{pad}  OFFSET {o[0]:.5f} {o[1]:.5f} {o[2]:.5f}")
            lines.append(f"{pad}  {channels}")
            kids = children[joint]
            if kids:
                for k in kids:
                    emit(k, depth + 1)
            else:
                lines.append(f"{pad}  End Site")
                lines.append(pad + "  {")
                lines.append(f"{pad}    OFFSET 0.00000 0.00000 0.00000")
                lines.append(pad + "  }")
            lines.append(pad + "}")

        emit(0, 0)
        n = 0 if self.axis_angles is None else len(self.axis_angles)
        lines += ["MOTION", f"Frames: {n}",
                  f"Frame Time: {1.0 / frame_rate:.8f}", ""]
        self.header_content = "\n".join(lines)

    # -- motion ----------------------------------------------------------

    def fill_motion(self, order: str = "zyx") -> None:
        assert self.axis_angles is not None, "load motion first"
        t = len(self.axis_angles)
        rotmats = aa2rotmat(self._tensor(self.axis_angles)).reshape(
            t, 24, 3, 3)
        euler = euler_from_rotmat(rotmats).cpu().numpy()  # (x, y, z) rad
        euler = np.rad2deg(euler)
        if order == "zyx":
            euler = euler[..., ::-1]
        rows = []
        for i in range(t):
            vals = np.concatenate([self.trans[i], euler[i].ravel()])
            rows.append(" ".join("%.5f" % v for v in vals))
        self.motion_content = "\n".join(rows)

    def write_to_bvh(self, path: str) -> None:
        if not (self.header_content and self.motion_content):
            raise ValueError(
                "Need to fill both the header and the motion content "
                "before write to the bvh file.")
        with open(path, "w") as f:
            f.write(self.header_content)
            f.write(self.motion_content)
            f.write("\n")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--motion_pkl", required=True, help="Input motion pkl.")
    p.add_argument("--output", required=True, help="Output .bvh path.")
    p.add_argument("--skeleton_csv", default=None,
                   help="Optional skeleton rest-pose csv.")
    p.add_argument("--frame_rate", type=float, default=60.0,
                   help="Frames per second.")
    p.add_argument("--device", default="cuda",
                   help="Device of the rotation conversions: 'cuda' (the "
                        "default) or 'cpu'.")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    writer = BVHWriter("smpl", args.skeleton_csv, args.motion_pkl,
                       device=args.device)
    writer.fill_header(args.frame_rate)
    writer.fill_motion()
    writer.write_to_bvh(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
