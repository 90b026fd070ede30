"""SMPL forward kinematics on torch tensors, joints only (the port's
counterpart of ``mint_tpu/motion/smpl.py``).

The reference scorer (``tools/calculate_scores.py:154-162``) and ground-truth
feature extractor (``tools/extract_aist_features.py:35-53``) call
``smpl.forward(global_orient, body_pose, transl).joints[..., :24, :]``,
whose first 24 joints are the rigidly transformed joints of the kinematic
tree (no pose blend shapes), so scoring needs only:

  J_rest = J_regressor @ (v_template + shapedirs . betas)
  world transforms = chain of [R_i | J_i - J_parent] down the tree
  joints = world translations (+ transl)

The model file is the standard SMPL pickle (SMPL_MALE.pkl); a permissive
unpickler reads its chumpy arrays without chumpy installed.  The rest
joints are computed in f64 on the host and kept in f32; the kinematics run
in f32 on the device the caller names.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from mint_tpu_torch.motion.rotation import aa2rotmat

# SMPL 24-joint topology: parents[i] is the parent of joint i (root = -1).
SMPL_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
                         12, 13, 14, 16, 17, 18, 19, 20, 21], np.int32)

SMPL_JOINT_NAMES = [
    "root", "lhip", "rhip", "belly", "lknee", "rknee", "spine",
    "lankle", "rankle", "chest", "ltoes", "rtoes", "neck",
    "linshoulder", "rinshoulder", "head", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "lhand", "rhand",
]


class SMPLModel(NamedTuple):
    """Rest-pose data needed for joint FK."""

    j_rest: np.ndarray        # [24, 3] rest joints (betas applied)
    parents: np.ndarray       # [24]


class _ChumpyStub:
    """Stand-in for chumpy arrays inside SMPL pickles."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _ChumpyStub


def _to_array(x) -> Optional[np.ndarray]:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "r"):
        return np.asarray(x.r)
    if isinstance(x, _ChumpyStub):
        for key in ("x", "a", "_data"):
            v = x.__dict__.get(key)
            if v is not None:
                return _to_array(v)
        return None
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    try:
        return np.asarray(x)
    except Exception:
        return None


def load_smpl(path: str, betas: Optional[np.ndarray] = None) -> SMPLModel:
    """Load an SMPL .pkl and precompute rest joints for the given betas."""
    with open(path, "rb") as f:
        data = _PermissiveUnpickler(f, encoding="latin1").load()
    v_template = _to_array(data["v_template"]).astype(np.float64)
    j_regressor = _to_array(data["J_regressor"]).astype(np.float64)
    parents = SMPL_PARENTS
    if "kintree_table" in data:
        kt = _to_array(data["kintree_table"])
        if kt is not None and kt.shape[0] == 2:
            parents = kt[0].astype(np.int64)
            parents[0] = -1
            parents = parents.astype(np.int32)
    v_shaped = v_template
    if betas is not None:
        shapedirs = _to_array(data["shapedirs"]).astype(np.float64)
        n = min(len(betas), shapedirs.shape[-1])
        v_shaped = v_template + shapedirs[..., :n] @ np.asarray(
            betas[:n], np.float64)
    j_rest = (j_regressor @ v_shaped).astype(np.float32)
    return SMPLModel(j_rest=j_rest, parents=np.asarray(parents, np.int32))


def default_rest_joints() -> np.ndarray:
    """Approximate SMPL male rest joints [24, 3] for tests / when no model
    file is available (meters, y-up, zero betas; hand-tuned to typical SMPL
    proportions)."""
    j = np.array([
        [0.0, 0.0, 0.0],        # root (pelvis)
        [0.07, -0.09, 0.0],     # lhip
        [-0.07, -0.09, 0.0],    # rhip
        [0.0, 0.11, -0.01],     # belly
        [0.10, -0.47, 0.0],     # lknee
        [-0.10, -0.47, 0.0],    # rknee
        [0.0, 0.25, 0.0],       # spine
        [0.09, -0.86, -0.03],   # lankle
        [-0.09, -0.86, -0.03],  # rankle
        [0.0, 0.31, 0.01],      # chest
        [0.11, -0.93, 0.09],    # ltoes
        [-0.11, -0.93, 0.09],   # rtoes
        [0.0, 0.46, -0.02],     # neck
        [0.08, 0.41, -0.01],    # linshoulder
        [-0.08, 0.41, -0.01],   # rinshoulder
        [0.0, 0.55, 0.03],      # head
        [0.17, 0.44, -0.02],    # lshoulder
        [-0.17, 0.44, -0.02],   # rshoulder
        [0.43, 0.42, -0.03],    # lelbow
        [-0.43, 0.42, -0.03],   # relbow
        [0.68, 0.43, -0.03],    # lwrist
        [-0.68, 0.43, -0.03],   # rwrist
        [0.76, 0.42, -0.03],    # lhand
        [-0.76, 0.42, -0.03],   # rhand
    ], np.float32)
    return j


def _fk(rotmats: torch.Tensor, j_rest: torch.Tensor, parents: np.ndarray,
        transl: torch.Tensor) -> torch.Tensor:
    """rotmats [..., 24, 3, 3], transl [..., 3] -> joints [..., 24, 3],
    in the inputs' dtype on their device."""
    batch = rotmats.shape[:-3]
    parents = np.asarray(parents)
    # Offsets from the parent; the root's is its own position.
    rel = j_rest - j_rest[torch.as_tensor(np.maximum(parents, 0),
                                          dtype=torch.long,
                                          device=j_rest.device)]
    rel[0] = j_rest[0]

    # Unrolled chain over 24 joints: world_R[i] = world_R[p] @ R[i],
    # world_t[i] = world_t[p] + world_R[p] @ rel[i].
    world_R = [rotmats[..., 0, :, :]]
    world_t = [rel[0].expand(batch + (3,))]
    for i in range(1, len(parents)):
        p = int(parents[i])
        world_R.append(world_R[p] @ rotmats[..., i, :, :])
        world_t.append(world_t[p] + world_R[p] @ rel[i])
    return torch.stack(world_t, dim=-2) + transl[..., None, :]


def smpl_joints(poses, transl, model: Optional[SMPLModel] = None,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Axis-angle poses [..., 24, 3] + translation [..., 3] -> joints
    [..., 24, 3], an f32 tensor on `device`; the reference's
    ``smpl.forward(...).joints[..., :24, :]``.

    Arrays or tensors of any float dtype are taken to f32 on `device`
    (the card unless the caller asks for the CPU)."""
    if model is None:
        model = SMPLModel(j_rest=default_rest_joints(), parents=SMPL_PARENTS)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    transl = torch.as_tensor(transl, dtype=torch.float32, device=device)
    rotmats = aa2rotmat(poses).reshape(poses.shape[:-1] + (3, 3))
    j_rest = torch.as_tensor(model.j_rest, dtype=torch.float32,
                             device=device)
    return _fk(rotmats, j_rest, model.parents, transl)
