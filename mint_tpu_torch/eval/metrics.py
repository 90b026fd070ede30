"""Online evaluation metrics (the port's counterpart of
``mint_tpu/eval/metrics.py``).

EulerAnglesError mirrors the reference metric (``mint/core/metrics.py:
20-63``): rotation-matrix channels -> Euler angles (R = Rz Ry Rx
convention, NaNs zeroed), accumulated mean L2 norm of the per-frame angle
difference.  The reference FACT path returns no online metrics
(``fact_model.py:138-141``); this is provided for parity of capability.
The angles are computed in f32 on the host, as the JAX metric computes
them in f32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mint_tpu_torch.motion.rotation import euler_from_rotmat


def _euler(rotmats: np.ndarray) -> np.ndarray:
    m = torch.from_numpy(np.ascontiguousarray(rotmats, np.float32))
    return euler_from_rotmat(m.reshape(-1, 3, 3)).numpy()


class EulerAnglesError:
    """Accumulating Euler-angle error over eval batches."""

    name = "EulerAnglesError"

    def __init__(self, num_joints: int):
        self.num_joints = num_joints
        self.reset_states()

    def reset_states(self) -> None:
        self._total = 0.0

    def update_state(self, inputs: Dict, pred) -> None:
        target = np.asarray(inputs["target"])
        pred = np.asarray(pred)
        t = target.shape[1]
        # Skip the leading 9 translation dims (reference metrics.py:45-48).
        ep = np.nan_to_num(_euler(pred[:, :t, 9:]))
        et = np.nan_to_num(_euler(target[:, :, 9:]))
        ep = ep.reshape(-1, self.num_joints * 3)
        et = et.reshape(-1, self.num_joints * 3)
        diff = np.linalg.norm(et - ep, axis=-1)
        self._total += float(diff.mean())

    def result(self) -> float:
        return self._total
