"""Motion visualization of the port (counterpart of
``mint_tpu/tools/visualize.py``; reference
``tools/calculate_scores.py:54-79``).

    python -m mint_tpu_torch.tools.visualize --motion_npy=clip.npy \\
        --output=clip.gif [--smpl_model_path=SMPL_MALE.pkl] [--stride=10]

The reference renders generated motion with vedo (interactive 3-D); here
the SMPL joint skeleton is rendered with matplotlib into PNG frames or an
animated GIF — headless-friendly, same recover->FK path as scoring.  The
recovery and the kinematics run in f32 on ``device`` (``--device``: the
card by default, ``cpu`` when asked; without a card the default raises);
the drawing is matplotlib on the host, imported only when a render is
asked for.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.motion.rotation import recover_to_axis_angles
from mint_tpu_torch.motion.smpl import (SMPL_PARENTS, SMPLModel,
                                        default_rest_joints, load_smpl,
                                        smpl_joints)
from mint_tpu_torch.utils.device import resolve


def motion_joints(motion: np.ndarray, smpl_model_path: str = "",
                  device: torch.device | str = "cuda") -> np.ndarray:
    """[T, 225] (or [1, T, 225]) FACT motion -> joints [T, 24, 3]: the
    scorer's recovery and SMPL kinematics on `device`."""
    device = resolve(device, "visualize")
    if motion.ndim == 2:
        motion = motion[None]
    model = (load_smpl(smpl_model_path) if smpl_model_path
             else SMPLModel(j_rest=default_rest_joints(),
                            parents=SMPL_PARENTS))
    aa, transl = recover_to_axis_angles(
        torch.as_tensor(motion, dtype=torch.float32, device=device))
    return smpl_joints(aa[0], transl[0], model, device=device).cpu().numpy()


def render_motion(motion: np.ndarray, out_path: str,
                  smpl_model_path: str = "", fps: int = 60,
                  stride: int = 10, elev: float = 15.0,
                  azim: float = -60.0,
                  device: torch.device | str = "cuda") -> str:
    """[T, 225] (or [1, T, 225]) FACT motion -> skeleton animation.

    Writes a GIF if `out_path` ends in .gif, else a directory of PNGs.
    `stride` subsamples frames (every stride-th frame is drawn).
    """
    joints = motion_joints(motion, smpl_model_path, device)[::stride]
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bones = [(i, int(SMPL_PARENTS[i])) for i in range(1, 24)]
    lo = joints.reshape(-1, 3).min(axis=0)
    hi = joints.reshape(-1, 3).max(axis=0)
    center, radius = (lo + hi) / 2, max((hi - lo).max() / 2, 1e-3)

    def draw(ax, frame):
        ax.clear()
        ax.view_init(elev=elev, azim=azim)
        for a, b in bones:
            ax.plot([frame[a, 0], frame[b, 0]],
                    [frame[a, 2], frame[b, 2]],
                    [frame[a, 1], frame[b, 1]], "o-", color="#1f77b4",
                    markersize=2, linewidth=1.5)
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[2] - radius, center[2] + radius)
        ax.set_zlim(center[1] - radius, center[1] + radius)
        ax.set_axis_off()

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")

    if out_path.endswith(".gif"):
        from matplotlib.animation import FuncAnimation, PillowWriter
        anim = FuncAnimation(fig, lambda i: draw(ax, joints[i]),
                             frames=len(joints))
        anim.save(out_path, writer=PillowWriter(fps=max(1, fps // stride)))
    else:
        os.makedirs(out_path, exist_ok=True)
        for i, frame in enumerate(joints):
            draw(ax, frame)
            fig.savefig(os.path.join(out_path, f"frame_{i:05d}.png"),
                        dpi=80)
    plt.close(fig)
    return out_path


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--motion_npy", required=True,
                   help="Generated clip ([T, 225] or [1, T, 225] .npy).")
    p.add_argument("--output", required=True,
                   help="Output .gif path or PNG dir.")
    p.add_argument("--smpl_model_path", default="",
                   help="SMPL .pkl (optional).")
    p.add_argument("--stride", type=int, default=10,
                   help="Render every Nth frame.")
    p.add_argument("--device", default="cuda",
                   help="Device of the recovery and the kinematics: 'cuda' "
                        "(the default) or 'cpu'.")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    path = render_motion(np.load(args.motion_npy), args.output,
                         smpl_model_path=args.smpl_model_path,
                         stride=args.stride, device=args.device)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
