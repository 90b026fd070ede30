"""The DDIM step's phases in a traced window, from the program's phase
stamps in the step's CUDA graph (``infer/diffusion.py``): ``begin`` at
the step's first launch, ``forward`` after the guided denoiser, ``update``
after the DDIM update and the stitch.  A step's ``denoise`` runs from its
``begin`` to its ``forward``, its ``update`` from ``forward`` to
``update``; only steps stamped in that order, wholly in the window,
count, and a phase's reading is its mean over them.  A trace of a program
that stamps none gives None."""

from __future__ import annotations

from typing import Dict, List, Optional

from lib import phases

ORDER = ("begin", "forward", "update")


def steps(trace) -> List[Dict[str, float]]:
    marks = phases.stamps(trace)
    out = []
    for i in range(len(marks) - 2):
        run = marks[i:i + 3]
        if tuple(p for p, _ in run) == ORDER:
            out.append({"denoise": (run[1][1] - run[0][1]) / 1e6,
                        "update": (run[2][1] - run[1][1]) / 1e6})
    return out


def phase_ms(trace, phase: str) -> Optional[float]:
    got = [s[phase] for s in steps(trace)]
    return sum(got) / len(got) if got else None
