"""What the program's own tracing leaves in a traced window, for the
readers of the training step's phases and of the host's time a step.

- Phase stamps: one-thread kernels that the training step's body
  launches inside its CUDA graph (``mint_trace::stamp_kernel<i>``, phase
  ``PHASES[i]``; the program's ``utils/profiling.py``).  A step runs from
  one ``begin`` stamp to the next; its phases run from each stamp to the
  next, and ``between`` from ``update`` to the next ``begin`` (the batch
  draw, its copy, the step's scalars, the loss's copy, idle).  Only steps
  whose stamps, the next ``begin`` included, all lie in the window count,
  and a phase's reading is its mean over them.  A stamp's time is its
  kernel's start in the trace, on the clock of every other event.
- Host spans: the program's ``mint.*`` ranges on the host's timeline.  A
  span's own time is its length less the CUDA calls under it (``cuda*``
  and ``cu*``, and the waits CUDA and the profiler record there: a full
  command buffer, an activity buffer request), so it reads the host's own
  work and not the time it was blocked in CUDA.

A trace of a program that leaves neither gives None.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: The program's phases, by stamp kernel (``utils/profiling.PHASES``).
PHASES = ("begin", "forward", "backward", "exchange", "update")
STAMP = re.compile(r"mint_trace::stamp_kernel<(\d+)>")
#: Host events that are CUDA's time, not the host's own work.
IN_CUDA = re.compile(r"cu(da)?[A-Z]|Command.Buffer.Full|"
                     r"Activity.Buffer.Request")


def stamps(trace) -> List[Tuple[str, int]]:
    """(phase, start ns) of every stamp kernel wholly in the window, in
    order of time."""
    lo, hi = trace.window
    out = []
    for name, s, e in trace.device:
        m = STAMP.search(name)
        if m and lo <= s and e <= hi and int(m.group(1)) < len(PHASES):
            out.append((PHASES[int(m.group(1))], s))
    return sorted(out, key=lambda x: x[1])


def steps(trace) -> List[Dict[str, float]]:
    """Each whole step's phases in ms: ``forward``, ``backward``,
    ``exchange`` (where stamped), ``update`` and ``between``; they sum to
    the step's time from its ``begin`` to the next."""
    marks = stamps(trace)
    begins = [i for i, (phase, _) in enumerate(marks) if phase == "begin"]
    out = []
    for a, b in zip(begins, begins[1:]):
        order = [phase for phase, _ in marks[a:b]]
        if order not in (list(PHASES), [p for p in PHASES
                                         if p != "exchange"]):
            continue  # a step stamped otherwise is no step of the body
        at = dict(marks[a:b])
        ms = {q: (at[q] - at[p]) / 1e6 for p, q in zip(order, order[1:])}
        ms["between"] = (marks[b][1] - at["update"]) / 1e6
        out.append(ms)
    return out


def phase_ms(trace, phase: str) -> Optional[float]:
    """`phase`'s mean ms over the window's whole steps; None where no
    step stamps it."""
    got = [s[phase] for s in steps(trace) if phase in s]
    return sum(got) / len(got) if got else None


def _union(intervals: Sequence[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def host_ms(trace, names: Sequence[str]) -> Optional[float]:
    """The host's own ms a step: for each span name, the mean own time of
    its spans wholly in the window, summed over `names`; None where a
    name has no such span."""
    lo, hi = trace.window
    cuda = _union([(s, e) for n, s, e in trace.host if IN_CUDA.match(n)])
    starts = [s for s, _ in cuda]
    total = 0.0
    for name in names:
        spans = [(s, e) for n, s, e in trace.host
                 if n == name and lo <= s and e <= hi]
        if not spans:
            return None
        own = 0
        for s, e in spans:
            own += e - s
            i = max(bisect.bisect_right(starts, s) - 1, 0)
            while i < len(cuda) and cuda[i][0] < e:
                own -= max(0, min(e, cuda[i][1]) - max(s, cuda[i][0]))
                i += 1
        total += own / len(spans) / 1e6
    return total
