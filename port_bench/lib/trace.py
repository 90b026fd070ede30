"""The traced window, from ``torch.profiler``: device operations on the
timeline, the host's operations beside them, and the reductions the
per-layer metrics read (busy time as the union of device intervals,
device time and launches by kernel family, idle gaps by host activity).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from lib import registry

WINDOW = "port_bench.window"
LABELLED_GAPS = 200  # idle gaps labelled by host activity, longest first

Event = Tuple[str, int, int]  # (name, start ns, end ns)


def _ns(evt, what: str) -> int:
    fn = getattr(evt, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, f"{what}_us")() * 1000)


def _events(prof):
    """(device events, host events) of a finished profile.  A span the
    host marks (``record_function``) is also drawn on the device's
    timeline under the same name; it is no device operation and is left
    out of the device's events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for evt in prof.profiler.kineto_results.events():
        start = _ns(evt, "start")
        end = start + _ns(evt, "duration")
        row = (evt.name(), start, end)
        (device if evt.device_type() == DeviceType.CUDA else host).append(row)
    marked = {name for name, _, _ in host}
    return [e for e in device if e[0] not in marked], host


@contextlib.contextmanager
def profiled():
    """Profile the block: host and device activity.  Yields a list that
    holds, once the block has ended, the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
    out.append(prof)


@dataclass
class Trace:
    """A traced window and what the benchmark knows of its work.

    `units` is the count of the cell's unit (decode steps, train steps)
    in the window; `bounds` each op's least time a unit (seconds, from
    ``work.py``); `flops` the model FLOPs of a unit; `peak` the chip's
    FLOP/s in the configuration's precision."""
    device: List[Event]
    host: List[Event]
    window: Tuple[int, int]
    units: int
    bounds: Dict[str, float]
    flops: float
    peak: float
    families: List[dict]
    _family: Dict[str, Optional[dict]] = field(default_factory=dict)

    @classmethod
    def from_profile(cls, prof, **kw) -> "Trace":
        device, host = _events(prof)
        marks = [e for e in host if e[0] == WINDOW]
        if not marks:
            raise RuntimeError("the profile holds no window mark")
        window = (marks[0][1], marks[0][2])
        host = [e for e in host if e[0] != WINDOW]
        device = [e for e in device if e[2] > window[0] and
                  e[1] < window[1]]
        return cls(device=device, host=host, window=window, **kw)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> List[Event]:
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of every device operation's interval in the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged if e > s]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def family(self, name: str) -> Optional[dict]:
        if name not in self._family:
            self._family[name] = registry.family_of(name, self.families)
        return self._family[name]

    def of_op(self, op: str, pass_: Optional[str] = None) -> List[Event]:
        """The kernels that the families assign to `op` (and `pass_`)."""
        out = []
        for e in self.kernels():
            fam = self.family(e[0])
            if fam and fam["op"] == op and (pass_ is None
                                            or fam["pass"] == pass_):
                out.append(e)
        return out

    def op_seconds(self, op: str, pass_: Optional[str] = None) -> float:
        return sum(e - s for _, s, e in self.of_op(op, pass_)) / 1e9

    def exposed_seconds(self, op: str) -> float:
        """Device time of `op`'s kernels that no other kernel overlaps."""
        others = sorted((s, e) for name, s, e in self.kernels()
                        if (self.family(name) or {}).get("op") != op)
        total = 0
        for _, s, e in self.of_op(op):
            covered, at = 0, s
            for os_, oe in others:
                if oe <= at:
                    continue
                if os_ >= e:
                    break
                lo, hi = max(os_, at), min(oe, e)
                if hi > lo:
                    covered += hi - lo
                    at = hi
            total += (e - s) - covered
        return total / 1e9

    def roofline(self, op: str, pass_: Optional[str] = None
                 ) -> Optional[float]:
        """The op's share of its roofline in %: its calls' least time over
        its kernels' device time; None where the window holds neither."""
        seconds = self.op_seconds(op, pass_)
        least = self.bounds.get(op, 0.0) * self.units
        if seconds <= 0 or least <= 0:
            return None
        return 100.0 * least / seconds

    def mfu(self) -> Optional[float]:
        if self.units <= 0 or self.window_s <= 0:
            return None
        return 100.0 * self.flops * self.units / self.window_s / self.peak

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing in each (the innermost host
        operation under the gap's middle)."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = ([self.window[0]] + [x for iv in busy for x in iv]
                 + [self.window[1]])
        spans = sorted(((e - s, s, e) for s, e in zip(edges[0::2],
                                                       edges[1::2])
                        if e > s), reverse=True)
        starts = np.array([h[1] for h in self.host], dtype=np.int64)
        ends = np.array([h[2] for h in self.host], dtype=np.int64)
        gaps: Dict[str, float] = {}
        for length, s, e in spans[:LABELLED_GAPS]:
            mid = (s + e) // 2
            under = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = ("no host operation" if len(under) == 0 else
                     self.host[under[np.argmin(ends[under]
                                               - starts[under])]][0])
            gaps[label] = gaps.get(label, 0.0) + length / 1e9
        rest = sum(x[0] for x in spans[LABELLED_GAPS:]) / 1e9
        if rest:
            gaps[f"gaps past the {LABELLED_GAPS} longest"] = rest
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[n[:160], v] for n, v in idle]}
