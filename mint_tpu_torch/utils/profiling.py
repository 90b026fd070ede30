"""Profiling and step timing (counterpart of
``mint_tpu/utils/profiling.py``, whose module imports JAX).

- :class:`StepTimer`: wall-clock step rate with warmup skip, for steps/sec
  and examples/sec reporting in the controller (the port's copy).
- :func:`trace`: context manager around ``torch.profiler``'s trace
  capture; view with TensorBoard's profiler plugin or Perfetto.
- :func:`annotate`: a named range for host-side phases in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class StepTimer:
    """Tracks steps/sec over the run, skipping warmup steps."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._timed_steps = 0
        self._elapsed = 0.0
        self._last: Optional[float] = None

    def step(self) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._count > self.warmup_steps and self._last is not None:
            self._elapsed += now - self._last
            self._timed_steps += 1
        self._last = now

    def steps_per_sec(self) -> float:
        if not self._timed_steps or self._elapsed <= 0:
            return 0.0
        return self._timed_steps / self._elapsed

    def metrics(self, batch_size: Optional[int] = None
                ) -> Dict[str, float]:
        out = {"steps_per_sec": self.steps_per_sec()}
        if batch_size:
            out["examples_per_sec"] = out["steps_per_sec"] * batch_size
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body: the CPU, and CUDA where a card is present.  On
    exit writes a TensorBoard-readable trace (``*.pt.trace.json``) under
    `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named range that shows up on the host timeline of a trace."""
    return torch.profiler.record_function(name)
