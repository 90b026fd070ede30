"""Profiling and step timing (counterpart of
``mint_tpu/utils/profiling.py``, whose module imports JAX).

- :class:`StepTimer`: wall-clock step rate with warmup skip, for steps/sec
  and examples/sec reporting in the controller (the port's copy).
- :func:`trace`: context manager around ``torch.profiler``'s trace
  capture; view with TensorBoard's profiler plugin or Perfetto.
- :func:`annotate`: the port's one span: a named range on the host
  timeline of a running ``torch.profiler`` (its trace is the sink, on the
  device trace's clock); with no profiler running, one shared null
  context, so a span costs one check.  The port's spans are
  ``mint.train.step`` (``Trainer.train_step``), ``mint.train.sample``
  (``DeviceDataset.sample``) and ``mint.decode.step`` (each step of the
  AR decode's loop).
- :func:`stamp`: a phase mark on the card, captured into a CUDA graph
  with the work around it: a one-thread kernel, a kernel a phase
  (``mint_trace::stamp_kernel<i>``, ``PHASES[i]``), that writes the
  device's ``%globaltimer`` (ns) into ``slots[i]``.  A trace tells the
  phases of a replayed graph apart by the stamps' names and times, and
  the slots give the last run's phases with no profiler
  (``Trainer.phase_ms``).  The kernel's source is ``csrc/trace.cu``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence

import torch

from mint_tpu_torch.ops import _build

#: The phases a stamp marks, by slot (the kernel's template argument):
#: the training step's body stamps them in this order, ``exchange`` only
#: over a mesh.
PHASES = ("begin", "forward", "backward", "exchange", "update")

_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


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
    """A named range on the host timeline of a running profiler's trace
    (``torch.profiler.record_function``); with none running, a shared
    null context that enters nothing."""
    if not _profiling():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def stamp(slots: torch.Tensor, phase: str) -> None:
    """Launch phase `phase`'s stamp on the current stream: the device's
    clock (ns) into ``slots[PHASES.index(phase)]`` once the work queued
    before it has run.  `slots` is an int64 tensor of ``len(PHASES)`` on
    the card; on the CPU nothing is stamped."""
    if slots.device.type != "cuda":
        return
    err = _build.library().mint_trace_stamp(
        slots.data_ptr(), PHASES.index(phase),
        torch._C._cuda_getCurrentRawStream(slots.get_device()))
    if err:
        _build.check(err, f"trace stamp {phase!r} launch")


def phase_ms(times: Sequence[int], exchange: bool
             ) -> Optional[Dict[str, float]]:
    """Each phase's ms from one run's stamps (`times`, ns by
    :data:`PHASES`): from the end of the phase before it, ``exchange``
    only where the run stamps it.  None where ``begin`` was never
    stamped."""
    at = dict(zip(PHASES, times))
    if not at["begin"]:
        return None
    ends = [p for p in PHASES if exchange or p != "exchange"]
    return {b: (at[b] - at[a]) / 1e6 for a, b in zip(ends, ends[1:])}
