"""Step timing (the port's copy of ``StepTimer`` from
``mint_tpu/utils/profiling.py``, whose module imports JAX)."""

from __future__ import annotations

import time
from typing import Dict, Optional


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
