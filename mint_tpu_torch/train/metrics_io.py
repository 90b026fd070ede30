"""Training metrics writer (counterpart of ``mint_tpu/train/metrics_io.py``).

Metrics go to ``<summary_dir>/metrics.jsonl``, one JSON object per
summary: ``{"step", "time", <metric>: float, ...}``.  The JAX package also
writes TensorBoard events when TensorFlow is importable; the port does not
(the card's machine has no TensorFlow).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, summary_dir: Optional[str]):
        self.summary_dir = summary_dir
        self._jsonl = None
        if summary_dir:
            os.makedirs(summary_dir, exist_ok=True)
            self._jsonl = open(os.path.join(summary_dir, "metrics.jsonl"),
                               "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if self._jsonl is not None:
            rec = {"step": int(step), "time": time.time()}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._jsonl.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
