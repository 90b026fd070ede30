"""Background prefetch of training batches onto the device (counterpart of
``mint_tpu/data/prefetch.py``).

:class:`DevicePrefetcher` runs the loader and `place` in a daemon thread,
`depth` batches ahead, so the train loop never waits on the host's
decoding or the copy.  :func:`to_device` is the `place` for the card: it
copies each batch's numeric features through pinned memory with
``non_blocking``, so the copy overlaps the running train step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch


def to_device(batch: Mapping[str, Any], device: torch.device | str
              ) -> Dict[str, torch.Tensor]:
    """The numeric features of a batch (numpy arrays or tensors) as
    tensors on `device`; strings, such as clip names, are dropped.  A
    numpy array goes to a card from pinned memory without blocking the
    caller."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if not isinstance(value, torch.Tensor):
            arr = np.asarray(value)
            if arr.dtype.kind not in "fiub":
                continue
            value = torch.from_numpy(np.ascontiguousarray(arr))
            if device.type == "cuda":
                value = value.pin_memory()
        out[key] = value.to(device, non_blocking=True)
    return out


class DevicePrefetcher:
    """Iterator wrapper: applies `place` (e.g. :func:`to_device`) to
    upstream items in a background thread, `depth` items ahead."""

    _DONE = object()

    def __init__(self, upstream: Iterator, place: Callable, depth: int = 2):
        self._upstream = upstream
        self._place = place
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            upstream = iter(self._upstream)
            while not self._stop.is_set():
                # Check stop BEFORE advancing the upstream: a slow read
                # after close() would push close()'s join into its leak
                # path.
                try:
                    item = next(upstream)
                except StopIteration:
                    break
                placed = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate into the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._DONE, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            # Exhaustion or an error repeats on every later next(): the
            # producer queues _DONE once.
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # A straggling consumer sees StopIteration, not a wait on a queue
        # the stopped producer will never feed.
        self._done = True
        try:  # drain so the producer unblocks, then join
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:  # wake a consumer already parked in q.get()
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # The producer is still inside next(upstream): closing the
            # upstream under it would fail; the daemon thread dies with
            # the process.
            return
        close = getattr(self._upstream, "close", None)
        if close is not None:
            close()
