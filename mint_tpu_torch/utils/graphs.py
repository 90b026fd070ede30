"""CUDA graphs: the port's counterpart of the JAX package's compiled loops.

The JAX package compiles each hot loop into one XLA program: the AR
decode's ``lax.scan`` (``_decode_scan``, ``mint_tpu/infer/decoder.py``)
and the trainer's ``steps_per_loop`` window (``Trainer.train_steps``,
``mint_tpu/train/trainer.py``).  On the card the counterpart is a CUDA
graph of one step, captured once and then replayed with no Python between
the kernels' launches.  :class:`Step` runs a step function over static
tensors (tensors at fixed addresses, which the caller refills between
steps):

- its first call runs the function eagerly on a side stream: a real step,
  which also warms up what a capture must not do first (the kernels'
  build, the matmul library's workspace for the stream, the autograd
  engine's threads);
- its second call captures the function into a graph on that stream and
  replays it; every later call replays it.  A capture or a replay that
  fails raises: nothing falls back to eager steps.

A step whose body runs NCCL collectives (the trainer over a mesh of
ranks) captures in thread-local mode, so that a thread outside the port,
ProcessGroupNCCL's watchdog polling its collectives' events, cannot make
the capture fail; the port's own threads still hold
:data:`capture_lock`.  NCCL's communicators are set up by the eager
first step, before any capture.  NCCL keeps resources alive for every
graph that captured its collectives and, when its communicators are
destroyed, waits for those graphs to go: :func:`release_collectives`
destroys them first (``parallel.mesh.leave`` calls it).

All the graphs of one model draw on one memory pool (:class:`Graphs`,
``torch.cuda.graph_pool_handle``).  They replay one at a time on one
stream, so a capture may reuse what an earlier capture freed.

Launch counts: the kernels' wrappers count their launches in Python
(``ops.*.launches``), and a replay runs no Python.  A capture records what
its wrappers counted, takes it back (a capture launches nothing), and
every replay adds it again, so the counts stay the kernels' launches.

Threads: a capture runs in CUDA's global capture mode, in which another
thread's synchronising CUDA call (a blocking copy, a device or pinned
allocation) is an error.  The port's other threads that call CUDA (the
checkpoint save's fetch, the prefetcher's copies) hold
:data:`capture_lock` around those calls, as a capture does.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Callable, Hashable

import torch

from mint_tpu_torch.ops import attention, layer_norm, mlp

log = logging.getLogger(__name__)

_cuda = torch.cuda  # what this module calls of CUDA (the CPU tests fake it)

#: Held by a capture, and by every other thread of the port around its
#: CUDA calls.
capture_lock = threading.RLock()
_count_lock = threading.Lock()

#: Each kernel's launch count: its wrapper's module and the attribute.
_COUNTERS = {"attention": (attention, "launches"),
             "fused_mlp": (mlp, "launches"),
             "layer_norm": (layer_norm, "launches"),
             "layer_norm_affine_free": (layer_norm, "affine_free_launches")}

#: Captured steps whose graphs hold collectives (thread-local captures).
_with_collectives: "weakref.WeakSet[Step]" = weakref.WeakSet()


def enabled(device: torch.device | str) -> bool:
    """Whether loops on `device` run as graphs: on a CUDA card, always."""
    return torch.device(device).type == "cuda"


def _launches() -> dict:
    return {name: getattr(op, attr) for name, (op, attr) in _COUNTERS.items()}


def _set_launches(name: str, n: int) -> None:
    op, attr = _COUNTERS[name]
    setattr(op, attr, n)


class Graphs:
    """The graphs of one model: their memory pool, the steps cached by key
    (the decoder's), and what the captures took."""

    def __init__(self):
        self.pool = None  # torch.cuda.graph_pool_handle(), at first capture
        self.steps: dict = {}
        self.bound: tuple = ()  # addresses the cached steps read
        self.captures = 0
        self.seconds = 0.0
        self._live = weakref.WeakSet()  # captured steps not yet dropped

    @property
    def bytes(self) -> int:
        """Device memory the live graphs' captures added to the pool."""
        return sum(step.bytes for step in self._live)

    def summary(self) -> str:
        return (f"{self.captures} graph(s) captured in {self.seconds:.3f} s, "
                f"{len(self._live)} live holding {self.bytes} bytes of pool")


def of(model) -> Graphs:
    """`model`'s :class:`Graphs`, made at first use."""
    graphs = getattr(model, "_graphs", None)
    if graphs is None:
        graphs = Graphs()
        model._graphs = graphs
    return graphs


class Step:
    """``fn`` (no arguments; it reads and writes static tensors and returns
    its outputs) as a graphed step on `device`: eager at the first call,
    captured at the second, replayed from then on.  Returns ``fn``'s
    outputs; after a capture those are static tensors that the next call
    overwrites, so a caller that keeps one clones it.  `thread_local`
    captures in CUDA's thread-local mode (a body with NCCL collectives)."""

    def __init__(self, fn: Callable[[], Any], graphs: Graphs, key: Hashable,
                 device: torch.device, thread_local: bool = False):
        self.fn = fn
        self.graphs = graphs
        self.key = key
        self.device = device
        self.thread_local = thread_local
        self.launches: dict = {}  # kernel launches a replay makes
        self.bytes = 0  # device memory its capture added to the pool
        self._stream = None
        self._graph = None
        self._out = None

    @property
    def captured(self) -> bool:
        """Whether the step is captured (every later call replays)."""
        return self._graph is not None

    def release(self) -> None:
        """Destroy the captured graph: the next call captures anew."""
        self._graph = self._out = None
        self.graphs._live.discard(self)

    def __call__(self):
        if self._graph is not None:
            self._graph.replay()
            with _count_lock:  # replicas replay from several threads
                counted = _launches()
                for name, n in self.launches.items():
                    _set_launches(name, counted[name] + n)
            return self._out
        if self._stream is None:
            return self._warm_up()
        self._capture()
        return self()

    def _warm_up(self):
        current = _cuda.current_stream(self.device)
        self._stream = _cuda.Stream(self.device)
        self._stream.wait_stream(current)
        with _cuda.stream(self._stream):
            out = self.fn()
        current.wait_stream(self._stream)
        return out

    def _capture(self) -> None:
        graphs = self.graphs
        if graphs.pool is None:
            graphs.pool = _cuda.graph_pool_handle()
        graph = _cuda.CUDAGraph()
        t0 = time.perf_counter()
        with capture_lock:
            _cuda.synchronize(self.device)
            _cuda.empty_cache()
            reserved = _cuda.memory_reserved(self.device)
            counted = _launches()
            mode = ({"capture_error_mode": "thread_local"}
                    if self.thread_local else {})
            try:
                with _cuda.graph(graph, pool=graphs.pool,
                                 stream=self._stream, **mode):
                    out = self.fn()
            finally:
                captured = {name: n - counted[name]
                            for name, n in _launches().items()}
                for name, n in counted.items():
                    _set_launches(name, n)
            grew = _cuda.memory_reserved(self.device) - reserved
        seconds = time.perf_counter() - t0
        self._graph, self._out, self.launches = graph, out, captured
        self.bytes = grew
        if self.thread_local:
            _with_collectives.add(self)
        graphs.captures += 1
        graphs.seconds += seconds
        graphs._live.add(self)
        log.info("graph %s captured in %.3f s, kernel launches a replay %s;"
                 " pool +%d bytes (%s)", self.key, seconds, captured, grew,
                 graphs.summary())


def release_collectives() -> None:
    """Destroy every captured graph of this process that holds
    collectives, once the card has run them (their steps capture anew if
    called again): NCCL destroys a communicator only after the graphs
    that captured its collectives are gone."""
    steps = list(_with_collectives)
    if steps:
        _cuda.synchronize()
    for step in steps:
        step.release()
    _with_collectives.clear()
