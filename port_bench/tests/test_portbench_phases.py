"""The readers of the program's own tracing (``lib/phases.py`` and the
metrics over it), on synthetic traces: phase stamps at known times, host
spans over CUDA runtime calls, and a profile whose spans are also drawn
on the device's timeline."""

from __future__ import annotations

import time

import pytest
import torch

import run
from lib import phases, registry
from lib.trace import WINDOW, Trace

MS = 1_000_000  # ns
TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train",
         "between_steps_ms.train")
# Phase ms of every synthetic step: forward, backward, exchange, update,
# between.
FORWARD, BACKWARD, EXCHANGE, UPDATE, BETWEEN = 8.0, 42.0, 3.0, 6.0, 1.0


def stamp_name(phase: str) -> str:
    """A stamp kernel's name as the profiler gives it."""
    return (f"void mint_trace::stamp_kernel<{phases.PHASES.index(phase)}>"
            "(long long*)")


def step_events(t0: int, exchange: bool):
    """A step's stamps from `t0` (ns), with a kernel inside each phase."""
    lengths = [("forward", FORWARD), ("backward", BACKWARD)]
    lengths += [("exchange", EXCHANGE)] if exchange else []
    lengths += [("update", UPDATE)]
    out = [(stamp_name("begin"), t0, t0 + 2000)]
    at = t0
    for phase, ms in lengths:
        out.append(("sm90_xmma_gemm_bf16", at + 3000, at + int(ms * MS)
                    - 1000))
        at += int(ms * MS)
        out.append((stamp_name(phase), at, at + 2000))
    return out


def train_trace(steps: int, exchange: bool) -> Trace:
    """`steps` steps' time in a window that opens 2 ms before step 0's
    begin, so that the step before it is cut by the window's start (its
    update inside, its begin outside), and closes 2 ms before step
    `steps`' begin, so that step `steps` - 1 is cut by its end."""
    step = FORWARD + BACKWARD + UPDATE + BETWEEN + (EXCHANGE if exchange
                                                    else 0)
    span = int(step * MS)
    window = (-2 * MS, steps * span - 2 * MS)
    device = [e for k in range(-1, steps + 1)
              for e in step_events(k * span, exchange)
              if e[2] > window[0] and e[1] < window[1]]
    return Trace(device=device, host=[], window=window, units=steps,
                 bounds={}, flops=0.0, peak=1.0,
                 families=registry.kernel_families())


def read(metric: str, trace: Trace):
    return registry.metric(metric).read(trace)


@pytest.mark.parametrize("exchange", [False, True])
def test_stamps_give_each_phase(exchange):
    """Exact phase ms; the steps cut by the window's edges and the last
    step (no next begin in the window) are left out; the phases sum to
    the window's ms a step within 1%."""
    tr = train_trace(24, exchange)
    whole = phases.steps(tr)
    assert len(whole) == 23
    names = TRAIN + (("exchange_ms.train",) if exchange else ())
    got = {m: read(m, tr) for m in names}
    want = {"forward_ms.train": FORWARD, "backward_ms.train": BACKWARD,
            "update_ms.train": UPDATE, "between_steps_ms.train": BETWEEN,
            "exchange_ms.train": EXCHANGE}
    for m in names:
        assert got[m] == pytest.approx(want[m], abs=1e-9), m
    a_step = 1e3 * tr.window_s / tr.units
    assert sum(got.values()) == pytest.approx(a_step, rel=0.01)
    if not exchange:
        assert read("exchange_ms.train", tr) is None


def test_a_step_stamped_out_of_order_is_left_out():
    tr = train_trace(4, False)
    kept = len(phases.steps(tr))
    first = min(i for i, e in enumerate(tr.device)
                if e[0] == stamp_name("forward") and e[1] >= 0)
    del tr.device[first]  # step 0 loses its forward stamp
    assert len(phases.steps(tr)) == kept - 1


def test_a_trace_without_the_programs_tracing_reads_nothing():
    """A program that does not trace itself leaves no stamp and no span:
    every reader of them gives None and raises nothing."""
    gemm = ("sm90_xmma_gemm_bf16", 100, 900)
    tr = Trace(device=[gemm], host=[("cudaGraphLaunch", 0, 50)],
               window=(0, 1000), units=1, bounds={}, flops=0.0, peak=1.0,
               families=registry.kernel_families())
    for m in TRAIN + ("exchange_ms.train", "host_ms.train",
                      "host_ms.decode"):
        assert read(m, tr) is None, m


def test_stamp_kernels_belong_to_no_family():
    """No existing per-layer metric counts a stamp."""
    fams = registry.kernel_families()
    for phase in phases.PHASES:
        assert registry.family_of(stamp_name(phase), fams) is None, phase


def test_phases_are_the_programs():
    from mint_tpu_torch.utils import profiling

    assert phases.PHASES == profiling.PHASES


def test_host_spans_less_the_runtime_calls_under_them():
    """A span's own time is its length less the CUDA calls (and CUDA's
    waits) under it, overlapping ones counted once; spans cut by the
    window are left out; the mean is a span's."""
    host = [
        ("mint.decode.step", 100, 200),
        ("cudaGraphLaunch", 120, 170),
        ("Command Buffer Full", 150, 180),  # overlaps the launch
        ("mint.decode.step", 300, 340),
        ("cuLaunchKernelEx", 310, 320),
        ("aten::copy_", 325, 335),  # the host's own work: kept
        ("mint.decode.step", 950, 1100),  # past the window's end
        ("mint.train.step", 400, 500),
        ("cudaMemcpyAsync", 480, 520),  # past the span's end
        ("mint.train.sample", 520, 540),
        ("cudaLaunchKernel", 530, 532),
    ]
    tr = Trace(device=[], host=host, window=(0, 1000), units=2, bounds={},
               flops=0.0, peak=1.0, families=registry.kernel_families())
    assert read("host_ms.decode", tr) == pytest.approx(
        ((100 - 60) + (40 - 10)) / 2 / 1e6)
    assert read("host_ms.train", tr) == pytest.approx(
        ((100 - 20) + (20 - 2)) / 1e6)


class _Event:
    """A kineto event as ``Trace.from_profile`` reads it."""

    def __init__(self, name, start, end, device):
        self._row = (name, start, end)
        self._device = device

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def duration_ns(self):
        return self._row[2] - self._row[1]

    def device_type(self):
        return self._device


class _Profile:
    def __init__(self, events):
        kineto = type("Kineto", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": kineto})()


def test_span_device_copies_are_dropped():
    """A span is also drawn on the device's timeline under its name (a
    ``gpu_user_annotation`` over the kernels it launched): that copy is no
    device operation, so busy, idle and the kernel counts read as without
    the spans."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kernels = [_Event("void (anonymous namespace)::attention_tc_kernel"
                      "<80, 0>(...)", 100, 300, cuda),
               _Event(stamp_name("begin"), 350, 360, cuda),
               _Event("nvjet_tst_128x288", 600, 700, cuda)]
    base = [_Event(WINDOW, 0, 1000, cpu),
            _Event("cudaGraphLaunch", 50, 90, cpu)] + kernels
    spans = [_Event("mint.decode.step", 40, 95, cpu),
             _Event("mint.decode.step", 90, 800, cuda)]
    kw = dict(units=1, bounds={}, flops=0.0, peak=1.0,
              families=registry.kernel_families())
    without = Trace.from_profile(_Profile(base), **kw)
    with_spans = Trace.from_profile(_Profile(base + spans), **kw)
    assert with_spans.device == without.device
    assert with_spans.idle_share() == pytest.approx(without.idle_share())
    assert len(with_spans.kernels()) == 3
    assert read("host_ms.decode", with_spans) == pytest.approx(
        (55 - 40) / 1e6)


def test_traced_tiny_train_run_reads_the_host_spans(tiny_bench):
    """Through the harness on the CPU: a traced run of the tiny training
    cell holds the program's spans (their reader finds them) and no stamp
    (the CPU stamps nothing)."""
    out = run.measure("tiny_train", 5, 0.0, True, torch.device("cpu"),
                      time.perf_counter(), bench_dir=tiny_bench)
    tr = out["trace"]
    assert read("host_ms.train", tr) > 0
    assert read("forward_ms.train", tr) is None
