"""The port's tracing (``mint_tpu_torch/utils/profiling.py`` and where the
program calls it) on the CPU: the guarded span, the spans of the trainer,
the data draw and the decode loop under a CPU ``torch.profiler``, the
phase stamps of the training step's body (recorded by a stand-in for
``profiling.stamp``, since the stamp kernel runs only on a card), over
one device and over a 2-rank gloo mesh, and the phase arithmetic.
"""

import collections
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from mint_tpu_torch.data.device_dataset import DeviceDataset
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.ops import _build
from mint_tpu_torch.parallel.dryrun import (free_port, run_ranks,
                                            tiny_fact_config)
from mint_tpu_torch.train import Trainer, schedules
from mint_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds a rank may take
ONE_DEVICE = ["begin", "forward", "backward", "update"]
OVER_A_MESH = ["begin", "forward", "backward", "exchange", "update"]


def _tiny_model(seed=0):
    """The JAX entry's tiny FACT: width 32, windows of 8 motion and 16
    audio frames."""
    return init_params(FACT(tiny_fact_config()),
                       torch.Generator().manual_seed(seed))


def _batch(rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"motion_input": rng.standard_normal((rows, 8, 9), np.float32),
            "audio_input": rng.standard_normal((rows, 16, 35), np.float32),
            "target": rng.standard_normal((rows, 4, 9), np.float32)}


@pytest.fixture
def stamps(monkeypatch):
    """The phases the program stamps, in order, in place of the kernel."""
    calls = []
    monkeypatch.setattr(profiling, "stamp",
                        lambda slots, phase: calls.append(phase))
    return calls


# -- the span ------------------------------------------------------------------

def test_annotate_without_a_profiler_enters_nothing(monkeypatch):
    """With no profiler running, every span is one shared null context
    and no record_function is made."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    span = profiling.annotate("mint.a")
    assert span is profiling.annotate("mint.b")
    with span as entered:
        with profiling.annotate("mint.c"):
            assert entered is None


def test_annotate_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        span = profiling.annotate("mint.under_a_profiler")
        with span:
            torch.ones(8).sum()
    assert isinstance(span, torch.profiler.record_function)
    assert "mint.under_a_profiler" in {e.name for e in prof.events()}


def test_spans_of_a_sampled_train_step_and_a_decode():
    """One ``train_steps_sampled`` step: a ``mint.train.sample`` span and
    then a ``mint.train.step`` span beside it (neither inside the other,
    so their sum is the host's time a step); a decode of 3 steps: one
    ``mint.decode.step`` a step, none inside another."""
    model = _tiny_model()
    rng = np.random.default_rng(1)
    dset = DeviceDataset.from_sequences(
        [rng.standard_normal((30, 9), np.float32) for _ in range(3)],
        [rng.standard_normal((30, 35), np.float32) for _ in range(3)],
        8, 4, 8, 16, batch_size=2, device="cpu")
    trainer = Trainer(model, schedules.constant(1e-3))
    state = trainer.init_state(model)
    x = {"motion_input": rng.standard_normal((2, 8, 9), np.float32),
         "audio_input": rng.standard_normal((2, 18, 35), np.float32)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, _ = trainer.train_steps_sampled(state, dset, 1, seed=3)
        decoder.infer_auto_regressive(model, x, steps=3)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("mint."))
    assert collections.Counter(name for _, _, name in spans) == {
        "mint.train.sample": 1, "mint.train.step": 1,
        "mint.decode.step": 3}
    assert [name for _, _, name in spans[:2]] == ["mint.train.sample",
                                                  "mint.train.step"]
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start
    # The step's span holds the step's work: the forward's ops run in it.
    step = next(s for s in spans if s[2] == "mint.train.step")
    inside = {e.name for e in prof.events()
              if step[0] < e.time_range.start < step[1]}
    assert "aten::mm" in inside or "aten::addmm" in inside, sorted(inside)


# -- the stamps ----------------------------------------------------------------

def test_stamp_on_the_cpu_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "library", refuse)
    slots = torch.zeros(len(profiling.PHASES), dtype=torch.int64)
    for phase in profiling.PHASES:
        profiling.stamp(slots, phase)
    assert not slots.any()


def test_phases_are_the_stamp_kernels():
    """One kernel a phase in ``csrc/trace.cu``, and its C entry's
    signature beside the others'."""
    with open(os.path.join(_build.CSRC, "trace.cu")) as f:
        source = f.read()
    assert int(re.search(r"kPhases = (\d+);", source).group(1)) == len(
        profiling.PHASES)
    assert "mint_trace_stamp" in _build._SIGNATURES


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_body_stamps_its_phases_in_order(stamps, accumulate):
    """On one device every step's body stamps begin, forward, backward and
    update, a micro-step as a full one; ``loss_and_grads`` outside a
    step stamps nothing."""
    model = _tiny_model()
    trainer = Trainer(model, schedules.constant(1e-3), grad_clip_norm=0.05,
                      accumulate_steps=accumulate)
    state = trainer.init_state(model)
    runs = []
    for i in range(2 * accumulate):
        stamps.clear()
        state, _ = trainer.train_step(state, _batch(seed=i))
        runs.append(list(stamps))
    assert runs == [ONE_DEVICE] * (2 * accumulate)
    stamps.clear()
    trainer.loss_and_grads(state.params, _batch())
    assert stamps == []


def test_phase_ms_on_the_cpu_is_none():
    model = _tiny_model()
    trainer = Trainer(model, schedules.constant(1e-3))
    assert trainer.phase_ms() is None
    trainer.train_step(trainer.init_state(model), _batch())
    assert trainer.phase_ms() is None


@pytest.mark.parametrize("exchange", [False, True])
def test_phase_ms_from_stamps(exchange):
    """Each phase from the end of the one before it; the phases sum to
    the run from begin to update."""
    ns = [1_000_000_000, 1_007_500_000, 1_050_000_000, 1_053_250_000,
          1_060_000_000]
    got = profiling.phase_ms(ns, exchange)
    want = ({"forward": 7.5, "backward": 42.5, "exchange": 3.25,
             "update": 6.75} if exchange else
            {"forward": 7.5, "backward": 42.5, "update": 10.0})
    assert got == pytest.approx(want, abs=1e-9)
    assert sum(got.values()) == pytest.approx(60.0)
    assert profiling.phase_ms([0] * len(profiling.PHASES), exchange) is None


_RANK = r"""
import json, sys

import numpy as np
import torch.distributed as dist

from mint_tpu_torch.config import schema as S
from mint_tpu_torch.models import builder
from mint_tpu_torch.parallel import mesh as mesh_lib
from mint_tpu_torch.parallel.dryrun import tiny_fact_config
from mint_tpu_torch.train import Trainer, schedules
from mint_tpu_torch.utils import profiling

rank, world, port = map(int, sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
mesh = mesh_lib.make_mesh(data=world, model=1)
calls = []
profiling.stamp = lambda slots, phase: calls.append(phase)
model = builder.build(S.MultiModalModelConfig(fact_model=tiny_fact_config()),
                      is_training=True, device="cpu", mesh=mesh)
rng = np.random.default_rng(rank)
batch = {"motion_input": rng.standard_normal((2, 8, 9), np.float32),
         "audio_input": rng.standard_normal((2, 16, 35), np.float32),
         "target": rng.standard_normal((2, 4, 9), np.float32)}
runs = {}
for accumulate in (1, 2):
    trainer = Trainer(model, schedules.constant(1e-3), grad_clip_norm=0.05,
                      accumulate_steps=accumulate, mesh=mesh)
    state = trainer.init_state(model)
    runs[accumulate] = []
    for _ in range(accumulate):
        calls.clear()
        state, _ = trainer.train_step(state, batch)
        runs[accumulate].append(list(calls))
print("STAMPS " + json.dumps(runs))
mesh_lib.leave()
"""


def test_mesh_body_stamps_the_exchange(monkeypatch):
    """Over a 2-rank gloo mesh every rank's step stamps begin, forward,
    backward, exchange (after the all-reduce) and update, and so do a
    micro-step and the update step after it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    port = free_port()
    outputs = run_ranks(lambda r: [sys.executable, "-c", _RANK, str(r), "2",
                                   str(port)], 2, TIMEOUT)
    for out in outputs:
        line = next(x for x in out.splitlines() if x.startswith("STAMPS "))
        runs = json.loads(line[len("STAMPS "):])
        assert runs == {"1": [OVER_A_MESH], "2": [OVER_A_MESH] * 2}
