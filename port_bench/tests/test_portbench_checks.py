"""The comparison that decides ``correct``, at a tiny size on the CPU: a
sound run passes, its control (the reference in the precision below the
configuration's) fails, and a run whose timed path is broken underneath
comes out not correct, once for each fault its cell can have."""

from __future__ import annotations

import time

import pytest
import torch

import run
from lib import registry

CPU = torch.device("cpu")
SEED = 2**33 + 7


def outcome(bench, cell, seed=SEED, seconds=0.0, hooks=None):
    out = run.measure(cell, seed, seconds, False, CPU, time.perf_counter(),
                      hooks=hooks, bench_dir=bench)
    line = run.result(cell, out, False, {}, _bench(), bench)
    return out, line


def _bench():
    return {"end_to_end": [], "per_layer": []}


@pytest.mark.parametrize("cell", ["tiny_decode", "tiny_train",
                                  "tiny_decode_bf16", "tiny_train_bf16"])
def test_sound_run_is_correct(tiny_bench, cell):
    out, line = outcome(tiny_bench, cell, seconds=0.2)
    assert line["correct"], line["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny_decode", "tiny_train",
                                  "tiny_decode_bf16", "tiny_train_bf16"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tiny_bench, cell, seed):
    spec = registry.cell(cell, tiny_bench)
    ctx = run.Context(cell, spec, registry.config(spec["config"], tiny_bench),
                      seed, 0.0, False, CPU,
                      registry.kernel_families(tiny_bench),
                      time.perf_counter())
    ctx.hooks = None
    readings = registry.kind(spec["kind"], tiny_bench).calibrate(ctx)
    limits = spec["check"]
    assert all(v <= limits[k] for k, v in readings["program"].items())
    control = next(v for k, v in readings.items()
                   if k.startswith("control_"))
    assert any(v > limits[k] for k, v in control.items()), control


# -- faults planted under a decode ------------------------------------------

def _altered(monkeypatch):
    from mint_tpu_torch.infer import decoder

    real = decoder._forward_from_embedded

    def altered(model, m, a, rows):
        return real(model, m, a, rows) + 1e-2

    monkeypatch.setattr(decoder, "_forward_from_embedded", altered)


def _unchanged_state(monkeypatch):
    from mint_tpu_torch.infer import decoder

    def body(self):
        audio = self.audio_emb.index_select(1, self.window + self.index)
        out = decoder._forward_from_embedded(self.model, self.motion_emb,
                                             audio, self.last_block_rows)
        self.frames.index_copy_(1, self.index.view(1),
                                out[:, 0:1].to(self.frames.dtype))
        self.index += 1  # the motion window is never rolled

    monkeypatch.setattr(decoder._Loop, "body", body)


def _half_batch(monkeypatch):
    from mint_tpu_torch.infer import decoder

    real = decoder._forward_from_embedded

    def half(model, m, a, rows):
        keep = m.shape[0] // 2
        out = real(model, m[:keep], a[:keep], rows)
        return torch.cat([out, torch.zeros_like(out[:1]).expand(
            m.shape[0] - keep, *out.shape[1:])])

    monkeypatch.setattr(decoder, "_forward_from_embedded", half)


@pytest.mark.parametrize("cell", ["tiny_decode", "tiny_decode_bf16"])
@pytest.mark.parametrize("fault", [_altered, _unchanged_state, _half_batch])
def test_decode_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    _, line = outcome(tiny_bench, cell)
    assert not line["correct"], line["checks"]


# -- faults planted under training ------------------------------------------

def _train_unchanged(model, trainer, dataset):
    trainer._update = lambda *args, **kwargs: None


def _train_half_batch(model, trainer, dataset):
    real = trainer.loss

    def half(params, batch):
        keep = next(iter(batch.values())).shape[0] // 2
        return real(params, {k: v[:keep] for k, v in batch.items()})

    trainer.loss = half


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_train_bf16"])
@pytest.mark.parametrize("fault", [_train_unchanged, _train_half_batch])
def test_train_fault_is_not_correct(tiny_bench, cell, fault):
    _, line = outcome(tiny_bench, cell, hooks=fault)
    assert not line["correct"], line["checks"]
