"""The EDGE cell's and the eval cell's pieces at a tiny size on the CPU:
the work counts of a DDIM step, both new kinds running a tiny cell, the
registry finding every new file, and the comparison that decides
``correct``: a sound run passes, its control fails, and each fault
planted under the program (a recorded step altered, the stitch skipped,
guidance weight 1, a short eval clip's frames altered) comes out not
correct."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

import run
from conftest import ROOT
from lib import registry, work, work_diffusion
from lib.trace import Trace

CPU = torch.device("cpu")
SEED = 2**33 + 7
EDGE_PUBLISHED = os.path.join(ROOT, "port_bench", "configs",
                              "edge_bf16.json")
TINY_EDGE = {
    "model": "edge", "precision": "f32", "latent_dim": 16, "ff_size": 24,
    "num_layers": 2, "num_heads": 2, "cond_encoder_layers": 2,
    "cond_feature_dim": 12, "nfeats": 7, "seq_len": 6, "n_timestep": 1000,
    "sampling_steps": 5, "eta": 1.0, "guidance_weight": 2.0,
    "clip_denoised": True,
}
# Limits between the tiny program's readings and its control's (CPU,
# seeds 1, 2, 3 and 2**33 + 7): f32 x0_gap 3.7e-7 to 1.1e-6 against
# TF32's 1.5e-3 to 2.6e-3; update_gap 0 against the TF32 update's 3.2e-4
# to 3.9e-4; bf16 x0_gap 0.012 to 0.020 against fp8's 0.15 to 0.24; the
# eval's frame_gap 3.0e-7 to 5.9e-7 against TF32's 9.5e-4 to 2.1e-3.
TINY_EDGE_CELLS = {
    "tiny_diffuse": {"config": "tiny_edge_f32", "kind": "diffuse",
                     "chips": 1, "songs": 2, "frames": 12,
                     "check": {"picks": 3, "steps": 3, "x0_gap": 1e-4,
                               "update_gap": 1e-5}},
    "tiny_diffuse_bf16": {"config": "tiny_edge_bf16", "kind": "diffuse",
                          "chips": 1, "songs": 2, "frames": 12,
                          "check": {"picks": 3, "steps": 3, "x0_gap": 0.04,
                                    "update_gap": 1e-5}},
    "tiny_eval": {"config": "tiny_f32", "kind": "eval", "chips": 1,
                  "clips": 3, "steps": 10, "short_clips": 2,
                  "short_steps": [4, 7], "decode_batch": 2,
                  "check": {"clips": 3, "frames": 4, "frame_gap": 1e-4}},
}


@pytest.fixture
def edge_bench(tiny_bench):
    for prec in ("f32", "bf16"):
        with open(os.path.join(tiny_bench, "configs",
                               f"tiny_edge_{prec}.json"), "w") as f:
            json.dump(dict(TINY_EDGE, precision=prec), f)
    for name, cell in TINY_EDGE_CELLS.items():
        with open(os.path.join(tiny_bench, "cells", f"{name}.json"),
                  "w") as f:
            json.dump(cell, f)
    return tiny_bench


def outcome(bench, cell, seed=SEED, seconds=0.0):
    out = run.measure(cell, seed, seconds, False, CPU, time.perf_counter(),
                      bench_dir=bench)
    line = run.result(cell, out, False, {},
                      {"end_to_end": [], "per_layer": []}, bench)
    return out, line


def test_work_of_a_published_step():
    """One DDIM step over 120 chunks: ~0.88 GFLOP a sequence a layer, 8
    layers, 240 sequences (~1.7 TFLOP); the memory a few hundred GFLOP a
    dispatch; MLP 4 M H F a call."""
    with open(EDGE_PUBLISHED) as f:
        g = json.load(f)
    flops = work_diffusion.step_flops(g, 120, 50)
    per_seq_layer = (2 * 150 * 512 * (2048 + 1024 + 2048)
                     + 4 * 150 * 512 * (150 + 152) + 3 * 2 * 512 * 1024)
    step = 8 * 240 * per_seq_layer
    assert step < flops < step * 1.06
    ops = work_diffusion.work_by_op(g, 120, 50)
    assert ops["mlp"] == pytest.approx(
        8 * 2 * 36000 * 2 * 512 * 1024 + 2 * 2 * 18000 * 2 * 512 * 1024 / 50)
    assert set(work_diffusion.bound_seconds(
        work_diffusion.step_calls(g, 120, 50), "bf16")) == {
        "projections", "attention", "mlp", "layer_norm", "film"}
    # attention: the null branch's rows are one sequence against 152 keys
    cond = work.attention_work(120, 8, 150, 152, 64, 2)
    null = work.attention_work(1, 8, 18000, 152, 64, 2)
    assert cond[0] == null[0]


def test_new_files_are_found():
    for cell in ("eval_bf16_pass", "diffuse_edge_bf16_s8"):
        spec = registry.cell(cell)
        registry.config(spec["config"])
        assert callable(registry.kind(spec["kind"]).run)
        assert callable(registry.kind(spec["kind"]).calibrate)
    for name in ("idle", "mfu", "denoise_ms", "update_ms", "host_ms",
                 "film_roofline", "mlp_roofline", "attention_roofline"):
        assert callable(registry.metric(f"{name}.diffuse").read)
    fams = registry.kernel_families()
    for kernel, want in (
            ("void mint_film::(anonymous namespace)::film_residual_kernel"
             "<8>(...)", ("film", "forward")),
            ("void mint_film::(anonymous namespace)::rotary_kernel<true>"
             "(...)", ("film", "forward")),
            ("void mint_mlp::(anonymous namespace)::gemm_tc_kernel<192, 2>"
             "(...)", ("mlp", "forward"))):
        fam = registry.family_of(kernel, fams)
        assert (fam["op"], fam["pass"]) == want
    # no FACT kernel falls into the new family
    fact = ["void (anonymous namespace)::layer_norm_bf16_kernel<true>(...)",
            "void (anonymous namespace)::attention_tc_kernel<80, 0>(...)",
            "mint_trace::stamp_kernel<0>(long long*)"]
    assert all((registry.family_of(k, fams) or {}).get("op") != "film"
               for k in fact)


def test_diffuse_phases_read_the_stamps():
    fams = registry.kernel_families()
    stamp = "void mint_trace::stamp_kernel<{}>(long long*)"
    dev = []
    for s in range(3):  # begin 0, forward 1, update 4 a step
        t = 1000 * s
        dev += [(stamp.format(0), t, t + 1), (stamp.format(1), t + 600,
                                               t + 601),
                (stamp.format(4), t + 900, t + 901)]
    tr = Trace(device=dev, host=[], window=(0, 4000), units=3, bounds={},
               flops=1.0, peak=1.0, families=fams)
    assert registry.metric("denoise_ms.diffuse").read(tr) == \
        pytest.approx(600e-6)
    assert registry.metric("update_ms.diffuse").read(tr) == \
        pytest.approx(300e-6)
    empty = Trace(device=[], host=[], window=(0, 1), units=1, bounds={},
                  flops=1.0, peak=1.0, families=fams)
    assert registry.metric("denoise_ms.diffuse").read(empty) is None


@pytest.mark.parametrize("cell", ["tiny_diffuse", "tiny_diffuse_bf16",
                                  "tiny_eval"])
def test_sound_run_is_correct(edge_bench, cell):
    out, line = outcome(edge_bench, cell, seconds=0.2)
    assert line["correct"], line["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["e2e"]["decode_frames_per_s"] > 0


def test_eval_counts_real_frames_and_checks_a_short_clip(edge_bench):
    kind = registry.kind("eval", edge_bench)
    cell = registry.cell("tiny_eval", edge_bench)
    n = kind.lengths(cell, SEED)
    assert n[:3] == [10] * 3 and len(set(n[3:])) == 2
    assert all(4 <= k <= 7 for k in n[3:])
    assert any(c >= cell["clips"] for c in kind.checked(cell, SEED))


@pytest.mark.parametrize("cell", ["tiny_diffuse", "tiny_diffuse_bf16",
                                  "tiny_eval"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(edge_bench, cell, seed):
    spec = registry.cell(cell, edge_bench)
    ctx = run.Context(cell, spec, registry.config(spec["config"], edge_bench),
                      seed, 0.0, False, CPU,
                      registry.kernel_families(edge_bench),
                      time.perf_counter())
    readings = registry.kind(spec["kind"], edge_bench).calibrate(ctx)
    limits = spec["check"]
    assert all(v <= limits[k] for k, v in readings["program"].items())
    control = next(v for k, v in readings.items()
                   if k.startswith("control_"))
    assert any(v > limits[k] for k, v in control.items()), control
    for name, fault in readings.items():
        if name.startswith("fault_") and name != "fault_unstitched":
            assert any(v > limits[k] for k, v in fault.items()), name


# -- faults planted under the program -----------------------------------------

def _altered_record(monkeypatch):
    from mint_tpu_torch.infer import diffusion

    real = diffusion.sample

    def altered(*args, **kw):
        out = real(*args, **kw)
        record_out = args[6] if len(args) > 6 else kw.get("record_out")
        record_out[:, 1] += 1e-2
        return out

    monkeypatch.setattr(diffusion, "sample", altered)


def _no_stitch(monkeypatch):
    from mint_tpu_torch.infer import diffusion

    real = diffusion._Loop.load

    def load(self, *args):
        real(self, *args)
        self.first.fill_(True)  # every chunk starts a song: no stitch

    monkeypatch.setattr(diffusion._Loop, "load", load)


def _weight_one(monkeypatch):
    from mint_tpu_torch.infer import diffusion

    real = diffusion.step_table

    def table(*args):
        t = real(*args)
        t[:, diffusion.COLUMNS.index("weight")] = 1.0
        return t

    monkeypatch.setattr(diffusion, "step_table", table)


def _short_clip_altered(monkeypatch):
    from mint_tpu_torch.parallel import replicas

    real = replicas.Replicas.decode

    def decode(self, inputs, steps):
        out = real(self, inputs, steps)
        return out + 1e-2 if steps < 10 else out

    monkeypatch.setattr(replicas.Replicas, "decode", decode)


@pytest.mark.parametrize("fault,cell", [
    (_altered_record, "tiny_diffuse"), (_no_stitch, "tiny_diffuse"),
    (_weight_one, "tiny_diffuse"), (_altered_record, "tiny_diffuse_bf16"),
    (_no_stitch, "tiny_diffuse_bf16"), (_weight_one, "tiny_diffuse_bf16"),
    (_short_clip_altered, "tiny_eval")],
    ids=["record_f32", "stitch_f32", "weight_f32", "record_bf16",
         "stitch_bf16", "weight_bf16", "eval_short"])
def test_fault_is_not_correct(edge_bench, monkeypatch, fault, cell):
    fault(monkeypatch)
    _, line = outcome(edge_bench, cell)
    assert not line["correct"], line["checks"]
