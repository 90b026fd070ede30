"""The benchmark's count of work: the formulas copied from
``chip_smoke.py`` against the bounds the repo's kernel table gives, and
the model-FLOP counts against a count made by hand."""

from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH_DIR
from lib import work


def flagship() -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "fact_cm12_bf16.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("what, args, peak, ms, by", [
    ("mlp", (7200, 800, 3072, 800, 2), "bf16", 0.0716, "operations"),
    ("mlp", (960, 800, 3072, 800, 2), "bf16", 0.0095, "operations"),
    ("mlp", (7200, 800, 3072, 800, 4), "f32", 1.0564, "operations"),
    ("mlp", (11520, 800, 3072, 800, 4), "f32", 1.6902, "operations"),
    ("attention", (20, 10, 360, 360, 80, 2), "bf16", 0.0138, "bytes"),
    ("attention", (20, 10, 48, 360, 80, 2), "bf16", 0.0078, "bytes"),
    ("attention", (20, 10, 360, 360, 80, 4), "f32", 0.1238, "operations"),
    ("attention", (32, 10, 360, 360, 80, 2), "bf16", 0.0220, "bytes"),
])
def test_bounds_match_the_kernel_table(what, args, peak, ms, by):
    fn = work.mlp_work if what == "mlp" else work.attention_work
    got, got_by = work.bound(*fn(*args), peak)
    assert got == pytest.approx(ms, abs=5e-5)
    assert got_by == by


def test_layer_norm_bound_is_the_bytes():
    # x[7200,800] bf16 in and out, f32 scale and bias: 0.0069 ms.
    got, by = work.bound(*work.layer_norm_work(7200, 800, 2), "f32")
    assert got == pytest.approx(0.0069, abs=5e-5)
    assert by == "bytes"


def test_model_flops_by_hand():
    g = flagship()
    h, f = 800, 3072
    per_token = 2 * (3 * h * h + h * h + 2 * h * f)

    def attn(nq, nk):
        return 4 * nq * nk * h

    encoders = (2 * (120 * per_token + attn(120, 120))
                + 2 * (240 * per_token + attn(240, 240)))
    cross = 12 * (360 * per_token + attn(360, 360))
    embed = 2 * 120 * 225 * h + 2 * 240 * 35 * h
    head = 2 * 360 * h * 225
    forward = encoders + cross + embed + head
    assert work.forward_flops(g) == pytest.approx(forward, rel=1e-12)
    assert work.train_step_flops(g) == pytest.approx(3 * forward)
    assert work.train_step_flops(g) == pytest.approx(242.9e9, rel=2e-3)
    # A decode step: the last block's queries and the head one row, the
    # audio embedded once a clip, the motion by one new frame.
    last = (2 * 360 * h * 3 * h + attn(1, 360) + 2 * h * h + 4 * h * f)
    step = (encoders + 11 * (360 * per_token + attn(360, 360)) + last
            + 2 * h * 225 + 2 * 225 * h + 2 * 35 * h)
    assert work.decode_step_flops(g) == pytest.approx(step, rel=1e-12)
    assert work.decode_step_flops(g) == pytest.approx(76.4e9, rel=5e-3)


def test_decode_calls_cover_every_block():
    g = flagship()
    calls = work.decode_step_calls(g, 20)
    ops = [c[0] for c in calls]
    assert ops.count("attention") == ops.count("mlp") == 16
    assert ops.count("layer_norm") == 32
    assert ops.count("projections") == 2 * 16 + 2
    bounds = work.bound_seconds(calls, "bf16")
    assert set(bounds) == {"attention", "mlp", "layer_norm", "projections"}
    # 11 full cross blocks at M = 7200 dominate the MLP's bound; the last
    # block's MLP runs over the one row a clip kept (M = 20: its weights'
    # 9.9 MB, 0.0030 ms).
    assert bounds["mlp"] * 1e3 == pytest.approx(
        11 * 0.0716 + 2 * 0.0239 + 2 * 0.0477 + 0.0030, rel=2e-2)
    # The last block's attention: 1 query row against 360 keys; the head
    # over 20 rows.
    attention = [c for c in calls if c[0] == "attention"]
    assert attention[-1][1] == 4.0 * 20 * 10 * 1 * 360 * 80
    assert calls[-1] == ("projections",
                         *work.dense_work(20, 800, 225, 2))
    # Its flops match the model-FLOP count of a step, less the embeddings
    # the decoder makes once a dispatch.
    total = sum(c[1] for c in calls if c[0] != "layer_norm")
    assert total == pytest.approx(
        20 * (work.decode_step_flops(g) - 2 * 35 * 800), rel=1e-12)


def test_train_calls_are_the_forward():
    g = flagship()
    ops = [c[0] for c in work.train_forward_calls(g, 32)]
    assert ops.count("attention") == ops.count("mlp") == 16
    assert ops.count("layer_norm") == 32
