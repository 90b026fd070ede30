"""CPU tests of the benchmark: the harness at a tiny size, with the
program's plain versions standing in for its kernels.

    python -m pytest port_bench/tests -q

A tiny configuration and tiny cells are written as files into a copy of
the benchmark's folder, the way a later change adds them.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY = {
    "precision": "f32", "hidden_size": 16, "num_attention_heads": 2,
    "intermediate_size": 24, "motion_layers": 1, "audio_layers": 1,
    "cross_layers": 2, "motion_seq_length": 6, "audio_seq_length": 8,
    "motion_dim": 9, "audio_dim": 5, "out_dim": 9,
    "output_initializer_range": 0.02, "batch_size": 4,
    "learning_rates": [1e-3, 1e-4], "learning_rate_boundaries": [100],
    "grad_clip_norm": 0.0, "motion_input_length": 6, "target_length": 3,
    "target_shift": 6, "audio_input_length": 8, "data_parallel": 1,
}

# Limits between the tiny program's readings and its control's (CPU,
# seeds 1, 2, 3 and 2**33 + 7): f32 decode 2.9e-7 to 6.0e-7 against
# TF32's 8.0e-4 to 1.8e-3; f32 training's grad_gap 1.1e-7 to 2.3e-7
# against 2.6e-4 to 9.6e-4; bf16 decode 6.5e-3 to 1.2e-2 against fp8's
# 0.11 to 0.20; bf16 training's grad_gap 5.7e-3 to 7.5e-3 against 0.064
# to 0.107.
TINY_CELLS = {
    "tiny_decode": {"config": "tiny_f32", "kind": "decode", "chips": 1,
                    "batch": 3, "steps": 10,
                    "check": {"clips": 2, "frames": 4, "frame_gap": 1e-4}},
    "tiny_train": {"config": "tiny_f32", "kind": "train", "chips": 1,
                   "sequences": 5, "frames": 20,
                   "check": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                             "change_gap": 1e-2}},
    "tiny_decode_bf16": {"config": "tiny_bf16", "kind": "decode",
                         "chips": 1, "batch": 3, "steps": 10,
                         "check": {"clips": 2, "frames": 4,
                                   "frame_gap": 0.04}},
    "tiny_train_bf16": {"config": "tiny_bf16", "kind": "train", "chips": 1,
                        "sequences": 5, "frames": 20,
                        "check": {"loss_gap": 2e-3, "grad_gap": 0.02,
                                  "change_gap": 0.1}},
    "tiny_train_dp4": {"config": "tiny_dp4", "kind": "train", "chips": 4,
                       "sequences": 5, "frames": 20,
                       "check": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                                 "change_gap": 1e-2}},
}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder with tiny configurations and tiny
    cells added as files."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "configs" / "tiny_f32.json").write_text(json.dumps(TINY))
    (bench / "configs" / "tiny_bf16.json").write_text(
        json.dumps(dict(TINY, precision="bf16")))
    (bench / "configs" / "tiny_dp4.json").write_text(
        json.dumps(dict(TINY, data_parallel=4, batch_size=8)))
    for name, cell in TINY_CELLS.items():
        (bench / "cells" / f"{name}.json").write_text(json.dumps(cell))
    return str(bench)
