"""The data-parallel training cell's path over four gloo ranks on the
CPU, a process a rank as on the cards, started by the harness itself
(``run.run_cell`` past its look for cards): a sound run is correct, one
whose gradient exchange between the ranks is left out is not, and one in
which a rank other than 0 loads a JAX module prints no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

LAUNCHER = """
import os, sys, types, torch
sys.path[:0] = [{root!r}, {bench!r}]
import run
rank = int(os.environ.get(run.RANK_ENV, "0"))
if {fault!r} == "no_exchange":
    from mint_tpu_torch.train import trainer
    trainer.Trainer._data_mean = lambda self, loss, grads: (loss, list(grads))
if {fault!r} == "jax_in_rank_2" and rank == 2:
    sys.modules["jax"] = types.ModuleType("jax")
sys.exit(run.run_cell(run.parse(sys.argv[1:]), torch.device("cpu"), "cpu",
                      sys.argv[1:], bench_dir={tiny!r}))
"""


def launch(tiny_bench, fault):
    """Rank 0 of `tiny_train_dp4`, which starts ranks 1-3: (its exit code,
    its standard output's lines, its standard error)."""
    root = os.path.dirname(tiny_bench)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump({"end_to_end": [{"name": "setup_s", "unit": "s"}],
                   "per_layer": []}, f)
    script = os.path.join(root, "launch.py")
    with open(script, "w") as f:
        f.write(LAUNCHER.format(root=ROOT, bench=BENCH_DIR, fault=fault,
                                tiny=tiny_bench))
    out = subprocess.run(
        [sys.executable, script, "--workload", "tiny_train_dp4", "--seed",
         str(2**33 + 7), "--seconds", "0.2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    return out.returncode, out.stdout.strip().splitlines(), out.stderr


@pytest.mark.parametrize("fault, correct", [(None, True),
                                            ("no_exchange", False),
                                            ("jax_in_rank_2", None)])
def test_data_parallel_ranks(tiny_bench, fault, correct):
    rc, lines, err = launch(tiny_bench, fault)
    if correct is None:  # no result, and the rank that loaded JAX named
        assert rc != 0 and not lines, (rc, lines)
        assert "rank 2 loaded jax" in err and "rank(s) [2] failed" in err
        return
    assert rc == 0, err[-3000:]
    line = json.loads(lines[-1])
    assert line["correct"] is correct, line["checks"]
    assert line["attempted"] > 0
    assert line["metrics"]["setup_s"]["value"] > 0
