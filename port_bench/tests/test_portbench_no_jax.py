"""Nothing the benchmark runs loads the JAX stack or the JAX package,
compared by whole top-level names: the port's own name begins with the
JAX package's."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT
from lib import common

SOURCES = sorted(p for p in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                                      recursive=True)
                 if os.sep + "tests" + os.sep not in p)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, BENCH_DIR) for p in SOURCES])
def test_no_source_imports_jax(path):
    assert not set(_top_level_imports(path)) & set(common.FORBIDDEN)


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "mint_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert "mint_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mint_tpu.probe", sys)
    assert "mint_tpu" in common.forbidden_modules()


def test_running_a_cell_loads_no_jax():
    """A fresh process imports the harness, every kind and metric, and
    what they import of the program, then runs a tiny decode and training
    on the CPU: no JAX module is loaded."""
    code = f"""
import sys, json, time, torch
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}, {os.path.join(BENCH_DIR, 'tests')!r}]
import run, conftest, tempfile, pathlib, shutil
from lib import registry, common
tmp = pathlib.Path(tempfile.mkdtemp())
bench = tmp / "port_bench"
shutil.copytree(conftest.BENCH_DIR, bench,
                ignore=shutil.ignore_patterns("__pycache__", "tests"))
(bench / "configs" / "tiny_f32.json").write_text(json.dumps(conftest.TINY))
for name in ("tiny_decode", "tiny_train"):
    (bench / "cells" / (name + ".json")).write_text(
        json.dumps(conftest.TINY_CELLS[name]))
    run.measure(name, 5, 0.0, False, torch.device("cpu"), time.perf_counter(),
                bench_dir=str(bench))
for m in registry.benchmark()["per_layer"]:
    registry.metric(m["name"])
for k in ("decode", "train"):
    registry.kind(k)
shutil.rmtree(tmp)
print(json.dumps(common.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
