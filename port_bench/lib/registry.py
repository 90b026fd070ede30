"""Finds every piece of the benchmark by its name, from files alone.

- ``BENCHMARK.json`` at the checkout's root: which metrics a cell reports;
- ``cells/<cell>.json``: a cell's configuration, kind and traffic;
- ``configs/<config>.json``: a configuration's sizes;
- ``kinds/<kind>.py``: the driver of one kind of traffic (``run(ctx)``);
- ``metrics/<metric>.py``: the reader of one per-layer metric
  (``read(trace)``, None where it finds nothing to read);
- ``kernels/*.json``: kernel-name families, each with its op and pass.

A new cell, configuration, kind, metric or kernel family is a new file;
nothing here names one.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _named(folder: str, name: str, ext: str, bench_dir: str) -> str:
    path = os.path.join(bench_dir, folder, name + ext)
    if not os.path.isfile(path):
        raise KeyError(f"no {folder[:-1]} named {name!r} ({path})")
    return path


def cell(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(_named("cells", name, ".json", bench_dir))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(_named("configs", name, ".json", bench_dir))


def _module(path: str, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(_named("kinds", name, ".py", bench_dir),
                   f"port_bench_kind_{name}")


def metric(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(_named("metrics", name, ".py", bench_dir),
                   "port_bench_metric_" + name.replace(".", "_"))


def kernel_families(bench_dir: str = BENCH_DIR) -> List[dict]:
    """Every family, in the order a kernel is matched: by `priority`, then
    by name.  A kernel belongs to the first family one of whose patterns
    its name contains."""
    out = []
    for path in glob.glob(os.path.join(bench_dir, "kernels", "*.json")):
        fam = _json(path)
        fam["name"] = os.path.splitext(os.path.basename(path))[0]
        out.append(fam)
    return sorted(out, key=lambda f: (f["priority"], f["name"]))


def family_of(name: str, families: List[dict]) -> Optional[dict]:
    return next((f for f in families
                 if any(p in name for p in f["patterns"])), None)


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> Dict[str, dict]:
    """The end-to-end metrics `cell_name` reports, by name."""
    return {m["name"]: m for m in bench["end_to_end"]
            if _applies(m, cell_name)}


def per_layer(bench: dict, cell_name: str) -> Dict[str, dict]:
    """The per-layer metrics `cell_name` reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    reported = end_to_end(bench, cell_name)
    return {m["name"]: m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)}
