"""The harness finds cells, configurations, kinds, metrics and kernel
families from files alone: adding one is adding a file."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT
from lib import registry
from lib.trace import Trace

KERNELS = {
    "void mint_mlp::(anonymous namespace)::gemm_tc_kernel<192, true>(...)":
        ("mlp", "forward"),
    "mint_mlp::(anonymous namespace)::reduce_kernel(float const*, ...)":
        ("mlp", "forward"),
    "void (anonymous namespace)::attention_tc_kernel<80, 0>(...)":
        ("attention", "forward"),
    "void (anonymous namespace)::layer_norm_bf16_kernel<true>(...)":
        ("layer_norm", "forward"),
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<float, float>(...)": ("layer_norm", "forward"),
    # No metric reads the LayerNorm backward yet: no family claims it.
    "void at::native::(anonymous namespace)::layer_norm_grad_input_kernel"
    "<float, float>(...)": None,
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
    "<...>(...)": ("optimizer", "optimizer"),
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(...)>": ("copies", "any"),
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
        ("projections", "any"),
    "nvjet_sss_192x192_64x3_2x1_v_bz_TNN": ("projections", "any"),
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)":
        ("allreduce", "communication"),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_families(name):
    fam = registry.family_of(name, registry.kernel_families())
    assert (fam and (fam["op"], fam["pass"])) == KERNELS[name]


def test_benchmark_names_exist_as_files():
    bench = registry.benchmark(ROOT)
    for cell in bench["workloads"]:
        spec = registry.cell(cell["name"])
        assert spec["config"] == cell["config"]
        assert spec["chips"] == cell["chips"]
        registry.config(spec["config"])
        assert callable(registry.kind(spec["kind"]).run)
    for metric in bench["per_layer"]:
        assert callable(registry.metric(metric["name"]).read)
    for config in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, config["file"]))


def test_every_cell_reports_setup_and_a_layer():
    bench = registry.benchmark(ROOT)
    for cell in bench["workloads"]:
        e2e = registry.end_to_end(bench, cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer(bench, cell["name"])


def test_new_pieces_are_new_files(tiny_bench):
    """A cell, a configuration, a kind, a metric and a kernel family added
    as files are found, and nothing else changes."""
    with open(os.path.join(tiny_bench, "kernels", "widget.json"), "w") as f:
        json.dump({"op": "widget", "pass": "forward", "priority": 5,
                   "patterns": ["widget_kernel"]}, f)
    with open(os.path.join(tiny_bench, "metrics", "widget_roofline.decode.py"),
              "w") as f:
        f.write("def read(trace):\n    return trace.roofline('widget')\n")
    with open(os.path.join(tiny_bench, "kinds", "echo.py"), "w") as f:
        f.write("def run(ctx):\n    return {'cell': ctx.name}\n")
    with open(os.path.join(tiny_bench, "cells", "echo_cell.json"), "w") as f:
        json.dump({"config": "tiny_f32", "kind": "echo", "chips": 1}, f)

    fams = registry.kernel_families(tiny_bench)
    assert registry.family_of("void widget_kernel<1>()", fams)["op"] == \
        "widget"
    assert registry.family_of("void widget_kernel<1>()",
                              registry.kernel_families()) is None
    cell = registry.cell("echo_cell", tiny_bench)
    assert registry.config(cell["config"], tiny_bench)["hidden_size"] == 16
    assert registry.kind("echo", tiny_bench).run(
        type("C", (), {"name": "echo_cell"})()) == {"cell": "echo_cell"}
    trace = Trace(device=[("void widget_kernel<1>()", 0, 2000)], host=[],
                  window=(0, 4000), units=2, bounds={"widget": 5e-7},
                  flops=1.0, peak=1.0, families=fams)
    assert registry.metric("widget_roofline.decode", tiny_bench).read(
        trace) == pytest.approx(50.0)
    with pytest.raises(KeyError):
        registry.cell("echo_cell")  # only in the copy


def test_metric_lists_follow_benchmark_json():
    bench = {"end_to_end": [
        {"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
        "per_layer": [
        {"name": "x", "moves": "rate"},
        {"name": "y", "moves": "setup_s", "workloads": ["b"]}]}
    assert set(registry.end_to_end(bench, "a")) == {"rate", "setup_s"}
    assert set(registry.end_to_end(bench, "b")) == {"setup_s"}
    assert set(registry.per_layer(bench, "a")) == {"x"}
    assert set(registry.per_layer(bench, "b")) == {"y"}


def test_trace_reductions():
    fams = registry.kernel_families()
    mlp = "mint_mlp::(anonymous namespace)::gemm_tc_kernel<192, true>"
    dev = [(mlp, 100, 300), ("nccl_allreduce", 200, 500),
           ("Memcpy HtoD", 600, 700), (mlp, 800, 900)]
    host = [("cudaGraphLaunch", 0, 1000), ("aten::copy_", 520, 590)]
    tr = Trace(device=dev, host=host, window=(0, 1000), units=2,
               bounds={"mlp": 1.5e-7}, flops=2e-7, peak=1.0,
               families=fams)
    # Busy is the union, not the sum: [100, 500] + [600, 700] + [800, 900].
    assert tr.busy_s() == pytest.approx(600e-9)
    assert tr.idle_share() == pytest.approx(40.0)
    assert len(tr.kernels()) == 3
    assert tr.roofline("mlp", "forward") == pytest.approx(100.0)
    assert tr.mfu() == pytest.approx(100.0 * 4e-7 / 1e-6)
    br = tr.breakdown()
    assert br["device_ops"][0] == [mlp, pytest.approx(300e-9)]
    assert dict(br["idle_gaps"])["aten::copy_"] == pytest.approx(100e-9)
    assert tr.roofline("attention") is None

