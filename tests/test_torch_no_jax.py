"""The port stands alone: no JAX stack, no CUDA toolchain on the CPU path.

The machine with the card has no jax, flax, optax, orbax or absl, so
``mint_tpu_torch``, ``chip_smoke.py`` and the port's profile scripts
(``scripts/torch_*.py``) must import none of them, and nothing of the JAX package ``mint_tpu`` either:
the port keeps its own copy of the config schema (``mint_tpu_torch.config``).
"""

import ast
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "absl")

_CHILD = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import mint_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mint_tpu_torch.__path__,
                                               "mint_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mint_tpu_torch.config import schema as S
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.ops import _build

def tf():
    return S.TransformerConfig(hidden_size=16, num_hidden_layers=1,
                               num_attention_heads=2, intermediate_size=32)

def modality(name, seq, dim):
    return S.ModalityConfig(feature_name=name, sequence_length=seq,
                            feature_dim=dim,
                            model=[S.ModalityModelConfig(transformer=tf())])

cfg = S.FACTModelConfig(
    modality=[modality("audio", 6, 35), modality("motion", 4, 9)],
    cross_modal_model=S.CrossModalModelConfig(
        modality_a="motion", modality_b="audio", transformer=tf(),
        output_layer=S.MLPConfig(out_dim=9)))
model = init_params(FACT(cfg).eval(), torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
with torch.no_grad():
    out = model({"motion_input": torch.randn(2, 4, 9),
                 "audio_input": torch.randn(2, 6, 35)})
assert out.shape == (2, 10, 9) and torch.isfinite(out).all()
frames = decoder.infer_auto_regressive(
    model, {"motion_input": rng.standard_normal((2, 4, 9), np.float32),
            "audio_input": rng.standard_normal((2, 10, 35), np.float32)},
    steps=5)
assert frames.shape == (2, 5, 9) and torch.isfinite(frames).all()

import tempfile
from mint_tpu_torch.train import (CheckpointManager, Controller, Trainer,
                                  schedules)
trainer = Trainer(model, schedules.constant(1e-3), grad_clip_norm=1.0)
batch = {"motion_input": rng.standard_normal((2, 4, 9), np.float32),
         "audio_input": rng.standard_normal((2, 6, 35), np.float32),
         "target": rng.standard_normal((2, 2, 9), np.float32)}
def batches():
    while True:
        yield batch
with tempfile.TemporaryDirectory() as tmp:
    ctl = Controller(trainer=trainer, train_iter=batches(),
                     state=trainer.init_state(model), steps_per_loop=2,
                     checkpoint_manager=CheckpointManager(tmp),
                     summary_dir=tmp)
    metrics = ctl.train(3)
    ctl.close()
assert ctl.global_step == 3 and np.isfinite(metrics["loss"])
assert _build._lib is None, "the CPU path must not build the kernels"
print("MODULES", len(names))
print("LOADED", " ".join(sorted(sys.modules)))
"""


def test_port_imports_no_jax_stack_and_builds_nothing_on_cpu():
    env = dict(os.environ, PATH="/usr/bin:/bin")  # no nvcc on the path
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("MODULES", "LOADED")))
    assert int(lines["MODULES"]) >= 35
    loaded = lines["LOADED"].split()
    roots = {name.split(".")[0] for name in loaded}
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    from_jax_pkg = [n for n in loaded if n.split(".")[0] == "mint_tpu"]
    assert not from_jax_pkg, from_jax_pkg


def _port_sources():
    scripts = os.path.join(REPO, "scripts")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
        if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "mint_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def _without_function(text, name):
    """`text` with the lines of the top-level function `name` blanked,
    and those lines."""
    lines = text.splitlines()
    fn = next(node for node in ast.parse(text).body
              if isinstance(node, ast.FunctionDef) and node.name == name)
    span = range(fn.lineno - 1, fn.end_lineno)
    body = "\n".join(lines[i] for i in span)
    rest = "\n".join("" if i in span else line
                     for i, line in enumerate(lines))
    return rest, body


SDPA = "scaled_dot_product_attention"


def test_sources_use_no_jax_and_no_stand_in_kernels():
    imports = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    jax_pkg = re.compile(r"^\s*(import\s+mint_tpu\b|from\s+mint_tpu[.\s])",
                         re.M)
    stand_ins = re.compile(SDPA + r"|sdpa|torch\.compile|"
                           r"cudnn\.(?!allow_tf32)|cublas", re.I)
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, REPO)
        assert not imports.search(text), rel
        assert not jax_pkg.search(text), rel
        if rel == "chip_smoke.py":
            # The library call is timed as a yardstick (library_ms) in
            # time_kernels and nowhere else; the port never calls it.
            text, yardstick = _without_function(text, "time_kernels")
            assert SDPA in yardstick
        assert not stand_ins.search(text), rel


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA: exit non-zero and print no result; the same for the script
    alone, outside the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, None)):
        if script is None:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
            script = str(tmp_path / "chip_smoke.py")
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
