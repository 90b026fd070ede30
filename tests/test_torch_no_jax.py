"""The port stands alone: no JAX stack, no CUDA toolchain on the CPU path.

The machine with the card has no jax, flax, optax, orbax or absl, so
``mint_tpu_torch``, ``chip_smoke.py`` and the port's profile scripts
(``scripts/torch_*.py``) must import none of them, and nothing of the JAX
package ``mint_tpu`` either: the port keeps its own copy of the config
schema (``mint_tpu_torch.config``) and of the host NumPy modules of the
scoring path (``eval/fid.py``, ``eval/features.py``, ``eval/beat_align.py``,
``data/aist.py``) and of the audio frontend's host steps (``audio/wav.py``,
``resample.py``, ``onset.py``, ``beat.py``).  The child process below
imports every module of the port (``utils/graphs.py``, the CUDA graphs of
the decode and the train step, and ``parallel/``, the mesh of ranks and
the decode replicas, among them) and runs its forward, decode, fused
training loop, scoring and audio feature paths on the CPU, where no graph
is captured, then a decode over two CPU replicas, a model's slices
round-tripped through the mesh's partition rules, and the reference
checkpoint's name map; then it opens the port's C++ train loader (built
from the port's own source) over a small shard and runs the forward of
the model with its LayerNorm affines folded.  The port's sources never
name the JAX package's native library.
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
                     summary_dir=tmp, fuse_loop=True)
    metrics = ctl.train(3)
    ctl.close()
assert ctl.global_step == 3 and np.isfinite(metrics["loss"])

import os
from mint_tpu_torch.eval import (extract_kinetic_features,
                                 extract_manual_features)
from mint_tpu_torch.eval.beat_align import clip_beat_alignment
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.eval.fid import frechet_feature_distance
from mint_tpu_torch.motion.rotation import recover_to_axis_angles
from mint_tpu_torch.motion.smpl import smpl_joints
with tempfile.TemporaryDirectory() as tmp:
    clip = {"motion_input": batch["motion_input"][:1],
            "audio_input": rng.standard_normal((1, 9, 35), np.float32),
            "motion_name": ["m"], "audio_name": ["a"]}
    Evaluator(model, [clip], output_dir=tmp, steps=3).evaluate()
    assert np.load(os.path.join(tmp, "m_a.npy")).shape == (4 + 3, 9)
motion = torch.from_numpy(rng.standard_normal((1, 40, 225), np.float32))
aa, transl = recover_to_axis_angles(motion)
joints = smpl_joints(aa[0], transl[0], device="cpu").numpy()
feats = np.concatenate([extract_kinetic_features(joints),
                        extract_manual_features(joints)])
assert feats.shape == (72 + 32,) and np.isfinite(feats).all()
assert np.isfinite(frechet_feature_distance(
    rng.standard_normal((8, 3)), rng.standard_normal((8, 3))))
beats = np.zeros((60, 35), np.float32)
beats[::10, 34] = 1
assert clip_beat_alignment(joints, beats) is not None
from mint_tpu_torch.audio import extract_audio_features
sr = 30720
y = np.zeros(2 * sr, np.float32)
for k in range(4):  # a click every half second
    y[k * sr // 2:k * sr // 2 + 200] = rng.uniform(-0.5, 0.5, 200)
audio = extract_audio_features(y, sr, start_bpm=120, device="cpu")
assert audio.shape == (121, 35) and np.isfinite(audio).all()
assert audio[:, 34].sum() > 0
from mint_tpu_torch.parallel import (Mesh, attention_heads, shard_state_dict,
                                     unshard_state_dict)
from mint_tpu_torch.parallel.replicas import Replicas
from mint_tpu_torch.tools import convert_checkpoint
replicas = Replicas(model, ["cpu", "cpu"])
two = replicas.decode({"motion_input": rng.standard_normal((2, 4, 9),
                                                           np.float32),
                       "audio_input": rng.standard_normal((2, 8, 35),
                                                          np.float32)},
                      steps=3)
assert two.shape == (2, 3, 9) and np.isfinite(two).all()
full = model.state_dict()
back = unshard_state_dict([shard_state_dict(full, Mesh(1, 2, r),
                                            attention_heads(model))
                           for r in range(2)])
assert all(torch.equal(back[k], full[k]) for k in full)
state, report = convert_checkpoint.convert_tf_variables(
    convert_checkpoint.tf_variables_of(model), model)
assert not report and all(torch.equal(state[k], full[k]) for k in full)
assert _build._lib is None, "the CPU path must not build the kernels"
from mint_tpu_torch.utils import graphs
assert graphs.of(model).captures == 0, "the CPU path captures no graph"
import tempfile
from mint_tpu_torch.data import native_loader
from mint_tpu_torch.data.example import encode_example
from mint_tpu_torch.data.tfrecord import TFRecordWriter
from mint_tpu_torch.models import fold
with tempfile.TemporaryDirectory() as tmp:
    shard = tmp + "/shard"
    with TFRecordWriter(shard) as w:
        for i in range(3):
            m = rng.standard_normal((30, 219)).astype(np.float32)
            a = rng.standard_normal((30, 35)).astype(np.float32)
            w.write(encode_example({
                "motion_sequence": m.ravel(),
                "motion_sequence_shape": np.asarray(m.shape, np.int64),
                "audio_sequence": a.ravel(),
                "audio_sequence_shape": np.asarray(a.shape, np.int64)}))
    loader = native_loader.NativeTrainLoader(
        [shard], batch_size=2, motion_input_len=4, target_len=2,
        target_shift=4, audio_input_len=6, seed=1)
    batch = next(loader)
    loader.close()
assert batch["motion_input"].shape == (2, 4, 225)
assert native_loader.library_path().startswith(native_loader.BUILD_DIR)
folded, _ = fold.fold_for_decode(model, model.state_dict())
inputs = {"motion_input": torch.from_numpy(
              rng.standard_normal((1, 4, 9)).astype(np.float32)),
          "audio_input": torch.from_numpy(
              rng.standard_normal((1, 6, 35)).astype(np.float32))}
with torch.no_grad():
    torch.testing.assert_close(folded(inputs), model(inputs), rtol=0,
                               atol=1e-5)
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
    assert int(lines["MODULES"]) >= 67
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
            # time_kernels and wide_kernels (phase 11a) and nowhere else;
            # the port never calls it.
            for timer in ("time_kernels", "wide_kernels"):
                text, yardstick = _without_function(text, timer)
                assert SDPA in yardstick
        if rel == os.path.join("scripts", "torch_attention_bringup.py"):
            # The bring-up script times the library's call on its math
            # backend beside the kernels past 256 columns (library_math),
            # and its backward beside the backward kernels
            # (library_backward), and nowhere else.
            for timer in ("library_math", "library_backward"):
                text, yardstick = _without_function(text, timer)
                assert SDPA in yardstick
        if rel == os.path.join("mint_tpu_torch", "models", "model_utils.py"):
            # The reference's masked attention helper bears the name; it
            # is the plain formula and calls no library attention.
            text, helper = _without_function(text, SDPA)
            assert "functional" not in helper and "F." not in helper
        assert not stand_ins.search(text), rel


def test_sources_never_name_the_jax_packages_native_library():
    """The port builds and loads its own copy of the C++ loader
    (``mint_tpu_torch/csrc/mint_loader.cc``): no source of the port, nor
    chip_smoke.py, names the JAX package's ``native/`` directory or its
    library."""
    files = _port_sources() + [os.path.join(
        REPO, "mint_tpu_torch", "csrc", "mint_loader.cc")]
    for path in files:
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, REPO)
        assert "native/" not in text, rel
        assert "libmintloader" not in text, rel


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
