"""The product loop's script ``scripts/torch_e2e_run.py`` on the CPU, and
the last public names of the port (``tools.calculate_scores
.extract_feature``, ``utils.profiling.trace`` / ``annotate``):

- the script's synthetic corpus equals ``scripts/e2e_run.py``'s byte for
  byte (the JAX script loaded with importlib, its ``ROOT`` and ``RNG`` set;
  nothing in it changes);
- the script's kill helper SIGKILLs the train CLI (tiny config, CPU) after
  its first interval checkpoint, a new process resumes the newest whole
  step and ends at the budget, and every step directory is whole; a run
  that ends before the kill fails the stage;
- the train CLI and the evaluate CLI at once (live training with
  continuous eval): every pass restores a step the train run wrote whole,
  the last pass the final step;
- ``extract_feature`` against the JAX function (in a child process: the JAX
  tool module defines absl flags that other JAX tool modules define too)
  in both modes, through the approximate rest-joint model and from
  precomputed joints;
- ``trace`` writes a TensorBoard-readable trace, ``annotate`` names a range.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mint_tpu_torch.config.serialize import pipeline_to_text
from mint_tpu_torch.motion.rotation import aa2rotmat
from mint_tpu_torch.tools import calculate_scores
from mint_tpu_torch.utils import profiling
from test_torch_eval import _eval_corpus
from test_torch_train import (cli_setup, tiny_pipeline_config,  # noqa: F401
                              write_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


e2e = _load_script("torch_e2e_run")


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_corpus_equals_the_jax_scripts_byte_for_byte(tmp_path):
    jax_script = _load_script("e2e_run")
    jax_script.ROOT = str(tmp_path / "jax")
    jax_script.RNG = np.random.default_rng(42)
    jax_script.make_corpus()
    counts = e2e.make_corpus(str(tmp_path / "port"), e2e.FULL)
    assert counts == {"train_seqs": 40, "val_seqs": 8}
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([p for p in got if p.endswith(".wav")]) == 10
    assert len([p for p in got if p.endswith(".pkl")]) == 48
    for path, data in want.items():
        assert got[path] == data, path


def test_e2e_script_starts_only_the_ports_clis():
    assert e2e.cli_command("train", ["--x"])[1:] == [
        "-m", "mint_tpu_torch.tools.train", "--x"]
    with open(os.path.join(REPO, "scripts", "torch_e2e_run.py")) as f:
        source = f.read()
    modules = set(re.findall(r'"(train|evaluate|preprocessing|'
                             r'extract_features|calculate_scores)"', source))
    assert modules == {"train", "evaluate", "preprocessing",
                       "extract_features", "calculate_scores"}
    assert not re.search(r"mint_tpu\.tools", source)


def _train_argv(cfg_path, model_dir, steps, interval):
    return [f"--config_path={cfg_path}", f"--model_dir={model_dir}",
            f"--steps={steps}", f"--checkpoint_interval={interval}",
            "--device=cpu"]


def _whole(model_dir, step):
    """Both files of the step load, and the saved state is that step's."""
    path = os.path.join(model_dir, str(step))
    params = torch.load(os.path.join(path, "params.pt"), weights_only=True)
    rest = torch.load(os.path.join(path, "opt_state.pt"), weights_only=True)
    return bool(params) and rest["step"] == step


def test_kill_and_resume_restore_the_newest_whole_step(cli_setup,
                                                       monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    tmp_path, cfg_path = cli_setup
    model_dir = str(tmp_path / "run")
    argv = _train_argv(cfg_path, model_dir, steps=300, interval=100)
    killed = e2e.run_killed("train", argv, str(tmp_path),
                            str(tmp_path / "killed.log"), model_dir,
                            interval=100, delay_s=0.0, wait_s=120,
                            poll_s=0.02)
    at_kill = killed["checkpoints"]
    # Step 1 and the first interval checkpoint (101), not the budget.
    assert at_kill[:2] == [1, 101] and max(at_kill) < 300, at_kill
    assert killed["first_interval_checkpoint"] == 101
    assert killed["last_logged_step"] >= 101

    resumed = e2e.run_cli("train", argv, str(tmp_path),
                          str(tmp_path / "resumed.log"), timeout=120)
    leg = e2e.train_leg(resumed["text"], resumed["start"])
    assert leg["restored_step"] == max(at_kill)
    assert leg["last_logged_step"] == 300
    assert leg["to_restored_s"] > 0 and leg["steps_per_s"] > 0
    final = e2e.checkpoint_steps(model_dir)
    assert max(final) == 300 and set(at_kill) <= set(final)
    assert all(_whole(model_dir, s) for s in final), final
    # Whatever the kill left half-written is still there (no cleanup), and
    # the resumed run leaves nothing half-written of its own.
    assert e2e.partial_checkpoints(model_dir) == \
        killed["partial_checkpoints"]


def test_a_run_that_ends_before_the_kill_fails_the_stage(cli_setup,
                                                        monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    tmp_path, cfg_path = cli_setup
    model_dir = str(tmp_path / "short")
    # A budget of 20 ends before any checkpoint at step >= 100.
    argv = _train_argv(cfg_path, model_dir, steps=20, interval=100)
    with pytest.raises(e2e.StageFailed, match="before the planned kill"):
        e2e.run_killed("train", argv, str(tmp_path),
                       str(tmp_path / "short.log"), model_dir, interval=100,
                       delay_s=0.0, wait_s=120, poll_s=0.02)
    assert e2e.checkpoint_steps(model_dir) == [1, 20]


def _passes(model_dir):
    """The steps the evaluate CLI has written a pass's summary for."""
    path = os.path.join(model_dir, "valid", "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line)["step"] for line in f
                if line.endswith("\n")]


def test_live_training_with_continuous_eval(tmp_path, monkeypatch):
    """The train CLI and the evaluate CLI at once on the tiny config: each
    evaluate pass restores a step the train run wrote whole (never a
    half-written one), in order, the last of them the final step.  The
    evaluate CLI waits up to a minute for each new step, longer than any
    gap between two saves however loaded the machine; once it has passed
    the final step it is stopped, alive: no pass failed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    data = tmp_path / "data"
    data.mkdir()
    write_corpus(str(data))
    _eval_corpus(str(data), (21, 26))
    pipe = tiny_pipeline_config(str(data / "*_tfrecord-train*"))
    pipe.eval_dataset.input_length_sec = 8
    pipe.eval_dataset.data_files = str(data / "*_tfrecord-testval*")
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(pipe))
    model_dir = str(tmp_path / "run")
    with open(tmp_path / "train.log", "w") as train_log, \
            open(tmp_path / "eval.log", "w") as eval_log:
        train = subprocess.Popen(
            e2e.cli_command("train", _train_argv(cfg_path, model_dir,
                                                 steps=600, interval=150)),
            cwd=tmp_path, env=e2e.cli_env(), stdout=train_log,
            stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 60
            while not e2e.checkpoint_steps(model_dir) \
                    and time.time() < deadline and train.poll() is None:
                time.sleep(0.02)
            evaluate = subprocess.Popen(
                e2e.cli_command("evaluate", [
                    f"--config_path={cfg_path}", f"--model_dir={model_dir}",
                    f"--output_dir={tmp_path / 'outputs'}", "--steps=10",
                    "--timeout=60", "--poll_seconds=0.05", "--device=cpu"]),
                cwd=tmp_path, env=e2e.cli_env(), stdout=eval_log,
                stderr=subprocess.STDOUT)
            try:
                assert train.wait(timeout=120) == 0
                deadline = time.time() + 120
                while 600 not in _passes(model_dir) \
                        and time.time() < deadline and evaluate.poll() is None:
                    time.sleep(0.05)
                assert evaluate.poll() is None  # still watching
            finally:
                evaluate.kill()
                evaluate.wait()
        finally:
            train.kill()
            train.wait()
    saved = e2e.checkpoint_steps(model_dir)
    assert saved == [1, 151, 301, 451, 600]  # none pruned (keep 5)
    passes = _passes(model_dir)
    with open(tmp_path / "eval.log") as f:
        text = f.read()
    assert "Traceback" not in text
    assert len(e2e.eval_pass(text)["passes"]) == len(passes)
    assert passes == sorted(set(passes)) and set(passes) <= set(saved)
    assert passes[-1] == 600
    assert all(_whole(model_dir, s) for s in passes)
    assert sorted(os.listdir(tmp_path / "outputs")) == [
        "gBR_sBM_cAll_d04_mBR0_ch00_mBR0.npy",
        "gBR_sBM_cAll_d04_mBR1_ch01_mBR1.npy"]


def test_log_readers_take_the_clis_lines():
    lines = "\n".join([
        "2026-01-02 03:04:05,100 mint_tpu_torch.train.controller: restored "
        "checkpoint at step 501",
        "2026-01-02 03:04:06,000 mint_tpu_torch.utils.graphs: graph train "
        "captured in 0.250 s, kernel launches a replay {}",
        "2026-01-02 03:04:08,000 mint_tpu_torch.train.controller: step 511: "
        "{'loss': 0.5}",
        "2026-01-02 03:04:18,000 mint_tpu_torch.train.controller: step 611: "
        "{'loss': 0.4}",
        '2026-01-02 03:04:19,000 __main__: kernel launches: {"attention": 3}',
    ])
    start = e2e._stamp("2026-01-02 03:04:00,000")
    leg = e2e.train_leg(lines, start)
    assert leg["restored_step"] == 501
    assert leg["to_restored_s"] == pytest.approx(5.1)
    assert leg["capture_s"] == pytest.approx(0.25)
    assert leg["steps_per_s"] == pytest.approx(10.0)
    assert leg["startup_s"] == pytest.approx(7.0)  # 8 s less 10 steps
    assert leg["kernel_launches"] == {"attention": 3}
    text = ("\nEvaluation: FID_k: 12.5000, FID_g: nan\n\n"
            "Beat Alignment Score: 0.2500 over 4 clips\n")
    got = e2e.scores_of(text)
    assert got["fid_k"] == 12.5 and np.isnan(got["fid_g"])
    assert got["beat_align"] == 0.25 and got["beat_clips"] == 4


def test_clip_motion_reads_a_freeze_and_a_split(tmp_path):
    """A clip that stops moving halfway has half its speed and none late;
    against it, a copy that moves on splits at the frame it stops."""
    rng = np.random.default_rng(3)
    walk = (0.01 * rng.standard_normal((e2e.SEED_FRAMES + 400, 225))
            ).cumsum(0).astype(np.float32)
    frozen = walk.copy()
    frozen[e2e.SEED_FRAMES + 200:] = frozen[e2e.SEED_FRAMES + 199]
    for name, clip in (("moving", walk), ("frozen", frozen)):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "clip.npy", clip)
    moving = e2e.clip_motion(str(tmp_path / "moving"))
    got = e2e.clip_motion(str(tmp_path / "frozen"), str(tmp_path / "moving"))
    assert got["late_speed"] == 0.0 < moving["late_speed"]
    assert got["speed"] == pytest.approx(moving["speed"] / 2, rel=0.1)
    assert 200 <= got["median_split_frame"] < 400
    assert got["mean_abs_diff"] > 0


# -- extract_feature ------------------------------------------------------------

_JAX_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from mint_tpu.motion.smpl import SMPL_PARENTS, SMPLModel, default_rest_joints
from mint_tpu.tools.calculate_scores import extract_feature
motion, joints = np.load(sys.argv[1]), np.load(sys.argv[2])
mode = sys.argv[3]
model = SMPLModel(j_rest=default_rest_joints(), parents=SMPL_PARENTS)
np.savez(sys.argv[4], model=extract_feature(motion, model, mode),
         joints=extract_feature(motion, model, mode, joints=joints))
"""


@pytest.mark.parametrize("mode", ["kinetic", "manual"])
def test_extract_feature_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(12)
    t = 90
    # A [1, T, 225] clip: the root's travel at 6:9, then 24 rotation
    # matrices a frame.
    aa = (0.08 * rng.standard_normal((t, 24, 3))).cumsum(0)
    motion = np.zeros((1, t, 225), np.float32)
    motion[0, :, 6:9] = (0.02 * rng.standard_normal((t, 3))).cumsum(0)
    motion[0, :, 9:] = aa2rotmat(torch.from_numpy(aa).float()).reshape(
        t, 216).numpy()
    joints = (0.1 * rng.standard_normal((t, 24, 3))).cumsum(0).astype(
        np.float32)
    np.save(tmp_path / "motion.npy", motion)
    np.save(tmp_path / "joints.npy", joints)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, str(tmp_path / "motion.npy"),
         str(tmp_path / "joints.npy"), mode, str(tmp_path / "jax.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")
    got_model = calculate_scores.extract_feature(motion, None, mode,
                                                 device="cpu")
    got_joints = calculate_scores.extract_feature(motion, None, mode,
                                                  joints=joints)
    assert got_model.shape == want["model"].shape == (
        72 if mode == "kinetic" else 32,)
    np.testing.assert_allclose(got_joints, want["joints"], rtol=1e-6)
    np.testing.assert_allclose(got_model, want["model"], rtol=1e-6)
    # scores() takes its features from extract_feature on one FK run.
    fk = calculate_scores.joints_of(motion, None, "cpu")
    np.testing.assert_array_equal(
        calculate_scores.extract_feature(motion, None, mode, joints=fk),
        got_model)


# -- trace and annotate -----------------------------------------------------------

def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("e2e_phase"):
            torch.ones(64).mul(2).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name") == "e2e_phase" for ev in events)


def test_annotate_names_a_profiler_event():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("scoring_pass"):
            torch.ones(64).mul(2).sum()
    assert "scoring_pass" in {e.key for e in prof.key_averages()}
