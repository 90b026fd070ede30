"""The product loop end to end on one CUDA card, through the port's CLIs.

Drives ``python -m mint_tpu_torch.tools.<name>`` as subprocesses, as a user
chains them, stage for stage as ``scripts/e2e_run.py`` drives the JAX
package's:

  1. synthesise an AIST++-shaped corpus (10 musics x 25 s click tracks at
     the BPM their names imply, 40 train / 8 val sequences of 1500-frame
     SMPL motion, all from ``np.random.default_rng(42)``)
  2. preprocess both splits (audio features + 20-shard tfrecords)
  3. train the flagship fact_v5_deeper_t10_cm12 config in bf16, SIGKILLed
     20 s after its first interval checkpoint (step >= 500), then resumed in
     a new process to the absolute 5000-step budget
  4. continuous eval of the final checkpoint: 1200-frame dances for every
     val clip, in f32; then once more in bf16 (``--use_bfloat16``) into
     ``outputs_bf16/``, a measurement of bf16 decode at the metric level
  5. ground-truth kinetic/manual features of the corpus
  6. FID_k / FID_g + Beat Alignment of both sets of clips

Writes ``<root>/e2e_summary.json`` (after every stage): each stage's wall
seconds, the checkpoints at the kill and at the end, any ``<step>.tmp-<pid>``
directory the kill left, the step the resumed run restored, each training
leg's start-up apart from its steps, the loss curve, the clip counts, the
score lines and the bf16-against-f32 relative deltas of the three scores,
how much each set of clips moves and how far bf16's strays from f32's
(``clip_motion``), and the card's ``nvidia-smi`` name and power limit.  Each CLI's output goes
to ``<root>/logs/<stage>.log``.  A rerun skips the stages that finished, so
a run cut off part way finishes in a second invocation.

The CLIs run on the card (their default): run it on a machine with one.

    python scripts/torch_e2e_run.py [--smoke] [root_dir] [extra_train_args]

The evaluate stages look for a newer checkpoint once a second
(``--poll_seconds=1``, a flag of the port's CLI) rather than sleeping the
default 10 s after their pass.

``extra_train_args`` is one string of train-CLI flags, e.g.
``"--input_backend=device"``.  ``--smoke`` only shrinks the sizes (the
``SMOKE`` dict below): 2 musics, 4 + 2 sequences, 100 steps with a
checkpoint every 50, the kill 1 s after the first interval checkpoint, and
120-frame clips.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import time
import wave
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")

#: The two sizes of a run; nothing else differs between them.
FULL = {"musics": 10, "train_seqs": 40, "val_seqs": 8, "train_steps": 5000,
        "checkpoint_interval": 500, "kill_delay_s": 20.0,
        "eval_steps": 1200}
SMOKE = {"musics": 2, "train_seqs": 4, "val_seqs": 2, "train_steps": 100,
         "checkpoint_interval": 50, "kill_delay_s": 1.0, "eval_steps": 120}

MUSICS = {  # name -> BPM by the AIST++ naming rule
    "mBR0": 80, "mBR3": 110, "mPO1": 90, "mLO2": 100, "mMH4": 120,
    "mLH5": 130, "mWA2": 100, "mKR1": 90, "mJS3": 110, "mJB4": 120,
}
GENRE = {"mBR": "gBR", "mPO": "gPO", "mLO": "gLO", "mMH": "gMH",
         "mLH": "gLH", "mWA": "gWA", "mKR": "gKR", "mJS": "gJS",
         "mJB": "gJB"}
SEED = 42
SAMPLE_RATE = 30720
DUR_S = 25.0
MOTION_FRAMES = 1500    # 25 s at 60 fps
N_SHARDS = 20
FEATURE_WORKERS = 8
KILL_WAIT_S = 1500.0    # hard cap on waiting for the first interval ckpt
POLL_S = 0.5            # how often the kill looks for that checkpoint
SEED_FRAMES = 120       # the flagship's motion window: each clip's seed

# The CLIs' log lines (format "%(asctime)s %(name)s: %(message)s").
_STAMP = r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) \S+: "
STEP_LINE = re.compile(r"^" + _STAMP + r"step (\d+): ", re.M)
RESTORED_LINE = re.compile(r"^" + _STAMP + r"restored checkpoint at step "
                           r"(\d+)", re.M)
CAPTURE_LINE = re.compile(r"graph .* captured in ([\d.]+) s")
LAUNCH_LINE = re.compile(r"kernel launches: (\{.*\})")
EVAL_PASS_LINE = re.compile(
    r"eval pass done: (\d+) clip\(s\), (\d+) bucket\(s\), (\d+) frames "
    r"generated in ([\d.]+) s wall")
DISPATCH_LINE = re.compile(r"decode batch=(\d+)\(\+(\d+) pad\) steps=(\d+)")
FID_LINE = re.compile(r"FID_k: (\S+), FID_g: (\S+)")
BEAT_LINE = re.compile(r"Beat Alignment Score: (\S+) over (\d+) clips")


class StageFailed(RuntimeError):
    """A CLI failed, or the train CLI exited before its planned kill."""


# -- the corpus -----------------------------------------------------------

def _write_wav(path: str, y: np.ndarray) -> None:
    pcm = (np.clip(y, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def make_corpus(root: str, size: Dict) -> Dict[str, int]:
    """The AIST++ layout under `root`: ``audio/<music>.wav`` (a click track
    at the music's BPM over noise), ``anno/motions/<seq>.pkl`` (smooth
    random SMPL motion: drifting axis-angles, travelling root) and the
    split files; the draws in the order the JAX package's script makes
    them, so the full size's bytes equal its corpus."""
    rng = np.random.default_rng(SEED)
    musics = list(MUSICS)[:size["musics"]]
    for sub in ("audio", "anno/splits", "anno/motions", "data"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for music in musics:
        y = np.zeros(int(SAMPLE_RATE * DUR_S), np.float32)
        period = int(round(60.0 * SAMPLE_RATE / MUSICS[music]))
        for s in range(0, len(y) - 256, period):
            y[s:s + 128] += 0.7 * rng.standard_normal(128).astype(np.float32)
        y += 0.05 * rng.standard_normal(len(y)).astype(np.float32)
        _write_wav(os.path.join(root, "audio", f"{music}.wav"), y)
    splits = {"train": [], "val": [], "test": []}
    for i in range(size["train_seqs"] + size["val_seqs"]):
        music = musics[i % len(musics)]
        seq = f"{GENRE[music[:3]]}_sBM_c01_d{i:02d}_{music}_ch{i % 6:02d}"
        splits["train" if i < size["train_seqs"] else "val"].append(seq)
        poses = (0.03 * rng.standard_normal((MOTION_FRAMES, 72))).cumsum(0)
        trans = 90.0 * (0.02 * rng.standard_normal(
            (MOTION_FRAMES, 3))).cumsum(0)
        with open(os.path.join(root, "anno", "motions", f"{seq}.pkl"),
                  "wb") as f:
            pickle.dump({"smpl_poses": poses,
                         "smpl_scaling": np.array([90.0]),
                         "smpl_trans": trans}, f)
    for part, seqs in splits.items():
        with open(os.path.join(root, "anno", "splits",
                               f"crossmodal_{part}.txt"), "w") as f:
            f.write("\n".join(seqs))
    with open(os.path.join(root, "anno", "ignore_list.txt"), "w") as f:
        f.write("")
    return {"train_seqs": len(splits["train"]),
            "val_seqs": len(splits["val"])}


# -- running the CLIs -----------------------------------------------------

def cli_command(module: str, argv: Sequence[str]) -> List[str]:
    return [sys.executable, "-m", f"mint_tpu_torch.tools.{module}", *argv]


def cli_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_cli(module: str, argv: Sequence[str], cwd: str, log_path: str,
            timeout: float = 3600) -> Dict:
    """Run the CLI to its end, its output into `log_path`; raise
    StageFailed unless it exits 0.  Returns its start time (epoch
    seconds), wall seconds and output."""
    t0 = time.time()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cli_command(module, argv), cwd=cwd,
                                env=cli_env(), stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = f"killed after its {timeout} s timeout"
    seconds = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise StageFailed(f"{module} exited {rc}:\n{text[-3000:]}")
    return {"start": t0, "wall_s": seconds, "text": text}


def checkpoint_steps(model_dir: str) -> List[int]:
    """The steps with a checkpoint directory, ascending (a step is renamed
    into place whole)."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())


def partial_checkpoints(model_dir: str) -> List[str]:
    """The ``<step>.tmp-<pid>`` directories of writes that never ended."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(d for d in os.listdir(model_dir) if ".tmp-" in d)


def run_killed(module: str, argv: Sequence[str], cwd: str, log_path: str,
               model_dir: str, interval: int, delay_s: float,
               wait_s: float = KILL_WAIT_S, poll_s: float = POLL_S) -> Dict:
    """Start the train CLI, wait for its first interval checkpoint (a step
    >= `interval`: the controller also saves step 1, too early to be a
    preemption point), let it train `delay_s` past it, then SIGKILL it.
    After `wait_s` with no such checkpoint it is killed all the same.

    A process that exits on its own before the kill (a crash, or a budget
    that ends training early) fails the stage: the resume leg would be a
    no-op.  Returns what the kill left: the checkpoints, the partial
    writes, the last step the run logged and its output."""
    t0 = time.time()
    first = None
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cli_command(module, argv), cwd=cwd,
                                env=cli_env(), stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = t0 + wait_s
            while time.time() < deadline and proc.poll() is None:
                due = [s for s in checkpoint_steps(model_dir)
                       if s >= interval]
                if due:
                    first = due[0]
                    time.sleep(delay_s)  # keep training past the checkpoint
                    break
                time.sleep(poll_s)
            exited_itself = proc.poll() is not None
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        except BaseException:
            proc.kill()
            proc.wait()
            raise
    seconds = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    if exited_itself:
        raise StageFailed(f"{module} exited by itself (rc "
                          f"{proc.returncode}) before the planned kill:\n"
                          f"{text[-3000:]}")
    steps = [int(m.group(2)) for m in STEP_LINE.finditer(text)]
    return {"start": t0, "wall_s": seconds, "text": text,
            "first_interval_checkpoint": first,
            "checkpoints": checkpoint_steps(model_dir),
            "partial_checkpoints": partial_checkpoints(model_dir),
            "last_logged_step": steps[-1] if steps else None}


def _stamp(text: str) -> float:
    return datetime.datetime.strptime(
        text, "%Y-%m-%d %H:%M:%S,%f").timestamp()


def train_leg(text: str, start: float) -> Dict:
    """One train CLI run's start-up apart from its steps, from its log:
    seconds from the process's start to its restore and to its first
    logged step, the graph captures' seconds, the steady rate between the
    first and last logged steps (with input and checkpoint saves), and the
    start-up left once the first logged loop's steps are taken out at that
    rate.  ``restored_step`` is None in a fresh run."""
    m = RESTORED_LINE.search(text)
    out = {"restored_step": int(m.group(2)) if m else None,
           "capture_s": sum(float(s) for s in CAPTURE_LINE.findall(text))}
    if m:
        out["to_restored_s"] = _stamp(m.group(1)) - start
    steps = [(_stamp(m.group(1)), int(m.group(2)))
             for m in STEP_LINE.finditer(text)]
    if steps:
        out["first_logged_step"], out["last_logged_step"] = \
            steps[0][1], steps[-1][1]
        out["to_first_step_s"] = steps[0][0] - start
    if len(steps) > 1 and steps[-1][0] > steps[0][0]:
        rate = (steps[-1][1] - steps[0][1]) / (steps[-1][0] - steps[0][0])
        covered = steps[0][1] - (out["restored_step"] or 0)
        out["steps_per_s"] = rate
        out["startup_s"] = out["to_first_step_s"] - covered / rate
    launches = LAUNCH_LINE.findall(text)
    if launches:
        out["kernel_launches"] = json.loads(launches[-1])
    return out


def eval_pass(text: str) -> Dict:
    """The evaluate CLI's passes, dispatches and launches, from its log."""
    passes = [{"clips": int(c), "buckets": int(b), "frames": int(f),
               "wall_s": float(w)}
              for c, b, f, w in EVAL_PASS_LINE.findall(text)]
    dispatches = [{"batch": int(b), "pad": int(p), "steps": int(s)}
                  for b, p, s in DISPATCH_LINE.findall(text)]
    launches = LAUNCH_LINE.findall(text)
    return {"passes": passes, "dispatches": dispatches,
            "kernel_launches": json.loads(launches[-1]) if launches
            else None}


def scores_of(text: str) -> Dict:
    """FID_k, FID_g and the Beat Alignment Score the scores CLI printed."""
    fid = FID_LINE.search(text)
    if fid is None:
        raise StageFailed(f"calculate_scores printed no FID:\n{text[-3000:]}")
    out = {"fid_k": float(fid.group(1)), "fid_g": float(fid.group(2))}
    beat = BEAT_LINE.search(text)
    if beat:
        out["beat_align"] = float(beat.group(1))
        out["beat_clips"] = int(beat.group(2))
    return out


def clip_motion(out_dir: str, ref_dir: Optional[str] = None) -> Dict:
    """How the generated frames of the clips in `out_dir` move, over their
    216 rotation-matrix entries: the mean |x[t+1] - x[t]| over every
    generated frame (``speed``) and over the last quarter (``late_speed``:
    a rollout that freezes has little there).  Against `ref_dir`'s clip of
    the same name: the mean |difference| and the median over clips of the
    first generated frame at which an entry differs by more than 0.1 (the
    clip's length where none does)."""
    speed, late, gaps, splits = [], [], [], []
    for name in sorted(f for f in os.listdir(out_dir) if f.endswith(".npy")):
        gen = np.load(os.path.join(out_dir, name))[SEED_FRAMES:, 9:]
        step = np.abs(np.diff(gen, axis=0)).mean(axis=1)
        speed.append(step.mean())
        late.append(step[-(len(step) // 4):].mean())
        if ref_dir is not None:
            ref = np.load(os.path.join(ref_dir, name))[SEED_FRAMES:, 9:]
            gap = np.abs(gen - ref)
            gaps.append(gap.mean())
            over = np.flatnonzero(gap.max(axis=1) > 0.1)
            splits.append(int(over[0]) if len(over) else len(gap))
    out = {"speed": float(np.mean(speed)),
           "late_speed": float(np.mean(late))}
    if ref_dir is not None:
        out["mean_abs_diff"] = float(np.mean(gaps))
        out["median_split_frame"] = float(np.median(splits))
    return out


def card() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        raise SystemExit(f"torch_e2e_run.py runs the CLIs on a CUDA card; "
                         f"nvidia-smi failed: {exc}")
    return proc.stdout.strip().splitlines()[0]


# -- the run ----------------------------------------------------------------

class E2E:
    """One run under `root` at `size` (FULL or SMOKE)."""

    def __init__(self, root: str, size: Dict,
                 extra_train_args: Sequence[str] = ()):
        self.root = os.path.abspath(root)
        self.size = size
        self.extra_train_args = list(extra_train_args)
        self.t0 = time.time()
        os.makedirs(os.path.join(self.root, "logs"), exist_ok=True)
        self.summary_path = os.path.join(self.root, "e2e_summary.json")
        self.summary = {"stages": {}}
        if os.path.exists(self.summary_path):  # a rerun keeps what it had
            with open(self.summary_path) as f:
                self.summary = json.load(f)
        self.summary.update(size=size, complete=False)

    def log(self, msg: str) -> None:
        print(f"[e2e +{time.time() - self.t0:7.1f}s] {msg}", flush=True)

    def save(self) -> None:
        with open(self.summary_path, "w") as f:
            json.dump(self.summary, f, indent=1)

    def _marker(self, stage: str) -> str:
        if stage.startswith("preprocess-"):  # one a split, beside its data
            return os.path.join(self.root, "data",
                                f".{stage.split('-', 1)[1]}_done")
        return os.path.join(self.root, f".{stage}_done")

    def done(self, stage: str) -> bool:
        if os.path.exists(self._marker(stage)):
            self.log(f"{stage}: done-marker exists; skipping")
            return True
        return False

    def finish(self, stage: str, argv: Sequence[str], result: Dict,
               ok="ok", **extra) -> None:
        """Record the stage, write the summary, then its done-marker."""
        self.summary["stages"].setdefault(stage, []).append(
            {"cmd": " ".join(argv[:4]), "wall_s": round(result["wall_s"], 1),
             "ok": ok, **extra})
        self.save()
        with open(self._marker(stage), "w") as f:
            f.write("ok\n")
        self.log(f"stage {stage}: {result['wall_s']:.1f} s")

    def cli(self, stage: str, module: str, argv: Sequence[str],
            timeout: float = 3600) -> Dict:
        return run_cli(module, argv, self.root,
                       os.path.join(self.root, "logs", f"{stage}.log"),
                       timeout)

    def run(self) -> Dict:
        root, size, s = self.root, self.size, self.summary
        s["card"] = card()
        n_seqs = size["train_seqs"] + size["val_seqs"]
        motions = os.path.join(root, "anno", "motions")
        if os.path.isdir(motions) and len(os.listdir(motions)) == n_seqs:
            self.log("corpus exists; skipping synthesis")
        else:
            t = time.time()
            counts = make_corpus(root, size)
            s["stages"]["corpus"] = [{"wall_s": round(time.time() - t, 1),
                                      **counts}]
            self.save()
            self.log(f"corpus: {size['musics']} musics, "
                     f"{counts['train_seqs']}+{counts['val_seqs']} seqs")

        # 1. Preprocess.  Every shard file exists from the start, so a
        # per-split marker written after the CLI succeeds is the resume
        # check, not the shard count.
        for split in ("train", "testval"):
            stage = f"preprocess-{split}"
            if self.done(stage):
                continue
            argv = [f"--anno_dir={root}/anno", f"--audio_dir={root}/audio",
                    f"--audio_cache_dir={root}/cache", f"--split={split}",
                    f"--tfrecord_path={root}/data/aist_tfrecord",
                    f"--n_shards={N_SHARDS}"]
            self.finish(stage, argv, self.cli(stage, "preprocessing", argv))

        # 2. Train the flagship in bf16: SIGKILLed after its first interval
        # checkpoint, then resumed in a new process to the absolute budget.
        model_dir = os.path.join(root, "model")
        train_args = [
            f"--config_path={CONFIG}", f"--model_dir={model_dir}",
            f"--steps={size['train_steps']}",
            f"--checkpoint_interval={size['checkpoint_interval']}",
            "--use_bfloat16", "--grad_clip_norm=1.0",
        ] + self.extra_train_args
        if not self.done("train-killed"):
            result = run_killed(
                "train", train_args, root,
                os.path.join(root, "logs", "train-killed.log"), model_dir,
                size["checkpoint_interval"], size["kill_delay_s"])
            leg = train_leg(result["text"], result["start"])
            s["ckpts_at_kill"] = result["checkpoints"]
            s["partial_checkpoints_at_kill"] = result["partial_checkpoints"]
            s["step_at_kill"] = result["last_logged_step"]
            self.log(f"checkpoints at kill: {result['checkpoints']}, partial "
                     f"writes {result['partial_checkpoints']}, last logged "
                     f"step {result['last_logged_step']}")
            if not result["checkpoints"]:
                raise StageFailed("no checkpoint survived the kill")
            self.finish("train-killed", train_args, result, ok="killed",
                        first_interval_checkpoint=result[
                            "first_interval_checkpoint"], **leg)
        if not self.done("train-resume"):
            result = self.cli("train-resume", "train", train_args,
                              timeout=5400)
            leg = train_leg(result["text"], result["start"])
            s.setdefault("restored_step", leg["restored_step"])
            s["ckpts_final"] = checkpoint_steps(model_dir)
            s["partial_checkpoints_final"] = partial_checkpoints(model_dir)
            if max(s["ckpts_final"]) != size["train_steps"]:
                raise StageFailed(f"the resumed run ended at "
                                  f"{s['ckpts_final']}, not at "
                                  f"{size['train_steps']}")
            self.log(f"resumed at step {leg['restored_step']}; checkpoints "
                     f"{s['ckpts_final']}")
            self.finish("train-resume", train_args, result, **leg)

        # The loss curve from the JSONL metrics stream (model/train).
        losses = []
        metrics_file = os.path.join(model_dir, "train", "metrics.jsonl")
        if os.path.exists(metrics_file):
            with open(metrics_file) as f:
                for line in f:
                    rec = json.loads(line)
                    if "loss" in rec:
                        losses.append((rec.get("step"), rec["loss"]))
        s["loss_curve"] = losses[::max(1, len(losses) // 25)]
        s["loss_first"] = losses[0] if losses else None
        s["loss_last"] = losses[-1] if losses else None
        self.log(f"loss: first={s['loss_first']} last={s['loss_last']}")

        # 3. Continuous eval of the final checkpoint, f32 (the reference's
        # scoring semantics) and then bf16, each set of clips scored.
        for dtype, out_dir, flags in (("f32", "outputs", []),
                                      ("bf16", "outputs_bf16",
                                       ["--use_bfloat16"])):
            stage = "evaluate" if dtype == "f32" else "evaluate-bf16"
            if self.done(stage):
                continue
            argv = [f"--config_path={CONFIG}", f"--model_dir={model_dir}",
                    f"--output_dir={root}/{out_dir}",
                    f"--steps={size['eval_steps']}", "--timeout=1",
                    "--poll_seconds=1", *flags]
            result = self.cli(stage, "evaluate", argv, timeout=5400)
            clips = [f for f in os.listdir(os.path.join(root, out_dir))
                     if f.endswith(".npy")]
            s["generated_clips" if dtype == "f32"
              else "generated_clips_bf16"] = len(clips)
            if not clips:
                raise StageFailed(f"{stage}: no clips generated")
            s.setdefault("clip_motion", {})[dtype] = clip_motion(
                os.path.join(root, out_dir),
                os.path.join(root, "outputs") if dtype == "bf16" else None)
            self.log(f"{stage}: {len(clips)} clips, motion "
                     f"{s['clip_motion'][dtype]}")
            self.finish(stage, argv, result, clip_files=len(clips),
                        **eval_pass(result["text"]))

        # 4. Ground-truth features for FID.
        if not self.done("features"):
            argv = [f"--anno_dir={root}/anno", f"--save_dir={root}/features",
                    f"--workers={FEATURE_WORKERS}"]
            self.finish("features", argv,
                        self.cli("features", "extract_features", argv))

        # 5. FID + Beat Alignment of each set of clips.
        for dtype, out_dir in (("f32", "outputs"), ("bf16", "outputs_bf16")):
            stage = "score" if dtype == "f32" else "score-bf16"
            if self.done(stage):
                continue
            argv = [f"--result_files={root}/{out_dir}/*.npy",
                    f"--feature_dir={root}/features",
                    f"--audio_cache_dir={root}/cache"]
            result = self.cli(stage, "calculate_scores", argv)
            lines = [ln for ln in result["text"].splitlines()
                     if FID_LINE.search(ln) or BEAT_LINE.search(ln)]
            s.setdefault("score_output", {})[dtype] = lines
            s.setdefault("scores", {})[dtype] = scores_of(result["text"])
            self.log(f"{stage}: {s['scores'][dtype]}")
            self.finish(stage, argv, result)
        f32, bf16 = s["scores"]["f32"], s["scores"]["bf16"]
        s["bf16_vs_f32_rel"] = {
            k: (bf16[k] - f32[k]) / abs(f32[k]) if f32[k] else None
            for k in ("fid_k", "fid_g", "beat_align")
            if k in f32 and k in bf16}
        s["complete"] = True
        self.save()
        self.log("E2E COMPLETE")
        return s


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = list(sys.argv[1:] if argv is None else argv)
    size = FULL
    if "--smoke" in args:
        args.remove("--smoke")
        size = SMOKE
    root = (args[0] if args
            else os.path.join(tempfile.gettempdir(), "mint_torch_e2e"))
    extra = args[1].split() if len(args) > 1 else []
    summary = E2E(root, size, extra).run()
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "loss_curve"}, indent=1))
    return summary


if __name__ == "__main__":
    main()
