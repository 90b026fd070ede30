"""The port's preprocessing, BVH-export and visualize tools against the JAX
package's (CPU).

The preprocessing CLIs compare record for record: the port's in-process
with ``--device=cpu``, the JAX one as a subprocess (its absl flags collide
in-process), both reading one pre-filled audio cache, so the records hold
the same audio features and differ at most in the motion's f32 rotations
(held to 1e-6).  The BVH text is held to the JAX writer's: the header
equal, the motion values within 1e-4 degrees after parsing (f32 rotations
in another order, printed to 5 decimals).  The renderer's joints are held
to the JAX recovery and kinematics within 1e-5 m.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mint_tpu.motion import rotation as jax_rot
from mint_tpu.motion import smpl as jax_smpl
from mint_tpu.tools.bvh_export import BVHWriter as JaxBVHWriter
from mint_tpu_torch.audio import AudioFeatureExtractor
from mint_tpu_torch.data import aist
from mint_tpu_torch.data.example import decode_example
from mint_tpu_torch.data.tfrecord import read_records
from mint_tpu_torch.tools import bvh_export, preprocessing, visualize
from test_torch_audio import _write_track
from test_torch_scores import _anno_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 3
MOTION_TOL = 1e-6
BVH_TOL = 1e-4
JOINT_TOL = 1e-5


def _layout(tmp_path):
    """An AIST++ layout (6 train, 3 testval sequences over mBR0-2) and an
    audio cache pre-filled with seeded [T, 35] features for each track."""
    anno = str(tmp_path / "anno")
    names = _anno_dir(anno)
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(11)
    for name in sorted({aist.audio_name_of(s) for s in names}):
        np.save(cache / f"{name}.npy",
                rng.standard_normal((130, 35)).astype(np.float32))
    return anno, str(cache)


def _flags(anno, cache, out, split):
    return [f"--anno_dir={anno}", f"--audio_dir={anno}",
            f"--audio_cache_dir={cache}", f"--split={split}",
            f"--tfrecord_path={out}/aist_tfrecord", f"--n_shards={N_SHARDS}",
            "--audio_workers=0"]


def _jax_cli(flags):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "mint_tpu.tools.preprocessing", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _shards(out, split):
    """{shard file name: [decoded records in order]}."""
    files = sorted(f for f in os.listdir(out) if f"-{split}-" in f)
    assert len(files) == N_SHARDS
    return {f: [decode_example(r) for r in read_records(os.path.join(out, f))]
            for f in files}


def _assert_records_equal(got, want):
    for key in ("motion_name", "audio_name"):
        assert got[key] == want[key]
    for key in ("motion_sequence_shape", "audio_sequence_shape"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["audio_sequence"],
                                  want["audio_sequence"])
    np.testing.assert_allclose(got["motion_sequence"],
                               want["motion_sequence"], rtol=0,
                               atol=MOTION_TOL)


def test_preprocessing_train_split_equals_jax(tmp_path):
    anno, cache = _layout(tmp_path)
    preprocessing.main(_flags(anno, cache, tmp_path / "port", "train")
                       + ["--device=cpu"])
    _jax_cli(_flags(anno, cache, tmp_path / "jax", "train"))
    got = _shards(tmp_path / "port", "train")
    want = _shards(tmp_path / "jax", "train")
    assert list(got) == list(want)
    assert sum(len(r) for r in got.values()) == 6
    for shard in got:
        assert len(got[shard]) == len(want[shard]), shard
        for g, w in zip(got[shard], want[shard]):
            _assert_records_equal(g, w)
    record = next(r for rs in got.values() for r in rs)
    assert tuple(record["motion_sequence_shape"]) == (100, 219)
    assert tuple(record["audio_sequence_shape"]) == (130, 35)


def test_preprocessing_testval_split_matches_jax(tmp_path):
    """testval adds 10x unpaired records whose music the reference draws
    unseeded (``random.choice``): the counts per shard are equal, and so
    are the paired records, which come first in every shard."""
    anno, cache = _layout(tmp_path)
    preprocessing.main(_flags(anno, cache, tmp_path / "port", "testval")
                       + ["--device=cpu"])
    _jax_cli(_flags(anno, cache, tmp_path / "jax", "testval"))
    got = _shards(tmp_path / "port", "testval")
    want = _shards(tmp_path / "jax", "testval")
    n_seq = len(aist.load_split(anno, "testval"))
    assert sum(len(r) for r in got.values()) == 11 * n_seq
    # The shard of each record, in the order written: RandomState(42).
    rng = np.random.RandomState(42)
    shard_of = [rng.randint(0, N_SHARDS) for _ in range(n_seq)]
    for k, shard in enumerate(got):
        assert len(got[shard]) == len(want[shard]), shard
        paired = shard_of.count(k)
        for g, w in zip(got[shard][:paired], want[shard][:paired]):
            _assert_records_equal(g, w)
            assert g["audio_name"][0].decode() == aist.audio_name_of(
                g["motion_name"][0].decode())


def test_preprocessing_extracts_in_a_spawned_cpu_pool(tmp_path):
    """No cache yet: two spawned workers extract the tracks from the WAVs
    (48 kHz stereo); the cache and the records hold what the in-process
    extractor computes (the workers run one thread each: the sums may go
    in another order, so the continuous columns within 1e-5 of their
    peak)."""
    anno = str(tmp_path / "anno")
    music = tmp_path / "music"
    music.mkdir()
    names = _anno_dir(anno, n_train=2, n_test=0, t=40)
    for i, name in enumerate(sorted({aist.audio_name_of(s)
                                     for s in names})):
        _write_track(str(music / f"{name}.wav"), 90 + 10 * i, 2.0)
    flags = _flags(anno, str(tmp_path / "cache"), tmp_path / "out", "train")
    flags[1] = f"--audio_dir={music}"
    preprocessing.main(flags[:-1] + ["--audio_workers=2", "--device=cpu"])
    cached = sorted(os.listdir(tmp_path / "cache"))
    assert cached == ["mBR0.npy", "mBR1.npy"]
    for name in ("mBR0", "mBR1"):
        got = np.load(tmp_path / "cache" / f"{name}.npy")
        want = AudioFeatureExtractor(
            str(music), device="cpu")(name)
        assert got.shape == want.shape == (121, 35)
        np.testing.assert_allclose(got[:, :21], want[:, :21], rtol=0,
                                   atol=1e-5 * np.abs(want[:, :21]).max())
        np.testing.assert_allclose(got[:, 21:33], want[:, 21:33], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[:, 33:], want[:, 33:])
    records = _shards(tmp_path / "out", "train")
    assert sum(len(r) for r in records.values()) == 2


# -- BVH export --------------------------------------------------------------

def _bvh_pickles(tmp_path):
    rng = np.random.default_rng(12)
    t = 6
    aa = rng.uniform(-0.4, 0.4, (t, 24, 3))
    rot = Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix()
    pickles = {
        "smpl_poses": {"smpl_poses": aa.reshape(t, 72),
                       "smpl_trans": rng.uniform(-1, 1, (t, 3))},
        # Slightly off the rotation group, as a model's output is: the
        # writer projects it (SVD) first.
        "pred_motion": {"pred_motion": (rot + 0.01 * rng.standard_normal(
            rot.shape)).reshape(t, 24, 9),
            "pred_trans": rng.uniform(-1, 1, (t, 3))},
    }
    paths = {}
    for kind, data in pickles.items():
        paths[kind] = str(tmp_path / f"{kind}.pkl")
        with open(paths[kind], "wb") as f:
            pickle.dump(data, f)
    return paths


def _split_bvh(text):
    head, motion = text.split("Frame Time:")
    frame_time, *rows = motion.strip().splitlines()
    values = np.array([[float(v) for v in row.split()] for row in rows])
    return head + "Frame Time:" + frame_time, values


@pytest.mark.parametrize("kind", ["smpl_poses", "pred_motion"])
def test_bvh_writer_matches_jax(tmp_path, kind):
    pkl = _bvh_pickles(tmp_path)[kind]
    bvh_export.main([f"--motion_pkl={pkl}", f"--output={tmp_path}/port.bvh",
                     "--frame_rate=30", "--device=cpu"])
    jax_writer = JaxBVHWriter("smpl", motion_pkl_filename=pkl)
    jax_writer.fill_header(30.0)
    jax_writer.fill_motion()
    jax_writer.write_to_bvh(str(tmp_path / "jax.bvh"))
    got_head, got = _split_bvh((tmp_path / "port.bvh").read_text())
    want_head, want = _split_bvh((tmp_path / "jax.bvh").read_text())
    assert got_head == want_head
    assert got.shape == want.shape == (6, 75)
    np.testing.assert_allclose(got, want, rtol=0, atol=BVH_TOL)


def test_bvh_writer_requires_fill_before_write(tmp_path):
    writer = bvh_export.BVHWriter("smpl", device="cpu")
    with pytest.raises(ValueError):
        writer.write_to_bvh(str(tmp_path / "x.bvh"))
    with pytest.raises(ValueError):
        bvh_export.BVHWriter("smplx", device="cpu")


# -- visualize ---------------------------------------------------------------

def _motion(t=30, seed=3):
    aa = (0.04 * np.random.default_rng(seed).standard_normal(
        (t, 24, 3))).cumsum(0)
    rot = Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(t, 216)
    motion = np.zeros((t, 225), np.float32)
    motion[:, 6:9] = np.linspace(0, 0.5, t)[:, None]
    motion[:, 9:] = rot
    return motion


def test_render_joints_match_jax_and_write_a_gif(tmp_path):
    motion = _motion()
    got = visualize.motion_joints(motion, device="cpu")
    aa, transl = jax_rot.recover_to_axis_angles(motion[None])
    want = np.asarray(jax_smpl.smpl_joints(np.asarray(aa)[0],
                                           np.asarray(transl)[0]))
    assert got.shape == want.shape == (30, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JOINT_TOL)

    gif = str(tmp_path / "out.gif")
    visualize.main([f"--motion_npy={_save(tmp_path, motion)}",
                    f"--output={gif}", "--stride=10", "--device=cpu"])
    assert os.path.getsize(gif) > 1000
    frames = str(tmp_path / "frames")
    visualize.render_motion(motion[None], frames, stride=15, device="cpu")
    assert len(os.listdir(frames)) == 2


def _save(tmp_path, motion):
    path = str(tmp_path / "clip.npy")
    np.save(path, motion)
    return path


# -- the card by default -----------------------------------------------------

def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    """Each entry point defaults to the card and, without one, raises
    before it writes anything; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    anno, cache = _layout(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        preprocessing.main(_flags(anno, cache, tmp_path / "out", "train"))
    assert not (tmp_path / "out").exists()
    pkl = _bvh_pickles(tmp_path)["smpl_poses"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bvh_export.main([f"--motion_pkl={pkl}",
                         f"--output={tmp_path}/x.bvh"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bvh_export.BVHWriter("smpl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        visualize.main([f"--motion_npy={_save(tmp_path, _motion())}",
                        f"--output={tmp_path}/x.gif"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        visualize.motion_joints(_motion())
    assert not (tmp_path / "x.bvh").exists()
    assert not (tmp_path / "x.gif").exists()
