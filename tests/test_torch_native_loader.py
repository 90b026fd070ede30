"""The port's C++ train loader (``mint_tpu_torch/data/native_loader.py`` and
``mint_tpu_torch/csrc/mint_loader.cc``) on the CPU: the sixteen cases of
``tests/test_native_loader.py`` against the port's loader, its batches
bit for bit against ``mint_tpu.data.native_loader``'s from the same
shards, seed and cache budget, its build raced from two processes, and
the train CLI's ``--input_backend`` choices."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mint_tpu.data import native_loader as jax_native_loader
from mint_tpu_torch.data import native_loader, tfrecord
from mint_tpu_torch.data.example import encode_example
from mint_tpu_torch.data.tfrecord import TFRecordWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True)
def _built():
    """Every case needs the library: a failed build fails each case with
    g++'s message (decided here, at run time, not at import)."""
    assert native_loader.available(), native_loader.build_error()


def _example(motion, audio, motion_shape=None, names=None):
    features = {
        "motion_sequence": motion.ravel(),
        "motion_sequence_shape": np.asarray(
            motion.shape if motion_shape is None else motion_shape,
            np.int64),
        "audio_sequence": audio.ravel(),
        "audio_sequence_shape": np.asarray(audio.shape, np.int64),
    }
    if names is not None:
        features["motion_name"], features["audio_name"] = names
    return encode_example(features)


def _write_shards(tmp_path, n_shards=2, per_shard=5, t_motion=40,
                  t_audio=60):
    files = []
    os.makedirs(tmp_path, exist_ok=True)
    for shard in range(n_shards):
        path = str(tmp_path / f"shard-{shard}")
        files.append(path)
        with TFRecordWriter(path) as w:
            for i in range(per_shard):
                motion = RNG.standard_normal(
                    (t_motion, 219)).astype(np.float32)
                audio = RNG.standard_normal((t_audio, 35)).astype(np.float32)
                w.write(_example(motion, audio, names=(
                    [f"m{shard}_{i}".encode()], [f"a{shard}_{i}".encode()])))
    return files


def _loader(files, **kw):
    args = dict(batch_size=2, motion_input_len=10, target_len=3,
                target_shift=10, audio_input_len=20)
    args.update(kw)
    return native_loader.NativeTrainLoader(files, **args)


def _ramp(tmp_path, t_motion=30, t_audio=40):
    """One example whose frame t holds t in every column."""
    motion = np.arange(t_motion, dtype=np.float32)[:, None].repeat(219, 1)
    audio = np.arange(t_audio, dtype=np.float32)[:, None].repeat(35, 1)
    path = str(tmp_path / "one")
    with TFRecordWriter(path) as w:
        w.write(_example(motion, audio))
    return path


def _check_window(b, row, start_max=18):
    start = int(b["motion_input"][row, 0, 6])
    np.testing.assert_array_equal(
        b["motion_input"][row, :, 6],
        np.arange(start, start + 8, dtype=np.float32))
    np.testing.assert_array_equal(
        b["target"][row, :, 6],
        np.arange(start + 8, start + 12, dtype=np.float32))
    assert 0 <= start <= start_max
    return start


# -- the sixteen cases of tests/test_native_loader.py -------------------------

def test_crc_parity_with_python():
    for size in (0, 1, 7, 64, 1000):
        data = bytes(RNG.integers(0, 256, size, dtype=np.uint8))
        want = tfrecord.crc32c(data)
        want = (((want >> 15) | (want << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        assert native_loader.masked_crc32c(data) == want
        assert tfrecord.masked_crc32c(data) == want


def test_batch_shapes_and_padding(tmp_path):
    ld = _loader(_write_shards(tmp_path), batch_size=4, seed=7)
    batch = next(ld)
    assert batch["motion_input"].shape == (4, 10, 225)
    assert batch["target"].shape == (4, 3, 225)
    assert batch["audio_input"].shape == (4, 20, 35)
    assert all(v.dtype == np.float32 for v in batch.values())
    # 6 leading zero-pad dims (inputs_util.py:70-73).
    assert (batch["motion_input"][..., :6] == 0).all()
    assert (batch["target"][..., :6] == 0).all()
    assert np.abs(batch["motion_input"][..., 6:]).max() > 0
    ld.close()


def test_endless_and_randomized(tmp_path):
    ld = _loader(_write_shards(tmp_path, per_shard=3), seed=1)
    batches = [next(ld) for _ in range(20)]  # more than the 6 examples
    ld.close()
    assert any(not np.array_equal(batches[0]["motion_input"],
                                  b["motion_input"]) for b in batches[1:])


def test_window_values_come_from_source(tmp_path):
    ld = _loader([_ramp(tmp_path)], batch_size=1, motion_input_len=8,
                 target_len=4, target_shift=8, audio_input_len=12, seed=3)
    for _ in range(5):
        b = next(ld)
        start = _check_window(b, 0)
        np.testing.assert_array_equal(
            b["audio_input"][0, :, 0],
            np.arange(start, start + 12, dtype=np.float32))
    ld.close()


def test_skips_corrupt_records(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=4)
    with open(files[0], "ab") as f:
        f.write(b"\x10\x00\x00\x00\x00\x00\x00\x00XXXXgarbagegarbage??")
    ld = _loader(files, seed=5)
    batch = next(ld)
    assert batch["motion_input"].shape == (2, 10, 225)
    assert np.isfinite(batch["motion_input"]).all()
    ld.close()


def test_missing_shard_skipped(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=4)
    ld = _loader(files + [str(tmp_path / "does-not-exist")], seed=5)
    assert next(ld)["motion_input"].shape == (2, 10, 225)
    ld.close()


def test_examples_too_short_for_window_are_dropped(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=3, t_motion=8,
                          t_audio=8)  # window 20 > 8: all dropped
    ok_files = _write_shards(tmp_path / "ok", n_shards=1, per_shard=3)
    ld = _loader(files + ok_files, seed=5)
    assert next(ld)["motion_input"].shape == (2, 10, 225)
    ld.close()


def test_all_unusable_shards_stop_instead_of_hanging(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=2, t_motion=5,
                          t_audio=5)
    ld = _loader(files, seed=9)
    with pytest.raises(StopIteration):
        next(ld)
    ld.close()  # must not deadlock
    with pytest.raises(StopIteration):  # and stays stopped once closed
        next(ld)


def test_shape_metadata_mismatch_rejected(tmp_path):
    path = str(tmp_path / "bad")
    motion = RNG.standard_normal((40, 219)).astype(np.float32)
    audio = RNG.standard_normal((60, 35)).astype(np.float32)
    with TFRecordWriter(path) as w:  # declared 400 frames, 40 written
        w.write(_example(motion, audio, motion_shape=[400, 219]))
    ld = _loader([path], batch_size=1, seed=9)
    with pytest.raises(StopIteration):
        next(ld)
    ld.close()


def test_audio_shorter_than_motion_no_crash(tmp_path):
    path = str(tmp_path / "short_audio")
    with TFRecordWriter(path) as w:
        w.write(_example(RNG.standard_normal((1000, 219)).astype(np.float32),
                         RNG.standard_normal((60, 35)).astype(np.float32)))
    ld = _loader([path], batch_size=1, seed=11)
    try:  # starts past the 60-frame audio are skipped; no crash
        assert next(ld)["motion_input"].shape == (1, 10, 225)
    except StopIteration:
        pass
    ld.close()


def test_corrupt_payload_data_crc_rejected(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=1)
    with open(files[0], "r+b") as f:
        f.seek(40)  # inside the payload, framing intact
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    ld = _loader(files, batch_size=1, seed=9)
    with pytest.raises(StopIteration):
        next(ld)
    ld.close()


def test_shard_truncated_mid_record_other_shards_serve(tmp_path):
    files = _write_shards(tmp_path, n_shards=2, per_shard=4)
    size = os.path.getsize(files[0])
    with open(files[0], "r+b") as f:
        f.truncate(size - 100)
    ld = _loader(files, batch_size=4, seed=7)
    for _ in range(5):
        batch = next(ld)
        assert batch["motion_input"].shape == (4, 10, 225)
        assert np.isfinite(batch["motion_input"]).all()
    ld.close()


def test_corrupt_length_field_stops_file(tmp_path):
    files = _write_shards(tmp_path, n_shards=1, per_shard=3)
    with open(files[0], "r+b") as f:
        f.write(b"\xff\xff\xff\xff\xff\xff\xff\x7f")  # absurd length
    ld = _loader(files, batch_size=1, seed=9)
    with pytest.raises(StopIteration):
        next(ld)
    ld.close()


def test_cached_epochs_serve_correct_windows(tmp_path):
    ld = _loader([_ramp(tmp_path)], batch_size=4, motion_input_len=8,
                 target_len=4, target_shift=8, audio_input_len=12, seed=3,
                 cache_bytes=64 << 20)
    starts = set()
    for _ in range(100):  # 400 windows from a one-example corpus
        b = next(ld)
        for row in range(4):
            starts.add(_check_window(b, row))
    ld.close()
    assert len(starts) > 3


def test_cache_overflow_falls_back_to_streaming(tmp_path):
    ld = _loader(_write_shards(tmp_path), motion_input_len=8, target_len=4,
                 target_shift=8, audio_input_len=12, seed=0, cache_bytes=1)
    for _ in range(30):
        b = next(ld)
        assert b["motion_input"].shape == (2, 8, 225)
        assert np.isfinite(b["motion_input"]).all()
    ld.close()


def test_cache_disabled_matches_streaming_shapes(tmp_path):
    ld = _loader(_write_shards(tmp_path), motion_input_len=8, target_len=4,
                 target_shift=8, audio_input_len=12, seed=0, cache_bytes=0)
    for _ in range(30):
        assert next(ld)["audio_input"].shape == (2, 12, 35)
    ld.close()


# -- against the JAX package's loader -----------------------------------------

@pytest.mark.parametrize("cache_bytes,shuffle", [
    (64 << 20, 100),   # the corpus fits: epochs after the first cached
    (0, 100),          # streaming every epoch
    (200_000, 100),    # the cache overflows mid-fill, then streams
    (64 << 20, 3),     # a buffer smaller than the corpus
])
def test_batches_bit_equal_to_the_jax_loader(tmp_path, cache_bytes,
                                             shuffle):
    """The same shards, seed, cache budget and buffer give the same
    batches bit for bit as mint_tpu's loader, over 16 epochs of the
    10-example corpus (the reader shuffles the shards, windows and pops
    by its seed; the buffer is full before each pop, so the order does
    not depend on thread timing)."""
    assert jax_native_loader.available(), jax_native_loader.build_error()
    files = _write_shards(tmp_path, n_shards=2, per_shard=5)
    kw = dict(batch_size=4, motion_input_len=8, target_len=4,
              target_shift=8, audio_input_len=12, seed=42,
              shuffle_buffer=shuffle, cache_bytes=cache_bytes)
    ours = native_loader.NativeTrainLoader(files, **kw)
    theirs = jax_native_loader.NativeTrainLoader(files, **kw)
    try:
        for i in range(40):  # 160 windows: 16 epochs of 10 examples
            a, b = next(ours), next(theirs)
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                assert np.array_equal(a[key], b[key]), (i, key)
    finally:
        ours.close()
        theirs.close()


def test_argument_guards():
    with pytest.raises(ValueError, match="must both be >= 1"):
        native_loader.NativeTrainLoader(["x"], 0, 8, 4, 8, 12)
    with pytest.raises(ValueError, match="must both be >= 1"):
        native_loader.NativeTrainLoader(["x"], 2, 8, 4, 8, 12,
                                        shuffle_buffer=0)


_RACE = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from mint_tpu_torch.data import native_loader as n
n.BUILD_DIR = {build!r}
while time.time() < {start}:
    time.sleep(0.005)
assert n.available(), n.build_error()
print(n.library_path(), n.masked_crc32c(b"race"))
"""


def test_build_raced_from_two_processes(tmp_path):
    """Two processes that find no library build it at once into a fresh
    build directory: both load the one library (the build lock and the
    rename), and no temporary file is left."""
    import time

    build = str(tmp_path / "_build")
    code = _RACE.format(repo=REPO, build=build, start=time.time() + 1.0)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1  # the same library and CRC
    path, crc = lines.pop().split()
    assert os.path.dirname(path) == build
    assert int(crc) == native_loader.masked_crc32c(b"race")
    assert sorted(os.listdir(build)) == sorted(
        [os.path.basename(path), ".mint_loader.lock"])


def test_the_port_never_loads_the_jax_packages_library():
    """The port's library is built from its own source into its own build
    directory, and its loaded image is that file."""
    path = native_loader.library_path()
    assert path.startswith(native_loader.BUILD_DIR)
    assert native_loader.SOURCE == os.path.join(
        REPO, "mint_tpu_torch", "csrc", "mint_loader.cc")
    assert native_loader._lib._name == path
    with open(f"/proc/{os.getpid()}/maps") as f:
        mapped = {line.split()[-1] for line in f if ".so" in line}
    assert path in mapped


# -- the train CLI's input backends -------------------------------------------

@pytest.fixture
def cli_setup(tmp_path):
    from mint_tpu_torch.config.serialize import pipeline_to_text
    from test_torch_train import tiny_pipeline_config, write_corpus

    write_corpus(str(tmp_path / "data"))
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(tiny_pipeline_config(
        str(tmp_path / "data" / "*_tfrecord-train*"))))
    return tmp_path, str(cfg_path)


def _train(cfg_path, model_dir, steps, backend):
    from test_torch_train import _cli, _rows

    _cli(cfg_path, model_dir, steps, f"--input_backend={backend}")
    return _rows(model_dir)


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_train_cli_trains_from_the_native_loader(cli_setup, backend,
                                                 caplog):
    """``--input_backend=native``, and ``auto`` where the library builds,
    train from the C++ loader (its own log line), checkpoint and resume,
    as the other backends do (tests/test_torch_train.py)."""
    tmp_path, cfg_path = cli_setup
    model_dir = str(tmp_path / "run")
    caplog.set_level("INFO")
    rows = _train(cfg_path, model_dir, 4, backend)
    assert "input: the native loader (1 shards, batch 8, seed 0)" \
        in caplog.text
    assert "Python pipeline" not in caplog.text
    assert [r["step"] for r in rows] == [1, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in rows)
    rows = _train(cfg_path, model_dir, 7, backend)
    assert [r["step"] for r in rows] == [1, 3, 4, 6, 7]
    assert "restored checkpoint at step 4" in caplog.text


def test_auto_falls_back_and_native_raises_without_the_library(
        cli_setup, monkeypatch, caplog):
    """Where the library does not build, ``auto`` warns with the build
    error and trains from the Python pipeline (a host loader choosing its
    path), and ``native`` raises with that error."""
    tmp_path, cfg_path = cli_setup
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_error", "g++ failed: test")
    caplog.set_level("INFO")
    rows = _train(cfg_path, str(tmp_path / "auto"), 2, "auto")
    assert [r["step"] for r in rows] == [1, 2]
    assert ("native loader unavailable (g++ failed: test); Python "
            "pipeline") in caplog.text
    assert "input: the Python pipeline (batch 8, seed None)" in caplog.text
    with pytest.raises(RuntimeError, match="native loader unavailable: "
                       "g\\+\\+ failed: test"):
        _train(cfg_path, str(tmp_path / "native"), 2, "native")


def test_each_data_rank_opens_the_loader_with_its_share_and_seed(
        cli_setup, monkeypatch):
    """Over a mesh the CLI opens the native loader with the global batch /
    data and the seed SEED_STRIDE x data index, as its Python path does,
    so the ranks of one model group read the same batches."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.parallel import mesh as mesh_lib
    from mint_tpu_torch.tools import train as train_cli

    _, cfg_path = cli_setup
    pipe = load_pipeline_config(cfg_path)
    seen = []

    class Recorder:
        def __init__(self, files, **kw):
            seen.append((files, kw))

    monkeypatch.setattr(native_loader, "NativeTrainLoader", Recorder)
    data = 2
    for d in range(data):
        train_cli.host_input("native", pipe.train_config, pipe.train_dataset,
                             mesh_lib.SEED_STRIDE * d,
                             pipe.train_config.batch_size // data)
    assert [kw["seed"] for _, kw in seen] == [0, mesh_lib.SEED_STRIDE]
    assert {kw["batch_size"] for _, kw in seen} == {4}
    assert seen[0][0] == tfrecord.glob(pipe.train_dataset.data_files)
    kw = seen[0][1]
    assert (kw["motion_input_len"], kw["target_len"], kw["target_shift"],
            kw["audio_input_len"], kw["motion_dim_raw"],
            kw["audio_dim"]) == (8, 2, 8, 16, 219, 35)
