"""The port's training input (mint_tpu_torch/data) against the JAX
package's: the Example codec and TFRecord files byte for byte, the host
pipeline's batches for a seed, the prefetcher, and the device-resident
corpus (on the CPU here) held to its source rows and to resume."""

import copy
import os

import numpy as np
import pytest
import torch

from mint_tpu.config import load_pipeline_config as jax_load_config
from mint_tpu.data import example as jax_example
from mint_tpu.data import pipeline as jax_pipeline
from mint_tpu.data import tfrecord as jax_tfrecord
from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.data import example, pipeline, tfrecord
from mint_tpu_torch.data.device_dataset import DeviceDataset
from mint_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.train import CheckpointManager, Controller, Trainer
from mint_tpu_torch.train import schedules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")


def _features(rng):
    motion = rng.standard_normal((7, 219)).astype(np.float32)
    return {"motion_sequence": motion.ravel(),
            "motion_sequence_shape": np.asarray(motion.shape, np.int64),
            "motion_name": ["gBR_sBM_cAll_d04_mBR0_ch01"],
            "audio_name": [b"mBR0"],
            "ints": np.asarray([-3, 0, 2 ** 40], np.int64)}


def test_example_bytes_equal_jax():
    feats = _features(np.random.default_rng(0))
    data = example.encode_example(feats)
    assert data == jax_example.encode_example(feats)
    back = example.decode_example(data)
    np.testing.assert_array_equal(back["motion_sequence"],
                                  feats["motion_sequence"])
    np.testing.assert_array_equal(back["ints"], feats["ints"])
    assert back["motion_name"] == [b"gBR_sBM_cAll_d04_mBR0_ch01"]
    parsed = pipeline.parse_example(data)
    assert parsed["motion_sequence"].shape == (7, 219)
    assert parsed["motion_name"] == "gBR_sBM_cAll_d04_mBR0_ch01"


def test_tfrecord_round_trip_and_crc_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    records = [rng.bytes(n) for n in (0, 1, 13, 4096)]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    with tfrecord.TFRecordWriter(ours) as w:
        for r in records:
            w.write(r)
    with jax_tfrecord.TFRecordWriter(theirs) as w:
        for r in records:
            w.write(r)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(tfrecord.read_records(ours, verify_crc=True)) == records
    assert list(jax_tfrecord.read_many([ours], verify_crc=True)) == records
    for r in records + [b"123456789"]:
        assert tfrecord.crc32c(r) == jax_tfrecord.crc32c(r)
        assert tfrecord.masked_crc32c(r) == jax_tfrecord.masked_crc32c(r)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # CRC-32C check value


def test_tfrecord_verify_crc_catches_corruption(tmp_path):
    path = str(tmp_path / "r")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"hello world")
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # a byte of the payload
    open(path, "wb").write(bytes(raw))
    assert list(tfrecord.read_records(path)) == [bytes(raw[12:23])]
    with pytest.raises(IOError, match="corrupted data crc"):
        list(tfrecord.read_records(path, verify_crc=True))


def write_corpus(directory, lengths=(40, 25, 60), audio_extra=0,
                 name="corpus-0"):
    """Sequences whose content encodes (sequence, time, channel), so any
    window can be traced back to its source rows."""
    path = os.path.join(str(directory), name)
    with tfrecord.TFRecordWriter(path) as w:
        for s, t in enumerate(lengths):
            motion = (1000.0 * s + np.arange(t)[:, None]
                      + 0.001 * np.arange(219)[None, :]).astype(np.float32)
            ta = t + audio_extra
            audio = (-1000.0 * s - np.arange(ta)[:, None]
                     - 0.001 * np.arange(35)[None, :]).astype(np.float32)
            w.write(example.encode_example({
                "motion_sequence": motion.ravel(),
                "motion_sequence_shape": np.asarray(motion.shape, np.int64),
                "motion_name": [f"m{s}".encode()],
                "audio_sequence": audio.ravel(),
                "audio_sequence_shape": np.asarray(audio.shape, np.int64),
                "audio_name": [f"a{s}".encode()],
            }))
    return [path]


def small_configs(input_sec=8.0, target_sec=2.0, shift_sec=8.0):
    """The flagship's dataset and train configs, port and JAX copies,
    shrunk to motion_in 8, target 2, shift 8, audio_in 16, batch 4."""
    out = []
    for load in (load_pipeline_config, jax_load_config):
        pipe = copy.deepcopy(load(CONFIG))
        ds = pipe.train_dataset
        ds.input_length_sec = input_sec
        ds.target_length_sec = target_sec
        ds.target_shift_sec = shift_sec
        pipe.train_config.batch_size = 4
        out.append(pipe)
    return out


def test_modality_params_equal_jax():
    ours, theirs = small_configs()
    assert (pipeline.get_modality_to_param_dict(ours.train_dataset)
            == jax_pipeline.get_modality_to_param_dict(
                theirs.train_dataset))
    assert (pipeline.get_modality_to_param_dict(
        load_pipeline_config(CONFIG).train_dataset)
        == jax_pipeline.get_modality_to_param_dict(
            jax_load_config(CONFIG).train_dataset))


@pytest.mark.parametrize("is_training", [True, False])
def test_pipeline_batches_equal_jax(tmp_path, is_training):
    """For one seed the port's pipeline gives the JAX pipeline's batches
    (training: shuffled windows, dropping the sequence too short for one;
    eval: full-length audio, batch 1)."""
    files = write_corpus(tmp_path, lengths=(40, 25, 60, 10, 33))
    ours, theirs = small_configs()
    if not is_training:
        files = files[:1]
        ours.eval_config.batch_size = theirs.eval_config.batch_size = 1
    got = pipeline.create_input(
        ours.train_config if is_training else ours.eval_config,
        ours.train_dataset, is_training=is_training, seed=7,
        data_files=files)
    want = jax_pipeline.create_input(
        theirs.train_config if is_training else theirs.eval_config,
        theirs.train_dataset, is_training=is_training, seed=7,
        data_files=files)
    for _ in range(6 if is_training else 5):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if not is_training:
        with pytest.raises(StopIteration):
            next(got)
    for it in (got, want):
        it.close()


def test_to_device_and_prefetcher():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "name": np.asarray(["a", "b"])} for i in range(5)]
    placed = to_device(batches[0], "cpu")
    assert list(placed) == ["x"] and placed["x"].dtype == torch.float32
    pre = DevicePrefetcher(iter(batches), lambda b: to_device(b, "cpu"))
    got = [int(b["x"][0, 0]) for b in pre]
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(pre)
    pre.close()

    def failing():
        yield batches[0]
        raise OSError("bad shard")

    pre = DevicePrefetcher(failing(), lambda b: b)
    next(pre)
    with pytest.raises(OSError, match="bad shard"):
        next(pre)
    with pytest.raises(OSError, match="bad shard"):
        next(pre)
    pre.close()


def test_prefetcher_close_stops_an_endless_stream():
    def endless():
        i = 0
        while True:
            yield {"x": np.asarray([i])}
            i += 1

    pre = DevicePrefetcher(endless(), lambda b: b, depth=2)
    assert int(next(pre)["x"][0]) == 0
    pre.close()
    assert not pre._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pre)


# -- the device-resident corpus ----------------------------------------------

def _dataset(tmp_path, lengths=(40, 25, 60), batch_size=16, **kw):
    ours, _ = small_configs()
    return DeviceDataset.from_files(write_corpus(tmp_path, lengths),
                                    ours.train_dataset,
                                    batch_size=batch_size, device="cpu",
                                    **kw)


def _trace(batch, lengths):
    """Check every window against its source rows; return (seq, start)s."""
    motion = batch["motion_input"].numpy()
    target = batch["target"].numpy()
    audio = batch["audio_input"].numpy()
    out = []
    for b in range(motion.shape[0]):
        val = motion[b, 0, 6]
        seq, start = int(val) // 1000, int(round(val)) % 1000
        assert 0 <= start <= lengths[seq] - 16, (seq, start)
        np.testing.assert_array_equal(motion[b, :, :6], 0.0)
        np.testing.assert_allclose(
            motion[b, :, 6], 1000.0 * seq + start + np.arange(8), rtol=1e-6)
        np.testing.assert_allclose(
            target[b, :, 6], 1000.0 * seq + start + 8 + np.arange(2),
            rtol=1e-6)
        np.testing.assert_allclose(
            audio[b, :, 0], -1000.0 * seq - (start + np.arange(16)),
            rtol=1e-6)
        out.append((seq, start))
    return out


def test_sampled_windows_match_source(tmp_path):
    dset = _dataset(tmp_path)
    assert dset.n_sequences == 3  # window = max(8, 8 + 2, 16) = 16
    batch = dset.sample(0, 0)
    assert batch["motion_input"].shape == (16, 8, 225)
    assert batch["target"].shape == (16, 2, 225)
    assert batch["audio_input"].shape == (16, 16, 35)
    _trace(batch, (40, 25, 60))
    assert dset.nbytes == 125 * (225 + 35) * 4 + 3 * 8 * 2


def test_short_sequences_dropped(tmp_path):
    dset = _dataset(tmp_path, lengths=(40, 10, 60), batch_size=4)
    assert dset.n_sequences == 2
    for step in range(5):
        seqs = {s for s, _ in _trace(dset.sample(1, step), (40, 10, 60))}
        assert seqs <= {0, 2}


def test_window_starts_cover_range(tmp_path):
    dset = _dataset(tmp_path, lengths=(20,), batch_size=64)
    starts = set()
    for step in range(40):
        starts.update(s for _, s in _trace(dset.sample(0, step), (20,)))
    assert starts == set(range(5))  # 20 - 16 + 1 valid starts


def test_draws_are_a_function_of_seed_and_step(tmp_path):
    dset = _dataset(tmp_path)
    a, b = dset.sample(3, 5), dset.sample(3, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = dset.sample(3, 6)
    d = dset.sample(4, 5)
    assert not torch.equal(a["motion_input"], c["motion_input"])
    assert not torch.equal(a["motion_input"], d["motion_input"])


def test_direct_construction_validation():
    """Inconsistent tables fail at construction: a bad counts or offsets
    entry would let the sampler gather windows across sequences."""
    motion = np.zeros((60, 225), np.float32)
    audio = np.zeros((60, 35), np.float32)
    offsets = np.array([0, 30])

    def build_ds(counts, offs=offsets, audio_arr=audio):
        return DeviceDataset(motion, audio_arr, offs, np.asarray(counts),
                             motion_input_len=8, target_len=2,
                             target_shift=8, audio_input_len=16,
                             batch_size=4, device="cpu")

    build_ds([15, 15])
    with pytest.raises(ValueError, match="counts entry must be >= 1"):
        build_ds([0, 15])
    with pytest.raises(ValueError, match="sorted"):
        build_ds([15, 15], offs=np.array([30, 0]))
    with pytest.raises(ValueError, match="exceeds"):
        build_ds([16, 15])
    with pytest.raises(ValueError, match="exceeds"):
        build_ds([15, 16])
    with pytest.raises(ValueError, match="row-aligned"):
        build_ds([15, 15], audio_arr=np.zeros((59, 35), np.float32))


def test_device_dataset_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceDataset(np.zeros((20, 225), np.float32),
                      np.zeros((20, 35), np.float32), np.array([0]),
                      np.array([5]), 8, 2, 8, 16, batch_size=2)


def _tiny_model():
    """The flagship cut to 1 block of width 32 per transformer and 8/16
    frames, keeping the 225-dim motion."""
    fact = copy.deepcopy(load_pipeline_config(CONFIG).multi_modal_model
                         .fact_model)
    for tf in [m.model[0].transformer for m in fact.modality] + [
            fact.cross_modal_model.transformer]:
        tf.hidden_size, tf.num_hidden_layers = 32, 1
        tf.num_attention_heads, tf.intermediate_size = 2, 64
    fact.modality_by_name("motion").sequence_length = 8
    fact.modality_by_name("audio").sequence_length = 16
    return init_params(FACT(fact), torch.Generator().manual_seed(0))


def test_sampled_loop_matches_manual_steps(tmp_path):
    """train_steps_sampled equals train_step fed dataset.sample(seed,
    absolute step)."""
    dset = _dataset(tmp_path, lengths=(40, 60), batch_size=8)
    model = _tiny_model()
    tr = Trainer(model, schedules.constant(1e-3))
    a = tr.init_state(model)
    for step in range(6):
        a, metrics_a = tr.train_step(a, dset.sample(5, step))
    b = tr.init_state(model)
    b, metrics_b = tr.train_steps_sampled(b, dset, loop=6, seed=5)
    assert b.step == 6
    assert float(metrics_a["loss"]) == float(metrics_b["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_sampled_resume_draws_same_windows(tmp_path):
    """Draws bind to ABSOLUTE steps: 3 + 3 resumed == 6 uninterrupted."""
    dset = _dataset(tmp_path, lengths=(40, 60), batch_size=8)
    model = _tiny_model()
    tr = Trainer(model, schedules.constant(1e-3))
    s1, _ = tr.train_steps_sampled(tr.init_state(model), dset, loop=6,
                                   seed=9)
    s2, _ = tr.train_steps_sampled(tr.init_state(model), dset, loop=3,
                                   seed=9)
    s2, _ = tr.train_steps_sampled(s2, dset, loop=3, seed=9)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k


def test_controller_with_sampler_trains_checkpoints_and_converges(tmp_path):
    dset = _dataset(tmp_path, lengths=(40, 60), batch_size=8)
    model = _tiny_model()
    tr = Trainer(model, schedules.constant(3e-3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10,
                            max_to_keep=3)
    ctl = Controller(trainer=tr, state=tr.init_state(model),
                     steps_per_loop=5, checkpoint_manager=mgr,
                     summary_dir=str(tmp_path / "s"), summary_interval=5,
                     train_sampler=dset)
    first = ctl.train(5)["loss"]
    last = ctl.train(40)["loss"]
    assert ctl.global_step == 40
    assert np.isfinite(last) and last < first / 2, (first, last)
    ctl.close()
    # Saves at 5, then whenever 10 steps have elapsed: 15, 25, 35; keep 3.
    assert sorted(int(d) for d in os.listdir(tmp_path / "ckpt")) == [
        15, 25, 35]
