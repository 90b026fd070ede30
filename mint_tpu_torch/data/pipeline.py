"""Input pipeline: TFRecord shards -> windowed, batched FACT examples (the
port's copy of ``mint_tpu/data/pipeline.py``: the same windows for the same
seed).

Host-side NumPy re-implementation of the reference input path
(mint/core/inputs.py + mint/utils/inputs_util.py):

- ``get_modality_to_param_dict`` — seconds x pseudo-sample-rate -> frame
  counts (inputs_util.py:18-45)
- ``fact_preprocessing`` — pad motion 219->225 with 6 leading zeros, sample
  one random window per example (train) or start=0 with full-length audio
  (eval) (inputs_util.py:59-105)
- ``create_input`` — interleaved shard reading, shuffle(100).repeat() for
  training, sequential single pass for eval, fixed-size batches with
  drop_remainder, background prefetch (inputs.py:20-123)

Batches are plain dicts of NumPy arrays; ``data/prefetch.py`` copies them
to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mint_tpu_torch.config.schema import DatasetConfig
from mint_tpu_torch.data import example as example_codec
from mint_tpu_torch.data import tfrecord


def get_modality_to_param_dict(dataset_config: DatasetConfig) -> Dict:
    """Map modality name -> window parameters (inputs_util.py:18-45)."""
    out: Dict[str, Dict] = {}
    for mod in dataset_config.modality:
        if mod.which() != "general_modality":
            raise ValueError(f"Unknown modality type: {mod.which()}")
        gm = mod.general_modality
        out[gm.feature_name] = {
            "feature_dim": gm.dimension,
            "input_length": int(dataset_config.input_length_sec
                                * gm.sample_rate),
            "target_length": int(dataset_config.target_length_sec
                                 * gm.sample_rate),
            "target_shift": int(dataset_config.target_shift_sec
                                * gm.sample_rate),
            "sample_rate": gm.sample_rate,
            "resize": gm.resize,
            "crop_size": gm.crop_size,
        }
    return out


def parse_example(record: bytes) -> Dict[str, np.ndarray]:
    """Decode one serialized Example into named sequences.

    Output keys mirror the reference parse spec (inputs.py:44-55):
    `{modality}_sequence` reshaped to `{modality}_sequence_shape`, plus
    `{modality}_name` strings.
    """
    raw = example_codec.decode_example(record)
    out: Dict[str, np.ndarray] = {}
    for key, value in raw.items():
        if key.endswith("_sequence"):
            shape = raw.get(f"{key}_shape")
            arr = np.asarray(value, dtype=np.float32)
            if shape is not None:
                arr = arr.reshape([int(s) for s in np.asarray(shape)])
            out[key] = arr
        elif key.endswith("_name"):
            out[key] = value[0].decode("utf-8") if value else ""
    return out


class SequenceTooShort(ValueError):
    """A training example cannot yield one full window.

    Raised by :func:`fact_preprocessing`; the training stream DROPS such
    examples (with one warning), as ``DeviceDataset.from_files`` and the
    JAX package's native loader do."""


def fact_preprocessing(example: Dict, modality_to_params: Dict,
                       is_training: bool,
                       rng: np.random.Generator) -> Dict:
    """Window sampling for FACT (inputs_util.py:59-105), NumPy edition.

    Degenerate-data handling matches the native loader
    (``csrc/mint_loader.cc`` ``MakeWindow``): an example whose motion or
    audio is shorter than one window raises :class:`SequenceTooShort`
    (the stream drops it), a sampled window starting past the end of the
    audio likewise, and a window whose audio TAIL runs short is
    zero-padded to ``audio_input_length``.
    """
    motion = np.asarray(example["motion_sequence"], np.float32)
    motion_seq_length = motion.shape[0]
    motion_input_length = modality_to_params["motion"]["input_length"]
    motion_target_length = modality_to_params["motion"]["target_length"]
    motion_target_shift = modality_to_params["motion"]["target_shift"]
    audio_input_length = modality_to_params["audio"]["input_length"]

    # Pad the motion translation from 3-dim to 9-dim: 6 leading zeros.
    motion = np.pad(motion, [[0, 0], [6, 0]])

    if is_training:
        audio = np.asarray(example["audio_sequence"], np.float32)
        window_size = max(motion_input_length,
                          motion_target_shift + motion_target_length,
                          audio_input_length)
        hi = motion_seq_length - window_size + 1
        if hi <= 0 or audio.shape[0] < window_size:
            raise SequenceTooShort(
                f"sequence too short for one window: motion "
                f"{motion_seq_length}, audio {audio.shape[0]} < "
                f"window {window_size}")
        start = int(rng.integers(0, hi))
        if start >= audio.shape[0]:
            # Motion much longer than audio and the sampled start lies
            # past the audio's end — drop, like the native loader.
            raise SequenceTooShort(
                f"sampled window start {start} is past the audio end "
                f"{audio.shape[0]}")
    else:
        start = 0

    out = {k: v for k, v in example.items()
           if not k.endswith("_sequence")}
    out["motion_input"] = motion[start:start + motion_input_length]
    if is_training:
        out["target"] = motion[start + motion_target_shift:
                               start + motion_target_shift
                               + motion_target_length]
        audio_window = audio[start:start + audio_input_length]
        if audio_window.shape[0] < audio_input_length:
            # Audio tail shorter than the audio window (audio shorter
            # than motion): zero-pad, like the native loader.
            audio_window = np.pad(
                audio_window,
                [[0, audio_input_length - audio_window.shape[0]], [0, 0]])
        out["audio_input"] = audio_window
    else:
        out["audio_input"] = np.asarray(example["audio_sequence"],
                                        np.float32)
    return out


def preprocess_labels(example: Dict, dataset_config: DatasetConfig) -> Dict:
    """Multi-hot labels for classification targets
    (inputs_util.py:48-56): pop `data_target_field`, one-hot to
    `target_num_categories`, max over occurrences."""
    target = np.asarray(example.pop(dataset_config.data_target_field),
                        np.int64).reshape(-1)
    one_hot = np.zeros((len(target), dataset_config.target_num_categories),
                       np.float32)
    one_hot[np.arange(len(target)), target] = 1.0
    example["target"] = one_hot.max(axis=0)
    return example


def _batch(examples: List[Dict]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    out = {}
    for k in keys:
        vals = [e[k] for e in examples]
        if isinstance(vals[0], str):
            out[k] = np.asarray(vals)
        else:
            shapes = {np.shape(v) for v in vals}
            if len(shapes) > 1:
                raise ValueError(
                    f"cannot batch ragged feature {k!r} (shapes "
                    f"{sorted(shapes)}); eval keeps full-length audio "
                    "per clip, so use eval batch_size=1 (the shipped "
                    "config's setting) and let the evaluator re-batch "
                    "by generatable length")
            out[k] = np.stack(vals)
    return out


class _Prefetcher:
    """Background-thread prefetch (reference: ds.prefetch(1)).

    Host-side batch prefetch; :class:`mint_tpu_torch.data.prefetch.
    DevicePrefetcher` is the device-placement variant and chains to this
    one's :meth:`close` via its own close()."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                # Timeout-put so a consumer that abandoned the stream
                # (close()) unblocks the producer instead of leaving it
                # parked on a full queue holding shard file handles.
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surface in the consumer, not stderr
            self._error = e
        finally:
            if not self._stop.is_set():
                self._q.put(self._done)

    def close(self):
        """Stop the producer thread and release its upstream iterator."""
        self._stop.set()
        try:  # unblock a producer parked on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            # Only close the upstream once the producer has exited: a
            # generator still executing inside the producer thread
            # raises ValueError("generator already executing") from
            # close().  On join timeout we leak the daemon thread
            # instead (same policy as DevicePrefetcher.close()).
            close_upstream = getattr(self._it, "close", None)
            if callable(close_upstream):
                close_upstream()
        try:  # a straggling consumer sees StopIteration, not a hang
            self._q.put_nowait(self._done)
        except queue.Full:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_finished", False):
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True  # stay exhausted on repeat iteration
            error = getattr(self, "_error", None)
            if error is not None:
                raise RuntimeError(
                    "input pipeline producer failed") from error
            raise StopIteration
        return item


def create_input(train_eval_config, dataset_config: DatasetConfig,
                 is_training: bool = True, use_tpu: bool = True,
                 seed: Optional[int] = None,
                 data_files: Optional[Sequence[str]] = None,
                 prefetch: bool = True,
                 batch_size_override: Optional[int] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Batched input iterator (reference inputs.create_input, inputs.py:20).

    Training: endless shuffled(100) windows, fixed batches, drop remainder.
    Eval: one sequential pass; remainder kept unless use_tpu.
    ``batch_size_override`` serves multi-host training, where each host
    loads global_batch / process_count examples (tools/train.py).
    """
    batch_size = batch_size_override or train_eval_config.batch_size
    files = (list(data_files) if data_files is not None
             else tfrecord.glob(dataset_config.data_files))
    if not files:
        raise FileNotFoundError(
            f"no input files match {dataset_config.data_files!r}")
    modality_to_params = get_modality_to_param_dict(dataset_config)
    use_fact = "fact_preprocessor" in dataset_config.data_augmentation_options
    rng = np.random.default_rng(seed)
    drop_remainder = use_tpu or is_training

    def interleave_records(ordered_files):
        """Round-robin over per-shard readers (the reference's parallel
        interleave, inputs.py:63-69): consecutive records come from
        different shards, so the shuffle(100) buffer spans many shards
        instead of ~1.5 sequential ones."""
        readers = [tfrecord.read_records(f) for f in ordered_files]
        while readers:
            alive = []
            for r in readers:
                record = next(r, None)
                if record is not None:
                    alive.append(r)
                    yield record
            readers = alive

    warned_short = [False]

    def example_stream():
        if is_training:
            while True:  # .repeat()
                order = rng.permutation(len(files))
                # shuffle(100) over a round-robin interleave of the shards
                buf: List[Dict] = []
                for record in interleave_records(
                        [files[i] for i in order]):
                    ex = parse_example(record)
                    if use_fact:
                        try:
                            ex = fact_preprocessing(ex, modality_to_params,
                                                    True, rng)
                        except SequenceTooShort as e:
                            # Drop, as DeviceDataset.from_files does.
                            if not warned_short[0]:
                                warned_short[0] = True
                                import logging
                                logging.getLogger(__name__).warning(
                                    "dropping training example(s) too "
                                    "short for one window (first: %s); "
                                    "further drops are silent", e)
                            continue
                    buf.append(ex)
                    if len(buf) >= 100:
                        idx = int(rng.integers(0, len(buf)))
                        yield buf.pop(idx)
                while buf:
                    idx = int(rng.integers(0, len(buf)))
                    yield buf.pop(idx)
        else:
            for record in tfrecord.read_many(files):
                ex = parse_example(record)
                if use_fact:
                    ex = fact_preprocessing(ex, modality_to_params,
                                            False, rng)
                yield ex

    def batches():
        pending: List[Dict] = []
        for ex in example_stream():
            pending.append(ex)
            if len(pending) == batch_size:
                yield _batch(pending)
                pending = []
        if pending and not drop_remainder:
            yield _batch(pending)

    it = batches()
    return _Prefetcher(it) if prefetch else it
