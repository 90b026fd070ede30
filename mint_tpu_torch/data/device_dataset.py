"""Device-resident training corpus: windows drawn on the card (counterpart
of ``mint_tpu/data/device_dataset.py``).

The corpus is decoded once into two resident tensors on the device, motion
[sum_T, 225] and audio [sum_T, 35] (the full AIST++ train split is ~3.5 GB
in f32), with each sequence's first row (``offsets``) and its number of
valid window starts (``counts``).  Each step draws its batch on the device:
a sequence uniformly, then a window start uniformly within it, and gathers
the windows.  After the upload no step moves input from the host.

Sampling, as the JAX package's: every step draws sequences i.i.d. (the
same marginal window distribution per draw as the reference's epochs of
one window per sequence, without the epoch structure).

Random numbers: each step's draws come from a ``torch.Generator`` on the
device seeded from (seed, absolute step), so a resumed run draws the
windows the uninterrupted run would have drawn.  torch cannot reproduce
JAX's threefry draws, so the port's windows are not the JAX package's:
the tests hold them to the source data (every window is rows of one
sequence, at a valid start) and to resume, not to JAX's windows.

Over a mesh of ranks (``parallel/mesh.py``) each rank draws its own
``global batch / data`` rows: a rank's generator seed adds
``SEED_STRIDE * data_index`` to the run's, so the data ranks draw
different windows and the ranks of one model group the same ones (data
index 0 draws what one device draws).  ``shard_over_data`` (the JAX
package's, ``mint_tpu/data/device_dataset.py:116-170``): each data rank
keeps only its share of the corpus, sequences dealt round-robin, its
draw table padded to the largest share by cycling its own sequences (up
to data - 1 sequences get one extra slot, as there), and draws from it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mint_tpu_torch.data import pipeline as data_pipeline
from mint_tpu_torch.data import tfrecord
from mint_tpu_torch.parallel.mesh import SEED_STRIDE
from mint_tpu_torch.utils import profiling
from mint_tpu_torch.utils.device import resolve


def _draw_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step), mixed by splitmix64's
    finaliser so that every bit depends on both (the CPU generator reads
    only the low 32 bits of its seed)."""
    mask = (1 << 64) - 1
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


class DeviceDataset:
    """A device-resident windowed training corpus.

    Attributes:
      arrays: dict of tensors on `device`: ``motion`` [sum_T, motion_dim],
        ``audio`` [sum_T, audio_dim], ``offsets`` [n] (first row of each
        sequence in the stores) and ``counts`` [n] (valid window starts per
        sequence), both int64.
    """

    def __init__(self, motion: np.ndarray, audio: np.ndarray,
                 offsets: np.ndarray, counts: np.ndarray,
                 motion_input_len: int, target_len: int, target_shift: int,
                 audio_input_len: int, batch_size: int,
                 device: torch.device | str = "cuda", data_index: int = 0,
                 slots: np.ndarray | None = None):
        """`batch_size` is this rank's; `data_index` its index on a mesh's
        data axis (its draws' seed offset); `slots`, where given, the
        sequence of each draw slot (a draw picks a slot uniformly)."""
        self.seed_offset = SEED_STRIDE * int(data_index)
        self.motion_input_len = int(motion_input_len)
        self.target_len = int(target_len)
        self.target_shift = int(target_shift)
        self.audio_input_len = int(audio_input_len)
        self.batch_size = int(batch_size)
        self.motion_span = max(self.motion_input_len,
                               self.target_shift + self.target_len)
        self.device = resolve(device, "DeviceDataset")
        self.n_sequences = int(len(offsets))
        if self.n_sequences == 0:
            raise ValueError(
                "no sequence is long enough for one training window")
        # A counts entry out of range would let the sampler draw a window
        # straddling two sequences (or past the tail): checked here, since
        # the gather on the device would not fail.
        counts = np.asarray(counts)
        offsets = np.asarray(offsets)
        if (counts < 1).any():
            raise ValueError(
                f"every counts entry must be >= 1; got min "
                f"{int(counts.min())} (sequences too short for one window "
                "must be filtered out, like from_files does)")
        if (np.diff(offsets) < 0).any() or (offsets < 0).any():
            raise ValueError("offsets must be non-negative and sorted")
        n_rows = int(np.shape(motion)[0])
        if int(np.shape(audio)[0]) != n_rows:
            raise ValueError(
                f"motion ({n_rows} rows) and audio "
                f"({int(np.shape(audio)[0])} rows) stores must be "
                "row-aligned: they share offsets/counts")
        span = max(self.motion_span, self.audio_input_len)
        ends = np.concatenate([offsets[1:], [n_rows]])
        max_counts = ends - offsets - span + 1
        if (counts > max_counts).any():
            bad = int(np.argmax(counts > max_counts))
            raise ValueError(
                f"counts[{bad}] = {int(counts[bad])} exceeds the "
                f"{int(max_counts[bad])} window start(s) that fit in "
                f"sequence {bad} (rows {int(offsets[bad])}.."
                f"{int(ends[bad])}, window span {span})")

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        self.arrays = {"motion": put(motion, np.float32),
                       "audio": put(audio, np.float32),
                       "offsets": put(offsets, np.int64),
                       "counts": put(counts, np.int64)}
        self._slots = None if slots is None else put(slots, np.int64)
        self._generator = torch.Generator(device=self.device)
        self._motion_rows = torch.arange(self.motion_span, device=self.device)
        self._audio_rows = torch.arange(self.audio_input_len,
                                        device=self.device)

    @classmethod
    def from_files(cls, files: Sequence[str], dataset_config, batch_size: int,
                   device: torch.device | str = "cuda",
                   verify_crc: bool = False, mesh=None,
                   shard_over_data: bool = False) -> "DeviceDataset":
        """Decode tfrecord shards into the resident stores.

        Window geometry comes from the dataset config as in the host
        pipeline (``get_modality_to_param_dict``); motion is padded
        219 -> 225 with 6 leading zeros here, once, instead of per window.
        Sequences too short for one window are dropped.

        With `mesh`, `batch_size` is the GLOBAL batch: this rank draws
        ``batch_size / data`` rows, seeded by its data index; with
        `shard_over_data` it keeps only its data index's share of the
        corpus.
        """
        params = data_pipeline.get_modality_to_param_dict(dataset_config)
        motion_in = params["motion"]["input_length"]
        target_len = params["motion"]["target_length"]
        target_shift = params["motion"]["target_shift"]
        audio_in = params["audio"]["input_length"]
        window = max(motion_in, target_shift + target_len, audio_in)

        motions, audios = [], []
        for record in tfrecord.read_many(list(files), verify_crc=verify_crc):
            ex = data_pipeline.parse_example(record)
            motion = np.asarray(ex["motion_sequence"], np.float32)
            audio = np.asarray(ex["audio_sequence"], np.float32)
            usable = min(motion.shape[0], audio.shape[0])
            if usable < window:
                continue
            motions.append(np.pad(motion[:usable], [[0, 0], [6, 0]]))
            audios.append(audio[:usable])
        if not motions:
            raise ValueError(
                f"no sequence in {len(list(files))} shard(s) is long enough "
                f"for one {window}-frame training window")
        return cls.from_sequences(
            motions, audios, motion_in, target_len, target_shift, audio_in,
            batch_size, device=device, mesh=mesh,
            shard_over_data=shard_over_data)

    @classmethod
    def from_sequences(cls, motions: Sequence[np.ndarray],
                       audios: Sequence[np.ndarray], motion_input_len: int,
                       target_len: int, target_shift: int,
                       audio_input_len: int, batch_size: int,
                       device: torch.device | str = "cuda", mesh=None,
                       shard_over_data: bool = False) -> "DeviceDataset":
        """The stores of per-sequence arrays (row-aligned motion and audio,
        each at least one window long), `batch_size` the global batch:
        with `mesh` this rank draws ``batch_size / data`` rows, and with
        `shard_over_data` keeps only its data index's share."""
        window = max(motion_input_len, target_shift + target_len,
                     audio_input_len)
        data, index = (mesh.data, mesh.data_index) if mesh else (1, 0)
        if batch_size % data:
            raise ValueError(f"batch_size {batch_size} is not divisible by "
                             f"the data axis size {data}")
        motions, audios = list(motions), list(audios)
        slots = None
        if shard_over_data and data > 1:
            if len(motions) < data:
                raise ValueError(
                    f"shard_over_data needs >= {data} sequences (one per "
                    f"data rank); the corpus has {len(motions)}")
            slots = -(-len(motions) // data)
            motions = motions[index::data]
            audios = audios[index::data]
        lengths = np.asarray([len(m) for m in motions], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        counts = lengths - window + 1
        return cls(np.concatenate(motions), np.concatenate(audios),
                   offsets, counts, motion_input_len, target_len,
                   target_shift, audio_input_len, batch_size // data,
                   device=device, data_index=index,
                   # this rank's sequences cycled to the largest share
                   slots=(None if slots is None
                          else np.arange(slots) % len(lengths)))

    def sample(self, seed: int, step: int) -> Dict[str, torch.Tensor]:
        """One [batch] of training windows, drawn on the device from a
        generator seeded from (`seed`, `step`): the same pair gives the
        same windows.  Traced as ``mint.train.sample``."""
        with profiling.annotate("mint.train.sample"):
            g = self._generator
            g.manual_seed(_draw_seed(seed + self.seed_offset, step))
            a = self.arrays
            b = self.batch_size
            if self._slots is None:
                idx = torch.randint(0, self.n_sequences, (b,), generator=g,
                                    device=self.device)
            else:
                idx = self._slots[torch.randint(
                    0, len(self._slots), (b,), generator=g,
                    device=self.device)]
            u = torch.rand((b,), generator=g, device=self.device)
            cnt = a["counts"][idx]
            start = torch.minimum((u * cnt).long(), cnt - 1)
            pos = a["offsets"][idx] + start
            motion_span = a["motion"][pos[:, None] + self._motion_rows]
            audio = a["audio"][pos[:, None] + self._audio_rows]
            return {
                "motion_input": motion_span[:, :self.motion_input_len],
                "target": motion_span[:, self.target_shift:
                                      self.target_shift + self.target_len],
                "audio_input": audio,
            }

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())
