"""Generation evaluator (the port's counterpart of
``mint_tpu/eval/evaluator.py``, the reference SingleTaskEvaluator).

Reference behaviour (``mint/ctl/single_task_evaluator.py:59-97``): per eval
clip, autoregressively generate ``steps`` frames, prepend the 120-frame seed
motion, save the clip as ``{output_dir}/{motion_name}_{audio_name}.npy``,
update the metrics; the pass returns a metric dict.

The reference runs batch-1 and eagerly, one full forward per frame.  Here,
as in the JAX evaluator, clips are BUCKETED BY GENERATABLE LENGTH (the
reference stops when the sliding audio window reaches the end,
fact_model.py:124-126) and each bucket is generated by the port's batched
decoder (``infer/decoder.py``), whose forwards launch the hand-written
attention and fused-MLP kernels on the card: the same protocol, a whole
bucket at a time.  On the card each dispatch's steps replay the decoder's
CUDA graph for its (padded batch, steps) key, captured at the first
dispatch of that key (``infer/decoder.py``); each dispatch's log line
carries the model's graph count.

The JAX evaluator's ``mesh`` is ``devices`` here: one replica of the
parameters a device (``parallel/replicas.py``), each dispatch's rows split
over them and its clips gathered in order; the default decode batch and
the padding scale with the replica count, as they do with the mesh's
data axis there.

``fold_ln`` decodes with the model's LayerNorm affines folded into the
next matmuls (``models/fold.py``), as the JAX evaluator's does: one
folded twin of the model is built once, and each pass copies its folded
weights into the twin's parameters in place, so the twin's decode graphs
stay captured and keep reading live memory.  The replicas are copies of
the twin.

Not carried over from the JAX evaluator: ``decode_unroll`` (an XLA scan
knob), and the ``dispatch_chunk`` and ``decode_rows`` options: in eager
PyTorch a decode split into chunks gives the same frames and saves no
compile, and no caller asked for other rows, so each decode runs whole
with the decoder's defaults.
"""

from __future__ import annotations

import collections
import logging
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models import fold
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.parallel.replicas import Replicas

_log = logging.getLogger(__name__)

#: Clips per decode dispatch by default: the cap that gives the most
#: generated frames per second over the scoring protocol's 40 clips of
#: 1200 steps (docs/BENCHMARKS.md), whose dispatches are the cap's full
#: batches and a remainder padded to a power of two (40 = 32 + 8 here;
#: a cap of 64 would pad 40 to 64).  From the f32 decode sweep of
#: ``chip_smoke.py`` (phase 7) on an NVIDIA H100 80GB HBM3 at a 700.00 W
#: power limit: 436.63, 464.04, 490.58 and 504.66 frames/s at batch 8,
#: 16, 32 and 64, which make 436.63, 458.29, 478.75 and 315.41 generated
#: frames/s over the protocol at a cap of 8, 16, 32 and 64 (PERF.md).
DECODE_BATCH = 32


class Evaluator:
    """Batched AR-generation evaluator on one device or over replicas."""

    def __init__(self, model: FACT, dataset,
                 metrics: Sequence = (), output_dir: Optional[str] = None,
                 steps: int = 1200, decode_batch: Optional[int] = None,
                 steps_bucket: Optional[int] = None,
                 cache_examples: bool = True,
                 devices: Optional[Sequence] = None,
                 fold_ln: bool = False):
        """`model` is a FACT on its device, in the dtype to decode in.

        `dataset` is an iterable of batches, or a zero-argument callable
        returning one (continuous eval runs a pass per checkpoint; the
        reference re-iterates its tf.data.Dataset).  The flattened corpus is
        cached after the first pass when `cache_examples` is True (the eval
        corpus is a fixed file set for a run); pass False to re-read a
        callable or re-iterable dataset every pass, e.g. when eval files
        are appended to during a continuous eval.  A one-shot iterator is
        always cached: a second drain would give an empty corpus.

        `decode_batch` caps the clips of one decode dispatch (default
        :data:`DECODE_BATCH` a device).

        `devices` (default: the model's alone) are the devices to decode
        on, the model's first: a replica of its parameters each, every
        dispatch's clips split over them (the JAX evaluator's `mesh`).

        `steps_bucket` (optional) quantises generatable lengths UPWARD so
        nearby audio lengths share one decode.  Exact: decode frame i reads
        only audio rows [i, i + window), which are real for i < the clip's
        true length; the frames decoded over zero-padded audio are trimmed
        per clip before saving, and the metrics are updated per clip on
        the trimmed output (their ``audio_input`` keeps the padded tail,
        which the reference metric does not read).

        `fold_ln` folds the pre-LN affines into the next QKV and fc1
        kernels for each pass's weights (``models/fold.py``) and decodes
        with the folded twin of `model` (exact up to rounding).  Default
        False, as in the JAX evaluator.
        """
        self.model = model
        self.fold_ln = bool(fold_ln)
        # The model that decodes: with fold_ln its folded twin, built
        # once, whose parameters each pass overwrites in place.
        self._decode_model = (fold.fold_for_decode(model, model.state_dict())
                              [0] if self.fold_ln else model)
        self.replicas = Replicas(self._decode_model,
                                 devices or [model.device])
        self.dataset = dataset
        self.metrics = list(metrics)
        self.output_dir = output_dir
        self.steps = steps
        self.decode_batch = int(DECODE_BATCH * len(self.replicas)
                                if decode_batch is None else decode_batch)
        if self.decode_batch < 1:
            # A negative value would make the bucket loop's range() step
            # backwards: no clip decoded, yet the metrics would "return".
            raise ValueError(
                f"decode_batch must be >= 1, got {self.decode_batch}")
        self.steps_bucket = (int(steps_bucket)
                             if steps_bucket and steps_bucket > 0 else None)
        self.cache_examples = bool(cache_examples)
        self._cache: Optional[List[Dict]] = None

    def _examples(self) -> List[Dict]:
        """Flatten the (possibly batched) dataset into per-clip examples."""
        if self._cache is not None:
            return self._cache
        source = self.dataset() if callable(self.dataset) else self.dataset
        examples = []
        for batch in source:
            motion = np.asarray(batch["motion_input"])
            audio = np.asarray(batch["audio_input"])
            if motion.ndim == 2:  # unbatched example
                motion, audio = motion[None], audio[None]
                names = [(batch.get("motion_name", b"motion"),
                          batch.get("audio_name", b"audio"))]
            else:
                names = list(zip(batch.get("motion_name",
                                           [b"motion"] * len(motion)),
                                 batch.get("audio_name",
                                           [b"audio"] * len(motion))))
            for i in range(len(motion)):
                examples.append({
                    "motion_input": motion[i],
                    "audio_input": audio[i],
                    "motion_name": names[i][0],
                    "audio_name": names[i][1],
                    "target": (np.asarray(batch["target"])[i]
                               if "target" in batch else None),
                })
        # One-shot iterators (iter(x) is x) are always cached; everything
        # re-iterable honours cache_examples.
        one_shot = (not callable(self.dataset)
                    and iter(self.dataset) is self.dataset)
        if self.cache_examples or one_shot:
            self._cache = examples
        return examples

    def evaluate(self, params: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, float]:
        """One full eval pass with `params` (a state dict, e.g. from
        ``CheckpointManager.restore_params``) loaded into the model first,
        or the model's own weights; returns the metric dict."""
        t_pass = time.monotonic()
        if self._decode_model is not self.model:  # fold_ln, not folded
            # Fold first, then place: every replica gets the folded weights.
            params = fold.fold_ln_affines(
                self.model.state_dict() if params is None else params)
        if params is not None:
            self.replicas.load_state_dict(params)
        for metric in self.metrics:
            metric.reset_states()
        if self.output_dir is not None:
            os.makedirs(self.output_dir, exist_ok=True)

        examples = self._examples()
        # Bucket clips by how many frames the reference protocol generates
        # (quantised upward when steps_bucket is set; trimmed per clip).
        buckets = collections.defaultdict(list)
        skipped = []
        for ex in examples:
            n = decoder.max_steps(self.model, ex["audio_input"].shape[0],
                                  self.steps)
            if n > 0:
                ex = dict(ex, true_steps=n)
                key = (n if self.steps_bucket is None
                       else decoder.quantize_steps(n, self.steps_bucket,
                                                   cap=self.steps))
                buckets[key].append(ex)
            else:
                skipped.append(_decode(ex["motion_name"]))
        if skipped:
            _log.warning(
                "skipping %d clip(s) whose audio (< %d frames) cannot "
                "fill one decode window: %s", len(skipped),
                self.model.audio_seq_length, ", ".join(skipped[:10]))

        for n_steps, bucket in sorted(buckets.items()):
            for i in range(0, len(bucket), self.decode_batch):
                self._run_bucket(bucket[i:i + self.decode_batch], n_steps)

        wall = time.monotonic() - t_pass
        frames = sum(ex["true_steps"] for b in buckets.values() for ex in b)
        _log.info("eval pass done: %d clip(s), %d bucket(s), %d frames "
                  "generated in %.3f s wall, %.2f frames/s",
                  len(examples) - len(skipped), len(buckets), frames, wall,
                  frames / wall)
        return {m.name: float(m.result()) for m in self.metrics}

    def _run_bucket(self, bucket: List[Dict], n_steps: int) -> None:
        audio_len = n_steps + self.model.audio_seq_length - 1
        motion = np.stack([np.asarray(ex["motion_input"], np.float32)
                           for ex in bucket])
        # With quantised buckets a clip's audio may be shorter than the
        # bucket's decode horizon: zero-pad the tail.  Exact for the kept
        # frames: frame i < true_steps reads only real audio rows.
        audio = np.stack([
            np.pad(a := np.asarray(ex["audio_input"][:audio_len],
                                   np.float32),
                   [[0, audio_len - a.shape[0]], [0, 0]])
            for ex in bucket])
        n_real = len(bucket)
        # Pad a partial batch UP to the next power of two (capped at
        # decode_batch), then to a multiple of the replicas, repeating the
        # last clip (trimmed below): the serving batcher's rule
        # (decoder.padded_batch_size).
        pad = decoder.padded_batch_size(n_real, data=len(self.replicas),
                                        cap=self.decode_batch) - n_real
        if pad:
            motion = np.concatenate(
                [motion, np.repeat(motion[-1:], pad, axis=0)])
            audio = np.concatenate(
                [audio, np.repeat(audio[-1:], pad, axis=0)])
        t0 = time.monotonic()
        # The copy to the host waits for the card.
        out = self.replicas.decode(
            {"motion_input": motion, "audio_input": audio}, steps=n_steps)
        seconds = time.monotonic() - t0
        # Prepend the seed (single_task_evaluator.py:71); drop pad clips.
        full = np.concatenate([motion, out], axis=1)[:n_real]
        _log.info("decode batch=%d(+%d pad) steps=%d: %.2f s, %.1f frames/s;"
                  " the model's decode graphs so far: %s", n_real, pad,
                  n_steps, seconds, (n_real + pad) * n_steps / seconds,
                  self.replicas.summary())
        motion = motion[:n_real]
        audio = audio[:n_real]

        motion_seq = self.model.motion_seq_length
        if self.output_dir is not None:
            for i, ex in enumerate(bucket):
                name = "%s_%s.npy" % (_decode(ex["motion_name"]),
                                      _decode(ex["audio_name"]))
                # Trim the quantisation overshoot: the seed + the clip's
                # TRUE generatable length (the reference's output).
                np.save(os.path.join(self.output_dir, name),
                        full[i][:motion_seq + ex["true_steps"]])

        if self.metrics:
            # One update per CLIP: the reference evaluates at eval
            # batch_size 1 (configs/...config:119), so the accumulated value
            # is independent of decode batching and bucket composition.
            for i, ex in enumerate(bucket):
                inputs = {"motion_input": motion[i:i + 1],
                          "audio_input": audio[i:i + 1]}
                if ex.get("target") is not None:
                    inputs["target"] = np.stack([ex["target"]])
                for metric in self.metrics:
                    metric.update_state(
                        inputs, full[i:i + 1, :motion_seq + ex["true_steps"]])


def _decode(name) -> str:
    if isinstance(name, bytes):
        return name.decode("utf-8")
    return str(name)
