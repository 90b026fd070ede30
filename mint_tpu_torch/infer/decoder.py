"""Autoregressive sliding-window decoder (counterpart of
``mint_tpu/infer/decoder.py``).

Same protocol as the JAX ``lax.scan`` decoder and the reference's eager
loop (mint/core/fact_model.py:103-132): per generated frame, slide the
audio window by one, run the forward, keep output frame 0, and shift it
into the motion window.  As in JAX:

- the audio and motion linear embeddings are hoisted out of the loop
  (position-independent, so embedding the audio track once is exact);
- the embedded motion window rolls by embedding only the new frame;
- the final cross-modal block computes only ``last_block_rows`` query rows
  (exact: the protocol keeps row 0 and the rows are independent past the
  attention's keys and values).

The loop is the counterpart of ``_decode_scan``'s ``lax.scan``: one step
body over static tensors (:class:`_Loop`): the embedded motion window
[B, motion_seq, hidden], rolled in place; the embedded audio track
[B, steps + audio_seq - 1, hidden]; the step index, a tensor on the
device; and the frames [B, steps, motion_dim].  The body reads its audio
window with a gather at the device index and writes its frame with a copy
at it, both exact copies, so a step's arithmetic is the eager loop's.  On
the CPU the body runs as it is.  On the card it runs as a CUDA graph of
one step (``utils/graphs.py``): eager at its first step, captured at its
second, replayed for every later step, with no Python between the
kernels' launches and nothing waiting for the device.  ``dispatch_chunk``
splits the steps into runs of replays: the same frames either way.

Graphs are cached on the model, one per key (batch, dtype,
``last_block_rows``, the audio track's length, which is steps +
audio_seq - 1): so a model holds at most one graph per padded batch size
and step count it decodes.  The server pads batches to powers of two up
to ``max_batch`` and steps to its ``steps_bucket`` multiples, the
evaluator batches to powers of two up to its cap and steps to its
buckets, so the captures are bounded as the JAX package's compiles are.
The graphs read the model's parameters in place: weights loaded into
them (``load_state_dict``, as the evaluator and the server do) keep the
graphs, while parameters replaced by other tensors drop them, to be
captured anew.

Tracing: each step of the loop is a ``mint.decode.step`` span
(``utils/profiling.annotate``): the host's work a step, under a running
profiler only.  The step's graph holds no stamp: the decode's kernels are
told apart by their names.
"""

from __future__ import annotations

from typing import Dict

import torch

from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.utils import graphs, profiling

# Query rows computed in the FINAL cross-modal block per decode step (the
# JAX decoder's default; exact for any value >= 1).
DECODE_LAST_BLOCK_ROWS = 48


def _forward_from_embedded(model: FACT, motion_emb: torch.Tensor,
                           audio_emb: torch.Tensor,
                           last_block_rows: int) -> torch.Tensor:
    """Forward from linear-embedded inputs (no position table yet), first
    ``last_block_rows`` output rows of the final cross-modal block only."""
    m = model.motion_transformer(model.motion_pos_embedding(motion_emb))
    a = model.audio_transformer(model.audio_pos_embedding(audio_emb))
    return model.cross(m, a, first_n_out=last_block_rows)


class _Loop:
    """The decode's static tensors for one key and its step body."""

    def __init__(self, model: FACT, motion_emb: torch.Tensor,
                 audio_emb: torch.Tensor, steps: int, last_block_rows: int):
        device = motion_emb.device
        self.model = model
        self.last_block_rows = last_block_rows
        self.motion_emb = torch.empty_like(motion_emb)
        self.audio_emb = torch.empty_like(audio_emb)
        self.index = torch.zeros((), dtype=torch.long, device=device)
        self.window = torch.arange(model.audio_seq_length, device=device)
        out_dim = model.cross_modal_layer.cross_output_layer.out_features
        self.frames = torch.empty((motion_emb.shape[0], steps, out_dim),
                                  dtype=model.dtype, device=device)

    def load(self, motion_emb: torch.Tensor, audio_emb: torch.Tensor):
        """A new clip batch: its embedded windows in, step 0."""
        self.motion_emb.copy_(motion_emb)
        self.audio_emb.copy_(audio_emb)
        self.index.zero_()

    def body(self) -> None:
        """One step: frame `index` into the frames, the motion window
        rolled by it, the index advanced."""
        model = self.model
        audio = self.audio_emb.index_select(1, self.window + self.index)
        out = _forward_from_embedded(model, self.motion_emb, audio,
                                     self.last_block_rows)
        frame = out[:, 0:1]  # keep only the first output frame
        self.frames.index_copy_(1, self.index.view(1),
                                frame.to(self.frames.dtype))
        new_emb = model.motion_linear_embedding(frame)
        self.motion_emb.copy_(torch.cat([self.motion_emb[:, 1:], new_emb],
                                        dim=1))
        self.index += 1


def _key(model: FACT, batch: int, steps: int, last_block_rows: int):
    """The key of a decode's graph in the model's cache."""
    return ("decode", batch, model.dtype, last_block_rows,
            steps + model.audio_seq_length - 1)


def captured(model: FACT, batch: int, steps: int,
             last_block_rows: int = DECODE_LAST_BLOCK_ROWS) -> bool:
    """Whether a decode of `batch` clips and `steps` steps on `model` only
    replays its captured graph; always True where decodes run uncaptured
    (the CPU)."""
    if not graphs.enabled(model.device):
        return True
    cache = graphs.of(model)
    if cache.bound != tuple(p.data_ptr() for p in model.parameters()):
        return False  # moved parameters: the next decode captures anew
    entry = cache.steps.get(_key(model, batch, steps, last_block_rows))
    return entry is not None and entry[1].captured


def _as_input(model: FACT, x) -> torch.Tensor:
    return torch.as_tensor(x, device=model.device)


def infer_auto_regressive(model: FACT, inputs: Dict[str, torch.Tensor],
                          steps: int = 1200,
                          dispatch_chunk: int | None = None,
                          last_block_rows: int = DECODE_LAST_BLOCK_ROWS,
                          ) -> torch.Tensor:
    """Batched AR generation (protocol parity with the JAX decoder).

    Args:
      model: a FACT module (its device and dtype are used).
      inputs: ``motion_input`` [B, motion_seq, motion_dim] seed and
        ``audio_input`` [B, T_audio, audio_dim] full-length audio features;
        T_audio >= steps + audio_seq - 1 (clamp with :func:`max_steps`).
      steps: frames to generate.
      dispatch_chunk: run the loop in chunks of at most this many steps
        (0 or None: one chunk).  Same frames either way; kept for parity
        with the JAX decoder's interface.
      last_block_rows: query rows computed in the final cross-modal block.

    Returns:
      [B, steps, motion_dim] generated frames on the model's device, in
      the model's dtype.  On the card the steps replay a CUDA graph.
    """
    return _decode(model, inputs, steps, dispatch_chunk, last_block_rows,
                   graphed=graphs.enabled(model.device))


@torch.inference_mode()
def _decode(model: FACT, inputs: Dict[str, torch.Tensor], steps: int,
            dispatch_chunk: int | None, last_block_rows: int,
            graphed: bool) -> torch.Tensor:
    """:func:`infer_auto_regressive`'s loop, its steps replaying the
    model's cached graph for the key when `graphed`, else running the
    same body uncaptured on fresh static tensors."""
    audio_seq = model.audio_seq_length
    motion_input = _as_input(model, inputs["motion_input"])
    audio_input = _as_input(model, inputs["audio_input"])
    b, t_audio, _ = audio_input.shape
    if t_audio < steps + audio_seq - 1:
        raise ValueError(
            f"audio too short: {t_audio} frames < steps + audio_seq - 1 = "
            f"{steps + audio_seq - 1}; clamp steps with max_steps() first "
            "(the reference breaks out of its Python loop at this point)")
    if dispatch_chunk is not None and dispatch_chunk < 0:
        raise ValueError(f"dispatch_chunk must be positive or None/0 (= one "
                         f"dispatch); got {dispatch_chunk}")
    chunk = dispatch_chunk or steps

    # Hoist the position-independent embeddings out of the loop.
    audio_emb = model.audio_linear_embedding(
        audio_input[:, :steps + audio_seq - 1])
    motion_emb = model.motion_linear_embedding(motion_input)
    if graphed:
        cache = graphs.of(model)
        # A graph reads the parameters where they were at its capture:
        # parameters replaced since (not copied into) drop the graphs.
        weights = tuple(p.data_ptr() for p in model.parameters())
        if weights != cache.bound:
            cache.steps.clear()
            cache.bound = weights
        key = _key(model, b, steps, last_block_rows)
        if key not in cache.steps:
            loop = _Loop(model, motion_emb, audio_emb, steps,
                         last_block_rows)
            cache.steps[key] = (loop, graphs.Step(loop.body, cache, key,
                                                  model.device))
        loop, step = cache.steps[key]
    else:
        loop = _Loop(model, motion_emb, audio_emb, steps, last_block_rows)
        step = loop.body
    loop.load(motion_emb, audio_emb)
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        for _ in range(n):
            with profiling.annotate("mint.decode.step"):
                step()
        done += n
    # The next decode of this key overwrites the static frames.
    return loop.frames.clone() if graphed else loop.frames


def max_steps(model: FACT, audio_len: int, requested: int = 1200) -> int:
    """Frames the reference protocol generates: it breaks when
    ``audio[i : i+audio_seq]`` runs short."""
    return max(0, min(requested, audio_len - model.audio_seq_length + 1))


def quantize_steps(n: int, bucket: int, cap: int | None = None) -> int:
    """Round a generatable length UP to a multiple of `bucket` (the serving
    batcher's length buckets); `cap` bounds the overshoot."""
    q = -(-n // bucket) * bucket
    return min(q, cap) if cap is not None else q


def padded_batch_size(n_real: int, data: int = 1,
                      cap: int | None = None) -> int:
    """Pad a partial batch UP to the next power of two, optionally capped
    at `cap` but never below ``n_real``, then UP to a multiple of `data`
    (the replicas it is split over) so every replica gets as many rows:
    the JAX rule (``mint_tpu/infer/decoder.py:219-235``), whose `mesh`
    gives `data` as its data-axis size."""
    target = 1 << (n_real - 1).bit_length()
    if cap is not None:
        target = min(target, max(cap, n_real))
    return target + (-target) % data


@torch.inference_mode()
def infer_auto_regressive_reference(model: FACT,
                                    inputs: Dict[str, torch.Tensor],
                                    steps: int = 1200) -> torch.Tensor:
    """The reference eager loop: one full forward per frame, no hoisting,
    stopping when the audio window runs short."""
    audio_seq = model.audio_seq_length
    outputs = []
    motion_input = _as_input(model, inputs["motion_input"])
    audio_full = _as_input(model, inputs["audio_input"])
    for i in range(steps):
        audio_input = audio_full[:, i:i + audio_seq]
        if audio_input.shape[1] < audio_seq:
            break
        out = model({"motion_input": motion_input,
                     "audio_input": audio_input})[:, 0:1]
        outputs.append(out)
        motion_input = torch.cat([motion_input[:, 1:].to(out.dtype), out],
                                 dim=1)
    return torch.cat(outputs, dim=1)
