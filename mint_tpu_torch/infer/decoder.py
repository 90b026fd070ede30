"""Autoregressive sliding-window decoder (counterpart of
``mint_tpu/infer/decoder.py``).

Same protocol as the JAX ``lax.scan`` decoder and the reference's eager
loop (mint/core/fact_model.py:103-132): per generated frame, slide the
audio window by one, run the forward, keep output frame 0, and shift it
into the motion window.  As in JAX:

- the audio and motion linear embeddings are hoisted out of the loop
  (position-independent, so embedding the full audio track once is exact);
- the embedded motion window rolls by embedding only the new frame;
- the final cross-modal block computes only ``last_block_rows`` query rows
  (exact: the protocol keeps row 0 and the rows are independent past the
  attention's keys and values).

The step loop is a Python loop: the generated frames go into a
preallocated device tensor and nothing inside the loop waits for the
device.
"""

from __future__ import annotations

from typing import Dict

import torch

from mint_tpu_torch.models.fact import FACT

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


def _decode_steps(model: FACT, motion_emb: torch.Tensor,
                  audio_emb_full: torch.Tensor, start: int, steps: int,
                  last_block_rows: int, frames: torch.Tensor
                  ) -> torch.Tensor:
    """`steps` decode iterations from audio offset `start`, writing
    frames[:, start + i]; returns the rolled embedded motion window."""
    audio_seq = model.audio_seq_length
    for i in range(start, start + steps):
        out = _forward_from_embedded(model, motion_emb,
                                     audio_emb_full[:, i:i + audio_seq],
                                     last_block_rows)
        frame = out[:, 0:1]  # keep only the first output frame
        frames[:, i] = frame[:, 0]
        new_emb = model.motion_linear_embedding(frame)
        motion_emb = torch.cat([motion_emb[:, 1:], new_emb], dim=1)
    return motion_emb


def _as_input(model: FACT, x) -> torch.Tensor:
    return torch.as_tensor(x, device=model.device)


@torch.inference_mode()
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
      the model's dtype.
    """
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
    audio_emb_full = model.audio_linear_embedding(audio_input)
    motion_emb = model.motion_linear_embedding(motion_input)
    out_dim = model.cross_modal_layer.cross_output_layer.out_features
    frames = torch.empty((b, steps, out_dim), dtype=model.dtype,
                         device=model.device)
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        motion_emb = _decode_steps(model, motion_emb, audio_emb_full, done,
                                   n, last_block_rows, frames)
        done += n
    return frames


def max_steps(model: FACT, audio_len: int, requested: int = 1200) -> int:
    """Frames the reference protocol generates: it breaks when
    ``audio[i : i+audio_seq]`` runs short."""
    return max(0, min(requested, audio_len - model.audio_seq_length + 1))


def quantize_steps(n: int, bucket: int, cap: int | None = None) -> int:
    """Round a generatable length UP to a multiple of `bucket` (the serving
    batcher's length buckets); `cap` bounds the overshoot."""
    q = -(-n // bucket) * bucket
    return min(q, cap) if cap is not None else q


def padded_batch_size(n_real: int, cap: int | None = None) -> int:
    """Pad a partial batch UP to the next power of two, optionally capped
    at `cap` but never below ``n_real`` (the JAX rule without a mesh)."""
    target = 1 << (n_real - 1).bit_length()
    if cap is not None:
        target = min(target, max(cap, n_real))
    return target


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
