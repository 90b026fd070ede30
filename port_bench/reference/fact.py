"""Plain PyTorch FACT: the benchmark's reference.

Written from the published model (Li et al., "AI Choreographer", ICCV
2021, and google-research/mint's ``fact_model.py`` / ``base_models.py``),
not from the program under test, and importing nothing of it:

- audio and motion encoders: a linear embedding, a learned position table
  added, then pre-LN transformer blocks ``x + Attn(LN(x))``,
  ``x + MLP(LN(x))``; LayerNorm epsilon 1e-5;
- attention: one fused QKV matrix without a bias, its columns ordered
  (q/k/v, head, column), scores scaled by the full hidden size ** -0.5,
  no mask; GELU in its tanh form;
- the cross-modal transformer over the motion tokens followed by the
  audio tokens, then a linear head; the first output row is the next
  frame.

Parameters are a dict of tensors under the checkpoint's names (the
program's ``state_dict`` names, which are its interface), nn.Linear's
[out, in] layout.  Everything runs in float32; ``rnd`` rounds each
matmul's operands to a lower precision where a control asks for it
(``precision.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _stacks(g: dict) -> List[Tuple[str, int]]:
    return [("motion_transformer", g["motion_layers"]),
            ("audio_transformer", g["audio_layers"]),
            ("cross_modal_layer.transformer", g["cross_layers"])]


def param_spec(g: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is ``dense`` (a glorot
    uniform kernel), ``bias``, ``ln_scale``, ``ln_bias``, ``table`` (a
    position table) or ``head`` (the output head's kernel)."""
    h, f = g["hidden_size"], g["intermediate_size"]
    spec = [
        ("motion_linear_embedding.dense.weight", (h, g["motion_dim"]),
         "dense"),
        ("motion_linear_embedding.dense.bias", (h,), "bias"),
        ("motion_pos_embedding.pos_embedding", (g["motion_seq_length"], h),
         "table"),
        ("audio_linear_embedding.dense.weight", (h, g["audio_dim"]),
         "dense"),
        ("audio_linear_embedding.dense.bias", (h,), "bias"),
        ("audio_pos_embedding.pos_embedding", (g["audio_seq_length"], h),
         "table"),
    ]
    for stack, layers in _stacks(g):
        for i in range(layers):
            p = f"{stack}.block_{i}"
            spec += [
                (f"{p}.norm_attn.weight", (h,), "ln_scale"),
                (f"{p}.norm_attn.bias", (h,), "ln_bias"),
                (f"{p}.attn.to_qkv.weight", (3 * h, h), "dense"),
                (f"{p}.attn.to_out.weight", (h, h), "dense"),
                (f"{p}.attn.to_out.bias", (h,), "bias"),
                (f"{p}.norm_mlp.weight", (h,), "ln_scale"),
                (f"{p}.norm_mlp.bias", (h,), "ln_bias"),
                (f"{p}.mlp.fc1.weight", (f, h), "dense"),
                (f"{p}.mlp.fc1.bias", (f,), "bias"),
                (f"{p}.mlp.fc2.weight", (h, f), "dense"),
                (f"{p}.mlp.fc2.bias", (h,), "bias"),
            ]
    spec += [("cross_modal_layer.cross_output_layer.weight",
              (g["out_dim"], h), "head"),
             ("cross_modal_layer.cross_output_layer.bias", (g["out_dim"],),
              "bias")]
    return spec


def _linear(x, w, b, rnd: Round):
    return F.linear(rnd(x), rnd(w), b)


def _block(x: torch.Tensor, p: Params, prefix: str, heads: int,
           q_rows: Optional[int], rnd: Round) -> torch.Tensor:
    b, n, h = x.shape
    d = h // heads
    y = F.layer_norm(x, (h,), p[f"{prefix}.norm_attn.weight"],
                     p[f"{prefix}.norm_attn.bias"], 1e-5)
    qkv = _linear(y, p[f"{prefix}.attn.to_qkv.weight"], None, rnd)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    if q_rows is not None:
        q = q[:, :, :q_rows]
        x = x[:, :q_rows]
    scores = torch.matmul(rnd(q), rnd(k).transpose(-1, -2)) / math.sqrt(h)
    probs = torch.softmax(scores, dim=-1)
    att = torch.matmul(rnd(probs), rnd(v))
    att = att.transpose(1, 2).reshape(b, -1, h)
    x = x + _linear(att, p[f"{prefix}.attn.to_out.weight"],
                    p[f"{prefix}.attn.to_out.bias"], rnd)
    y = F.layer_norm(x, (h,), p[f"{prefix}.norm_mlp.weight"],
                     p[f"{prefix}.norm_mlp.bias"], 1e-5)
    y = F.gelu(_linear(y, p[f"{prefix}.mlp.fc1.weight"],
                       p[f"{prefix}.mlp.fc1.bias"], rnd), approximate="tanh")
    return x + _linear(y, p[f"{prefix}.mlp.fc2.weight"],
                       p[f"{prefix}.mlp.fc2.bias"], rnd)


def _stack(x, p, prefix, layers, heads, rnd, last_rows=None):
    for i in range(layers):
        x = _block(x, p, f"{prefix}.block_{i}", heads,
                   last_rows if i == layers - 1 else None, rnd)
    return x


def forward(p: Params, motion: torch.Tensor, audio: torch.Tensor, g: dict,
            rnd: Round = _same, out_rows: Optional[int] = None
            ) -> torch.Tensor:
    """[B, motion_seq, motion_dim] and [B, audio_seq, audio_dim] ->
    [B, motion_seq + audio_seq, out_dim] (or its first `out_rows`)."""
    heads = g["num_attention_heads"]
    m = _linear(motion, p["motion_linear_embedding.dense.weight"],
                p["motion_linear_embedding.dense.bias"], rnd)
    m = m + p["motion_pos_embedding.pos_embedding"]
    m = _stack(m, p, "motion_transformer", g["motion_layers"], heads, rnd)
    a = _linear(audio, p["audio_linear_embedding.dense.weight"],
                p["audio_linear_embedding.dense.bias"], rnd)
    a = a + p["audio_pos_embedding.pos_embedding"]
    a = _stack(a, p, "audio_transformer", g["audio_layers"], heads, rnd)
    x = _stack(torch.cat([m, a], dim=1), p, "cross_modal_layer.transformer",
               g["cross_layers"], heads, rnd, out_rows)
    return _linear(x, p["cross_modal_layer.cross_output_layer.weight"],
                   p["cross_modal_layer.cross_output_layer.bias"], rnd)


def motion_window(seed: torch.Tensor, frames: torch.Tensor,
                  step: int) -> torch.Tensor:
    """The motion window the autoregressive protocol feeds at `step`: the
    seed's rows from `step` on, then the frames generated before it, the
    last ``len(seed)`` rows of the two.  [motion_seq, dim] each."""
    n = seed.shape[0]
    both = torch.cat([seed, frames[:step].to(seed.dtype)], dim=0)
    return both[step:step + n]


@torch.no_grad()
def next_frames(p: Params, g: dict, seeds: torch.Tensor,
                audios: torch.Tensor, frames: torch.Tensor,
                picks: List[Tuple[int, int]], rnd: Round = _same,
                block: int = 16) -> torch.Tensor:
    """The frame the model gives at each (clip, step) of `picks`, fed the
    protocol's windows built from the seeds and the given `frames`
    ([clips, steps, dim], the ones under test): one forward a pick, in
    blocks of `block`.  Returns [len(picks), out_dim] in float32."""
    out = []
    na = g["audio_seq_length"]
    for at in range(0, len(picks), block):
        chunk = picks[at:at + block]
        m = torch.stack([motion_window(seeds[c], frames[c], t)
                         for c, t in chunk])
        a = torch.stack([audios[c, t:t + na] for c, t in chunk])
        out.append(forward(p, m.float(), a.float(), g, rnd, out_rows=1)[:, 0])
    return torch.cat(out)


# -- training -----------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7  # tf.keras Adam's defaults


def loss_fn(p: Params, batch: Dict[str, torch.Tensor], g: dict,
            rnd: Round = _same, rows: Optional[slice] = None
            ) -> torch.Tensor:
    """Mean square error of the first target_length output frames.
    `rows` keeps a part of the batch (a planted fault only)."""
    motion, audio, target = (batch["motion_input"], batch["audio_input"],
                             batch["target"])
    if rows is not None:
        motion, audio, target = motion[rows], audio[rows], target[rows]
    pred = forward(p, motion, audio, g, rnd)
    return torch.mean(torch.square(target - pred[:, :target.shape[1]]))


def adam_step(p: Params, mu: Params, nu: Params, grads: Params,
              count: int, lr: float) -> None:
    """One Adam update, in place: bias-corrected moments, eps outside the
    square root (``optax.scale_by_adam``), the update scaled by -lr."""
    import numpy as np

    bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(count))
    for k, g in grads.items():
        mu[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu[k].mul_(ADAM_B2).add_(g * g, alpha=1 - ADAM_B2)
        update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        p[k].add_(update, alpha=-lr)


def train_steps(p: Params, batches: List[Dict[str, torch.Tensor]], g: dict,
                lr: float, rnd: Round = _same,
                rows: Optional[slice] = None):
    """Train steps of plain Adam from `p` (updated in place) on each batch.
    Returns the losses, the first step's gradients and the parameters
    after the last step (`p` itself)."""
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    names = list(p)
    for i, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, batch, g, rnd, rows)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        loss = loss.detach()
        grads = dict(zip(names, grads))
        losses.append(loss.item())
        if first is None:
            first = {k: torch.linalg.vector_norm(v).item()
                     for k, v in grads.items()}
        with torch.no_grad():
            adam_step(p, mu, nu, grads, i + 1, lr)
        del grads, leaves
    return losses, first, p
