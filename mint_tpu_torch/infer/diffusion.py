"""EDGE's long-form DDIM sampler (counterpart of Stanford-TML/EDGE's
``model/diffusion.py``: ``GaussianDiffusion.long_ddim_sample`` with its
cosine schedule and ``DanceDecoder.guided_forward``).

- Schedule: 1000 cosine steps, s = 0.008 (ᾱ from cos² of ((t / 1000 + s)
  / (1 + s)) π / 2, normalised at 0, in float64; β = clip(1 - ᾱ_{t+1} /
  ᾱ_t, 0, 0.999) to float32; ᾱ again as the float32 cumulative product
  of 1 - β).
- Step times int(linspace(-1, 999, 51)) reversed: 999, 979, ..., 19, -1;
  guidance weight min(linspace(0, 2 w, 50)_j, w) at step j (w = 2: EDGE's
  long-form ramp).
- A step from τ to τ': x0 = clamp(D(keep = 0) + w (D(keep = 1) - D(keep =
  0)), -1, 1); ε = (sqrt(1/ᾱ_τ) x - x0) / sqrt(1/ᾱ_τ - 1); at τ' < 0 the
  output is x0; else σ = η sqrt((1 - ᾱ_τ/ᾱ_τ')(1 - ᾱ_τ')/(1 - ᾱ_τ)),
  x = sqrt(ᾱ_τ') x0 + sqrt(1 - ᾱ_τ' - σ²) ε + σ z_j, and within each song
  chunk k >= 1 takes x[k, :seq/2] = x[k - 1, seq/2:] (the values before
  the assignment).

The sampler is a pure function of its inputs: x_T and every z_j are
given.  A dispatch holds the chunks of several songs (any number of chunks
each, `chunks`); a song of K chunks comes back as chunk 0's frames and
then the second half of each later chunk, seq + (K - 1) seq / 2 frames.

One dispatch (:func:`sample`): the music memory once (the encoder, each
layer's music keys and values for the conditional chunks, and the
unconditional branch's once for all of them: ``models/edge.py``'s
``music_memory``), then per DDIM step one step body over static tensors:
guidance as one denoiser call over both branches (2 x chunks sequences),
the DDIM update and the stitch.  On the card the body is a CUDA graph
(``utils/graphs.py``): eager at a key's first step, captured at its
second, replayed for every later step; the key is the chunk count and the
dtype.  The step's scalars (τ, w and the schedule's terms) are rows of a
table on the card, read at a step index there, so every step replays the
one graph.

Recording: ``record`` names (step, chunk) pairs; the state entering that
step, its guided and clipped x0 and the state leaving it (after the
stitch) of that chunk are copied into ``record_out`` [pairs, 3, seq,
nfeats] in every dispatch, timed or not, so a check reads what the timed
path produced (three copies of a chunk a pair, outside the graph).

Tracing: a ``mint.diffuse.memory`` span around the once-a-dispatch memory
and each step's replay a ``mint.diffuse.step`` span
(``utils/profiling.annotate``, under a running profiler only); inside the
step's graph the phase stamps ``begin``, ``forward`` (after the guided
denoiser) and ``update`` (after the update and the stitch).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from mint_tpu_torch.models.edge import EDGE, DispatchMemory
from mint_tpu_torch.utils import graphs, profiling

COSINE_S = 0.008
# The step table's columns (a row a DDIM step).
COLUMNS = ("tau", "weight", "sqrt_recip", "sqrt_recipm1", "sqrt_next",
           "c", "sigma", "last")


def cosine_alphas_cumprod(n_timestep: int) -> torch.Tensor:
    """ᾱ [n_timestep] float32 of EDGE's cosine schedule
    (``make_beta_schedule("cosine")``, then ``cumprod(1 - β)``)."""
    t = (torch.arange(n_timestep + 1, dtype=torch.float64) / n_timestep
         + COSINE_S)
    a = torch.cos(t / (1 + COSINE_S) * math.pi / 2).pow(2)
    a = a / a[0]
    betas = (1 - a[1:] / a[:-1]).clamp(0, 0.999).float()
    return torch.cumprod(1 - betas, dim=0)


def step_times(n_timestep: int, steps: int) -> List[int]:
    """τ of each step and the last τ': 999, 979, ..., 19, -1."""
    times = torch.linspace(-1, n_timestep - 1, steps + 1).int().tolist()
    return list(reversed(times))


def guidance_weights(steps: int, weight: float) -> List[float]:
    """EDGE's long-form ramp: min(linspace(0, 2 w, steps)_j, w)."""
    ramp = torch.linspace(0, 2 * weight, steps, dtype=torch.float64)
    return ramp.clamp(max=weight).tolist()


def step_table(n_timestep: int, steps: int, weight: float,
               eta: float) -> torch.Tensor:
    """[steps, len(COLUMNS)] float32: each step's τ, guidance weight and
    the schedule's terms, computed in float32 as EDGE does."""
    ac = cosine_alphas_cumprod(n_timestep)
    sqrt_recip = torch.sqrt(1.0 / ac)
    sqrt_recipm1 = torch.sqrt(1.0 / ac - 1)
    times = step_times(n_timestep, steps)
    rows = []
    for j, (tau, nxt, w) in enumerate(zip(times[:-1], times[1:],
                                          guidance_weights(steps, weight))):
        if nxt < 0:
            sqrt_next = c = sigma = torch.tensor(0.0)
        else:
            alpha, alpha_next = ac[tau], ac[nxt]
            sigma = eta * ((1 - alpha / alpha_next) * (1 - alpha_next)
                           / (1 - alpha)).sqrt()
            c = (1 - alpha_next - sigma ** 2).sqrt()
            sqrt_next = alpha_next.sqrt()
        rows.append([float(tau), float(w), float(sqrt_recip[tau]),
                     float(sqrt_recipm1[tau]), float(sqrt_next), float(c),
                     float(sigma), float(nxt < 0)])
    return torch.tensor(rows, dtype=torch.float32)


def song_starts(chunks: Sequence[int]) -> List[int]:
    """The first chunk of each song in a dispatch of songs of `chunks`
    chunks each."""
    starts, at = [], 0
    for k in chunks:
        if k < 1:
            raise ValueError(f"a song of {k} chunks")
        starts.append(at)
        at += k
    return starts


def stitch_songs(x: torch.Tensor, chunks: Sequence[int]) -> List[torch.Tensor]:
    """Each song's frames from its chunks' x [total chunks, seq, nfeats]:
    chunk 0 whole, then the second half of each later chunk."""
    half = x.shape[1] // 2
    out = []
    for start, k in zip(song_starts(chunks), chunks):
        out.append(torch.cat([x[start], x[start + 1:start + k, half:]
                              .reshape(-1, x.shape[-1])]))
    return out


class _Loop:
    """A dispatch's static tensors for one key and its step body."""

    def __init__(self, model: EDGE, chunks: int):
        cfg = model.config
        device, dtype = model.device, model.dtype
        shape = (chunks, model.seq_len, model.nfeats)
        self.model = model
        self.steps = cfg.sampling_steps
        self.clip = bool(cfg.clip_denoised)
        self.table = step_table(cfg.n_timestep, cfg.sampling_steps,
                                cfg.guidance_weight, cfg.eta).to(device)
        self.x = torch.empty(shape, device=device)
        self.x0 = torch.empty(shape, device=device)
        self.noise = torch.zeros((self.steps,) + shape, device=device)
        self.first = torch.ones(chunks, dtype=torch.bool, device=device)
        self.index = torch.zeros((), dtype=torch.long, device=device)
        self.slots = torch.zeros(len(profiling.PHASES), dtype=torch.int64,
                                 device=device)
        self.memory = DispatchMemory(model, chunks, dtype, device)

    def load(self, cond, chunks, x_t, noise) -> None:
        """A new dispatch: its state, noise and song layout in, step 0,
        and its music memory."""
        self.x.copy_(x_t)
        self.noise[:self.steps - 1].copy_(noise[:self.steps - 1])
        first = torch.zeros(self.x.shape[0], dtype=torch.bool)
        first[song_starts(chunks)] = True
        self.first.copy_(first)
        self.index.zero_()
        self.model.music_memory(cond.to(self.model.dtype), self.memory)

    def body(self) -> None:
        """One DDIM step: the guided x0, the update and the stitch; the
        step index advanced."""
        profiling.stamp(self.slots, "begin")
        row = self.table.index_select(0, self.index.view(1))[0]
        chunks = self.x.shape[0]
        out = self.model.denoise(self.x, row[0:1], self.memory).float()
        cond, unc = out[:chunks], out[chunks:]
        x0 = unc + (cond - unc) * row[1]
        if self.clip:
            x0 = x0.clamp(-1.0, 1.0)
        profiling.stamp(self.slots, "forward")
        eps = (row[2] * self.x - x0) / row[3]
        z = self.noise.index_select(0, self.index.view(1))[0]
        nxt = x0 * row[4] + row[5] * eps + row[6] * z
        half = nxt.shape[1] // 2
        stitched = nxt.clone()
        stitched[1:, :half] = torch.where(self.first[1:, None, None],
                                          nxt[1:, :half], nxt[:-1, half:])
        self.x0.copy_(x0)
        self.x.copy_(torch.where(row[7] > 0, x0, stitched))
        self.index += 1
        profiling.stamp(self.slots, "update")


def _key(model: EDGE, chunks: int):
    return ("diffuse", chunks, model.dtype)


@torch.inference_mode()
def sample(model: EDGE, cond: torch.Tensor, chunks: Sequence[int],
           x_t: torch.Tensor, noise: torch.Tensor,
           record: Sequence[Tuple[int, int]] = (),
           record_out: Optional[torch.Tensor] = None,
           graphed: Optional[bool] = None) -> List[torch.Tensor]:
    """EDGE's long-form DDIM sample of one dispatch.

    Args:
      model: an :class:`EDGE` on its device, in the dtype to sample in.
      cond: music features of every chunk [total chunks, seq, F], the
        songs' chunks in order.
      chunks: each song's chunk count (their sum: cond's rows).
      x_t: the initial state [total chunks, seq, nfeats].
      noise: z_j of each step but the last [>= steps - 1, total chunks,
        seq, nfeats].
      record, record_out: (step, chunk) pairs and a float32 buffer
        [len(record), 3, seq, nfeats] on the model's device that takes
        each pair's state entering the step, x0 and the state leaving it.
      graphed: replay a CUDA graph per step (default: on a card).

    Returns:
      Each song's frames [seq + (K - 1) seq / 2, nfeats], float32 on the
      model's device.
    """
    total = sum(chunks)
    if cond.shape[0] != total or x_t.shape[0] != total:
        raise ValueError(f"cond {tuple(cond.shape)} and x_T "
                         f"{tuple(x_t.shape)} for songs of {list(chunks)} "
                         "chunks")
    steps = model.config.sampling_steps
    if noise.shape[0] < steps - 1:
        raise ValueError(f"noise for {noise.shape[0]} steps, {steps - 1} "
                         "wanted")
    if record and (record_out is None
                   or record_out.shape[:2] != (len(record), 3)):
        raise ValueError("record_out must be [len(record), 3, seq, "
                         "nfeats]")
    graphed = graphs.enabled(model.device) if graphed is None else graphed
    device = model.device
    cond, x_t, noise = (t.to(device) for t in (cond, x_t, noise))
    if graphed:
        cache = graphs.of(model)
        weights = tuple(p.data_ptr() for p in model.parameters())
        if weights != cache.bound:
            cache.steps.clear()
            cache.bound = weights
        key = _key(model, total)
        if key not in cache.steps:
            loop = _Loop(model, total)
            cache.steps[key] = (loop, graphs.Step(loop.body, cache, key,
                                                  device))
        loop, step = cache.steps[key]
    else:
        loop = _Loop(model, total)
        step = loop.body
    with profiling.annotate("mint.diffuse.memory"):
        loop.load(cond, chunks, x_t, noise)
    by_step = {}
    for i, (j, c) in enumerate(record):
        by_step.setdefault(j, []).append((i, c))
    for j in range(steps):
        for i, c in by_step.get(j, ()):
            record_out[i, 0].copy_(loop.x[c])
        with profiling.annotate("mint.diffuse.step"):
            step()
        for i, c in by_step.get(j, ()):
            record_out[i, 1].copy_(loop.x0[c])
            record_out[i, 2].copy_(loop.x[c])
    return [song.clone() for song in stitch_songs(loop.x, chunks)]


def chunk_music(features: torch.Tensor, seq: int) -> torch.Tensor:
    """A song's music features [T, F] as chunks of `seq` frames, seq / 2
    apart: [K, seq, F] with K = (T - seq) / (seq / 2) + 1 (T is seq plus a
    whole number of half chunks)."""
    half = seq // 2
    if features.shape[0] < seq or (features.shape[0] - seq) % half:
        raise ValueError(f"{features.shape[0]} frames: not {seq} plus whole "
                         f"steps of {half}")
    return features.unfold(0, seq, half).transpose(1, 2).contiguous()
