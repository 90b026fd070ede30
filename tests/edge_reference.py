"""Plain PyTorch EDGE: the reference the port's EDGE is held to.

Written from the published model (Tseng, Castellon and Liu, "EDGE:
Editable Dance Generation From Music", CVPR 2023; github.com/Stanford-TML/
EDGE: ``EDGE.py``, ``model/model.py``'s ``DanceDecoder``,
``model/diffusion.py``'s ``GaussianDiffusion``), importing nothing of the
program under test.  Everything runs in float32 with TF32 off; ``rnd``
rounds each matmul's operands to a lower precision where a control asks
for it, and ``rnd_state`` the DDIM update's operands.

The denoiser, for chunks x [b, seq, nfeats], music features [b, seq, F],
timesteps [b] and keep [b]:

- h = x W_in + b_in; music tokens u = the projected features through the
  encoder layers (pre-LN: y + SA(LN y), y + FF(LN y)), or the learned
  ``null_cond_embed`` where keep = 0;
- c_h = W_b SiLU(W_a LN(mean(u)) + b_a) + b_b, or ``null_cond_hidden``;
- s(t) = [sin(t w_i), cos(t w_i)], w_i = exp(-i ln 10000 / (E/2 - 1));
  t_h = Mish(s W_1 + b_1); f = t_h W_2 + b_2 + c_h; two time tokens
  t_h W_3 + b_3;
- memory M = LN_c(concat(u, time tokens));
- each decoder layer: h + (1 + g_k) * Sub_k(LN_k h) + b_k, (g_k, b_k) =
  split(Mish(f) W_Fk + b_Fk), over self-attention, cross-attention to M
  and the feedforward;
- attention: ``nn.MultiheadAttention`` (in-projections with biases, an
  output projection), scores scaled by head_dim ** -0.5, no mask;
  SA(z) = MHA(R(z), R(z), z), CA(z, M) = MHA(R(z), R(M), M), R the rotary
  rotation interleaved by pairs over all E channels, positions 0..n-1 of
  the rows it turns, frequencies 10000 ** (-2i / E);
- FF(z) = GELU_erf(z W_1 + b_1) W_2 + b_2; LayerNorm eps 1e-5;
- x0 = h W_out + b_out.

The sampler: EDGE's cosine schedule over n_timestep steps (s = 0.008),
DDIM over int(linspace(-1, n_timestep - 1, steps + 1)) reversed, guidance
weight min(linspace(0, 2 w, steps)_j, w), x0 = clamp(D(keep 0) + w (D(keep
1) - D(keep 0)), -1, 1), ε = (sqrt(1/ᾱ) x - x0) / sqrt(1/ᾱ - 1), the next
state sqrt(ᾱ') x0 + sqrt(1 - ᾱ' - σ²) ε + σ z (x0 itself after the last
step), then within each song chunk k >= 1 takes the second half of chunk
k - 1 as its first half (not after the last step).  A song of K chunks is
chunk 0 and the second half of each later chunk.

Departures from EDGE's code, none of which changes a value it computes:

- the encoder and the memory are recomputed for every call, as EDGE does
  (the program caches them; its tests hold the cached form to this);
- x_T and every step's z are inputs, where EDGE draws them inside;
- guidance evaluates both branches of a chunk together (EDGE: two calls);
- the schedule's terms are computed from ᾱ in float32 as EDGE's buffers
  are, and guidance's weights in float64 as ``np.linspace`` gives them;
- dropout is off (generation); no classifier-free dropout draw: keep is
  given.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]
TIME_TOKENS = 2


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_spec(g: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter, under the published module
    names; kind is ``dense`` (a glorot-uniform matrix), ``bias``,
    ``ln_scale``, ``ln_bias`` or ``embed`` (the null condition's
    embeddings, standard normal in EDGE)."""
    e, ff, f = g["latent_dim"], g["ff_size"], g["cond_feature_dim"]
    n, nf = g["seq_len"], g["nfeats"]

    def linear(name, out, inp):
        return [(f"{name}.weight", (out, inp), "dense"),
                (f"{name}.bias", (out,), "bias")]

    def norm(name):
        return [(f"{name}.weight", (e,), "ln_scale"),
                (f"{name}.bias", (e,), "ln_bias")]

    def mha(name):
        return [(f"{name}.in_proj_weight", (3 * e, e), "dense"),
                (f"{name}.in_proj_bias", (3 * e,), "bias"),
                *linear(f"{name}.out_proj", e, e)]

    spec = linear("input_projection", e, nf) + linear("cond_projection", e, f)
    for i in range(g["cond_encoder_layers"]):
        p = f"cond_encoder.{i}"
        spec += (mha(f"{p}.self_attn") + linear(f"{p}.linear1", ff, e)
                 + linear(f"{p}.linear2", e, ff) + norm(f"{p}.norm1")
                 + norm(f"{p}.norm2"))
    spec += [("null_cond_embed", (1, n, e), "embed"),
             ("null_cond_hidden", (1, e), "embed")]
    spec += norm("norm_cond") + norm("non_attn_cond_projection.0")
    spec += (linear("non_attn_cond_projection.1", e, e)
             + linear("non_attn_cond_projection.3", e, e)
             + linear("time_mlp.1", 4 * e, e)
             + linear("to_time_cond.0", e, 4 * e)
             + linear("to_time_tokens.0", TIME_TOKENS * e, 4 * e))
    for i in range(g["num_layers"]):
        p = f"seqTransDecoder.stack.{i}"
        spec += (mha(f"{p}.self_attn") + mha(f"{p}.multihead_attn")
                 + linear(f"{p}.linear1", ff, e) + linear(f"{p}.linear2", e, ff)
                 + norm(f"{p}.norm1") + norm(f"{p}.norm2") + norm(f"{p}.norm3"))
        for k in (1, 2, 3):
            spec += linear(f"{p}.film{k}.block.1", 2 * e, e)
    return spec + linear("final_layer", nf, e)


# -- the denoiser -------------------------------------------------------

def _linear(x, p: Params, name: str, rnd: Round):
    return F.linear(rnd(x), rnd(p[f"{name}.weight"]), p[f"{name}.bias"])


def _norm(x, p: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-5)


def rotate(x: torch.Tensor) -> torch.Tensor:
    """The rotary rotation of x [..., n, E] by positions 0..n-1
    (``rotary_embedding_torch``: interleaved pairs, rotate_half)."""
    n, e = x.shape[-2:]
    inv = 1.0 / (10000.0 ** (torch.arange(0, e, 2, device=x.device)
                             [:e // 2].float() / e))
    freqs = (torch.arange(n, device=x.device).float()[:, None]
             * inv).repeat_interleave(2, dim=-1)
    pairs = x.unflatten(-1, (e // 2, 2))
    half = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * freqs.cos() + half * freqs.sin()


def _mha(q_in, k_in, v_in, p: Params, name: str, heads: int, rnd: Round):
    e = q_in.shape[-1]
    w, b = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    q, k, v = (F.linear(rnd(t), rnd(w[i * e:(i + 1) * e]),
                        b[i * e:(i + 1) * e])
               for i, t in enumerate((q_in, k_in, v_in)))
    d = e // heads

    def split(t):
        return t.unflatten(-1, (heads, d)).transpose(-3, -2)
    scores = torch.matmul(rnd(split(q)), rnd(split(k)).transpose(-1, -2))
    probs = torch.softmax(scores * d ** -0.5, dim=-1)
    out = torch.matmul(rnd(probs), rnd(split(v))).transpose(-3, -2)
    return _linear(out.flatten(-2), p, f"{name}.out_proj", rnd)


def _ff(x, p: Params, name: str, rnd: Round):
    return _linear(F.gelu(_linear(x, p, f"{name}.linear1", rnd)), p,
                   f"{name}.linear2", rnd)


def denoise(p: Params, x: torch.Tensor, cond: torch.Tensor,
            times: torch.Tensor, keep: torch.Tensor, g: dict,
            rnd: Round = _same) -> torch.Tensor:
    """x0 [b, seq, nfeats] of noisy chunks x at timesteps `times` [b],
    music features `cond` [b, seq, F], `keep` [b] bool."""
    _exact()
    heads, e = g["num_heads"], g["latent_dim"]
    y = _linear(cond, p, "cond_projection", rnd)
    for i in range(g["cond_encoder_layers"]):
        pre = f"cond_encoder.{i}"
        z = _norm(y, p, f"{pre}.norm1")
        y = y + _mha(rotate(z), rotate(z), z, p, f"{pre}.self_attn", heads,
                     rnd)
        y = y + _ff(_norm(y, p, f"{pre}.norm2"), p, pre, rnd)
    u = torch.where(keep[:, None, None], y, p["null_cond_embed"])
    c = _norm(u.mean(dim=1), p, "non_attn_cond_projection.0")
    c = _linear(F.silu(_linear(c, p, "non_attn_cond_projection.1", rnd)),
                p, "non_attn_cond_projection.3", rnd)
    c = torch.where(keep[:, None], c, p["null_cond_hidden"])
    half = e // 2
    w = torch.exp(torch.arange(half, device=x.device)
                  * -(math.log(10000) / (half - 1)))
    s = times.float()[:, None] * w[None, :]
    t_h = F.mish(_linear(torch.cat([s.sin(), s.cos()], dim=-1), p,
                         "time_mlp.1", rnd))
    f = _linear(t_h, p, "to_time_cond.0", rnd) + c
    tokens = _linear(t_h, p, "to_time_tokens.0", rnd).unflatten(
        -1, (TIME_TOKENS, e))
    memory = _norm(torch.cat([u, tokens], dim=1), p, "norm_cond")
    h = _linear(x, p, "input_projection", rnd)
    mf = F.mish(f)
    for i in range(g["num_layers"]):
        pre = f"seqTransDecoder.stack.{i}"
        films = [_linear(mf, p, f"{pre}.film{k}.block.1", rnd)
                 .unflatten(-1, (2, e))[:, None] for k in (1, 2, 3)]
        z = _norm(h, p, f"{pre}.norm1")
        a = _mha(rotate(z), rotate(z), z, p, f"{pre}.self_attn", heads, rnd)
        h = h + (1 + films[0][..., 0, :]) * a + films[0][..., 1, :]
        z = _norm(h, p, f"{pre}.norm2")
        a = _mha(rotate(z), rotate(memory), memory, p,
                 f"{pre}.multihead_attn", heads, rnd)
        h = h + (1 + films[1][..., 0, :]) * a + films[1][..., 1, :]
        a = _ff(_norm(h, p, f"{pre}.norm3"), p, pre, rnd)
        h = h + (1 + films[2][..., 0, :]) * a + films[2][..., 1, :]
    return _linear(h, p, "final_layer", rnd)


def guided(p: Params, x: torch.Tensor, cond: torch.Tensor, tau: int,
           weight: float, g: dict, rnd: Round = _same) -> torch.Tensor:
    """The guided and (where the config clips) clamped x0 of chunks x at
    timestep tau: D(keep 0) + weight (D(keep 1) - D(keep 0))."""
    b = x.shape[0]
    times = torch.full((2 * b,), tau, device=x.device)
    keep = torch.arange(2 * b, device=x.device) < b
    out = denoise(p, torch.cat([x, x]), torch.cat([cond, cond]), times, keep,
                  g, rnd)
    x0 = out[b:] + (out[:b] - out[b:]) * weight
    return x0.clamp(-1.0, 1.0) if g["clip_denoised"] else x0


# -- the sampler --------------------------------------------------------

def alphas_cumprod(n_timestep: int) -> torch.Tensor:
    t = (torch.arange(n_timestep + 1, dtype=torch.float64) / n_timestep
         + 0.008)
    a = torch.cos(t / 1.008 * math.pi / 2) ** 2
    betas = torch.clamp(1 - (a / a[0])[1:] / (a / a[0])[:-1], 0, 0.999)
    return torch.cumprod(1 - betas.float(), dim=0)


def schedule(g: dict) -> List[Tuple[int, int, float]]:
    """(tau, tau', guidance weight) of each step."""
    n, steps, w = g["n_timestep"], g["sampling_steps"], g["guidance_weight"]
    times = list(reversed(torch.linspace(-1, n - 1, steps + 1).int()
                          .tolist()))
    weights = torch.clamp(torch.linspace(0, 2 * w, steps,
                                         dtype=torch.float64), max=w)
    return list(zip(times[:-1], times[1:], weights.tolist()))


def ddim_update(x: torch.Tensor, x0: torch.Tensor, z: torch.Tensor,
                tau: int, tau_next: int, g: dict,
                rnd_state: Round = _same) -> torch.Tensor:
    """The state after a step from tau to tau' of state x with x0, before
    the stitch: x0 itself where tau' < 0."""
    if tau_next < 0:
        return x0
    x, x0, z = rnd_state(x), rnd_state(x0), rnd_state(z)
    ac = alphas_cumprod(g["n_timestep"]).to(x.device)
    a, a_next = ac[tau], ac[tau_next]
    eps = (torch.sqrt(1.0 / ac)[tau] * x - x0) / torch.sqrt(1.0 / ac - 1)[tau]
    sigma = g["eta"] * ((1 - a / a_next) * (1 - a_next) / (1 - a)).sqrt()
    c = (1 - a_next - sigma ** 2).sqrt()
    return rnd_state(x0 * a_next.sqrt() + c * eps + sigma * z)


def stitch(x: torch.Tensor, first: Sequence[bool]) -> torch.Tensor:
    """Each chunk k >= 1 that does not start a song takes the second half
    of chunk k - 1 (as it was) as its first half."""
    half = x.shape[1] // 2
    out = x.clone()
    for k in range(1, x.shape[0]):
        if not first[k]:
            out[k, :half] = x[k - 1, half:]
    return out


def firsts(chunks: Sequence[int]) -> List[bool]:
    out = []
    for k in chunks:
        out += [True] + [False] * (k - 1)
    return out


def step(p: Params, x: torch.Tensor, cond: torch.Tensor,
         chunks: Sequence[int], j: int, z: torch.Tensor, g: dict,
         rnd: Round = _same) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step j of the sampler from state x: (x0, the next state after the
    stitch)."""
    tau, tau_next, w = schedule(g)[j]
    x0 = guided(p, x, cond, tau, w, g, rnd)
    nxt = ddim_update(x, x0, z, tau, tau_next, g)
    return x0, nxt if tau_next < 0 else stitch(nxt, firsts(chunks))


def sample(p: Params, cond: torch.Tensor, chunks: Sequence[int],
           x_t: torch.Tensor, noise: torch.Tensor, g: dict,
           rnd: Round = _same) -> List[torch.Tensor]:
    """Each song's frames [seq + (K - 1) seq / 2, nfeats] from x_T and the
    steps' noise."""
    x = x_t
    for j in range(g["sampling_steps"]):
        z = noise[j] if j < noise.shape[0] else torch.zeros_like(x)
        _, x = step(p, x, cond, chunks, j, z, g, rnd)
    half = x.shape[1] // 2
    songs, at = [], 0
    for k in chunks:
        songs.append(torch.cat([x[at]] + [x[i, half:]
                                         for i in range(at + 1, at + k)]))
        at += k
    return songs
