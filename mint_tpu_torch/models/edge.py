"""EDGE's denoiser, in PyTorch (generation only).

Tseng, Castellon and Liu, "EDGE: Editable Dance Generation From Music",
CVPR 2023; github.com/Stanford-TML/EDGE, ``model/model.py``'s
``DanceDecoder`` as ``EDGE.py`` builds it.  The parameters carry the
published module names (``input_projection``, ``cond_encoder.<i>``,
``seqTransDecoder.stack.<i>.film1.block.1``, ...), so a published
checkpoint's ``model.`` entries load by name.  The JAX package has no
EDGE: the port holds it to ``tests/edge_reference.py``.

For one chunk of `seq_len` frames (x [seq_len, nfeats] noisy motion, m
[seq_len, cond_feature_dim] music features, a timestep, keep = whether the
music is kept):

1. h = x W_in + b_in;
2. music tokens u: m's projection through `cond_encoder_layers` pre-LN
   encoder layers (y + SA(LN y), y + FF(LN y)), or, where keep = 0, the
   learned ``null_cond_embed``;
3. c_h = W_b SiLU(W_a LN(mean(u)) + b_a) + b_b, or ``null_cond_hidden``;
4. t_h = Mish(s(t) W_1 + b_1) from the sinusoidal embedding s;
   f = t_h W_2 + b_2 + c_h; two time tokens t_h W_3 + b_3;
5. memory M = LN_c(concat(u, time tokens)), seq_len + 2 rows;
6. each decoder layer: h + (1 + g_k) * Sub_k(LN_k h) + b_k for its
   self-attention, cross-attention to M and feedforward, (g_k, b_k) =
   split(Mish(f) W_Fk + b_Fk);
7. x0 = h W_out + b_out.

The hazards, beside FACT's (pinned by ``tests/test_torch_edge.py``):
attention is ``nn.MultiheadAttention``'s (in-projections with biases, an
output projection, 8 heads of 64) scaled by head_dim ** -0.5 = 0.125, not
FACT's hidden ** -0.5; GELU is the erf form; the rotary rotation
(``ops.film.rotary``) turns the LayerNorm'd rows (and the memory) before
the Q and K projections, never V or the output; FiLM scales by (1 + g).

On the card every kernel is the port's: attention ``ops.attention`` (the
bf16 head-64 instance), the feedforward ``ops.mlp.fused_mlp(...,
activation="erf")``, LayerNorm ``ops.layer_norm``, and the FiLM residual
and the rotation (fused with the LayerNorm before it) ``ops.film``; the
projections are the library's GEMMs.  On the CPU each runs its plain
version.

The sampler's form (``infer/diffusion.py``): :meth:`EDGE.music_memory`
computes once a dispatch what every DDIM step shares (the music tokens,
their condition vectors and every cross-attention layer's music keys and
values; the unconditional branch's memory is the learned null embedding,
computed once for every chunk and attended as one key set by all of
them), and :meth:`EDGE.denoise` a step's x0 of both branches, computing
only the two time tokens' keys and values (one timestep a step) and the
FiLM vectors.  EDGE's published forward recomputes all of it every call;
``tests/test_torch_edge.py`` holds this form to that one
(``tests/edge_reference.py``).  ``kv_projections`` counts the
cross-attention key/value projections (a layer's music memory, or a
step's time tokens, each one), carried through graph replays.
"""

from __future__ import annotations

import math
import sys
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mint_tpu_torch.config.schema import EDGEModelConfig
from mint_tpu_torch.models.layers import Dense, LayerNorm
from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import film as film_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.utils import graphs

#: Cross-attention key/value projections run (a layer's music memory, or a
#: step's two time tokens, each one).
kv_projections = 0

TIME_TOKENS = 2


graphs.register_counter("edge_kv_projections", sys.modules[__name__],
                        "kv_projections")


def sinusoidal(times: torch.Tensor, dim: int) -> torch.Tensor:
    """EDGE's ``SinusoidalPosEmb``: [sin(t w_i), cos(t w_i)], w_i =
    exp(-i ln 10000 / (dim / 2 - 1)), in float32; times [B]."""
    half = dim // 2
    w = torch.exp(torch.arange(half, device=times.device)
                  * -(math.log(10000) / (half - 1)))
    emb = times.float()[:, None] * w[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` [3E, E]
    and ``in_proj_bias``: q, k, v; ``out_proj``) over ``ops.attention``,
    unmasked, scaled by head_dim ** -0.5."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.head_dim = dim // heads
        self.scale = self.head_dim ** -0.5
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def project(self, x: torch.Tensor, part: slice) -> torch.Tensor:
        """x's rows through the in-projection's rows `part` (q, k, v
        blocks of E)."""
        w, b = self.in_proj_weight[part], self.in_proj_bias[part]
        return F.linear(x.to(w.dtype), w, b)

    def _heads(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """[b * n, E] rows (any row stride) as [b, heads, n, head_dim]."""
        return t.view(b, -1, self.heads, self.head_dim).transpose(1, 2)

    def self_attend(self, rotated: torch.Tensor, normed: torch.Tensor,
                    b: int) -> torch.Tensor:
        """SA over `b` sequences: Q and K from the rotated rows, V from the
        rows before rotation; returns the output projection [b * n, E]."""
        e = self.dim
        qk = self.project(rotated, slice(0, 2 * e))
        v = self.project(normed, slice(2 * e, 3 * e))
        out = attention_op.attention(self._heads(qk[:, :e], b),
                                     self._heads(qk[:, e:], b),
                                     self._heads(v, b), self.scale)
        return self.out_proj(out.transpose(1, 2).reshape(-1, e))

    def cross_attend(self, rotated: torch.Tensor,
                     groups: Sequence[Tuple[int, torch.Tensor,
                                            torch.Tensor]]) -> torch.Tensor:
        """CA of the rotated rows, Q projected here, against key sets by
        groups of consecutive rows: (rows, k, v), k and v [kb, nk, E] (kb
        key sets, each read by rows / kb consecutive query rows: one set
        shared by every row where kb = 1).  Returns the output projection
        [rows, E]."""
        e = self.dim
        q = self.project(rotated, slice(0, e))
        outs, at = [], 0
        for rows, k, v in groups:
            kb = k.shape[0]
            o = attention_op.attention(self._heads(q[at:at + rows], kb),
                                       k.view(kb, -1, self.heads,
                                              self.head_dim).transpose(1, 2),
                                       v.view(kb, -1, self.heads,
                                              self.head_dim).transpose(1, 2),
                                       self.scale)
            outs.append(o.transpose(1, 2).reshape(rows, e))
            at += rows
        # Each group's projection into its rows of one output.
        w, bias = self.out_proj.weight, self.out_proj.bias
        out = q.new_empty(q.shape[0], e, dtype=w.dtype)
        at = 0
        for o in outs:
            torch.addmm(bias, o.to(w.dtype), w.t(), out=out[at:at + len(o)])
            at += len(o)
        return out

    def memory_kv(self, memory: torch.Tensor, rotated: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keys (from the rotated memory rows) and values (from the rows)
        of memory rows [n, E]."""
        global kv_projections
        kv_projections += 1
        e = self.dim
        return (self.project(rotated, slice(e, 2 * e)),
                self.project(memory, slice(2 * e, 3 * e)))


def feedforward(layer: nn.Module, z: torch.Tensor) -> torch.Tensor:
    """GELU_erf(z W_1 + b_1) W_2 + b_2 of a layer's ``linear1`` and
    ``linear2``, through the fused MLP."""
    w1, w2 = layer.linear1, layer.linear2
    return mlp_op.fused_mlp(z.to(w1.weight.dtype), w1.weight.t(), w1.bias,
                            w2.weight.t(), w2.bias, activation="erf")


class EncoderLayer(nn.Module):
    """EDGE's ``TransformerEncoderLayer`` (``norm_first``, rotary):
    y + SA(LN1 y), then y + FF(LN2 y)."""

    def __init__(self, dim: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.linear1 = Dense(dim, ff)
        self.linear2 = Dense(ff, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, y: torch.Tensor, b: int, table: torch.Tensor
                ) -> torch.Tensor:
        """y [b * n, E] rows of `b` sequences of n tokens."""
        seq = y.shape[0] // b
        n1, r1 = film_op.rotary(y, table, seq, 0, self.norm1.weight,
                                self.norm1.bias, self.norm1.eps, normed=True)
        y = y + self.self_attn.self_attend(r1, n1, b)
        return y + feedforward(self, self.norm2(y))


class DenseFiLM(nn.Module):
    """EDGE's ``DenseFiLM``: ``block`` = Mish, then a linear to 2E (gamma,
    beta); :meth:`FiLMDecoderLayer.forward` takes its linear over Mish(f)
    computed once for the three."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(nn.Mish(), Dense(dim, 2 * dim))


class FiLMDecoderLayer(nn.Module):
    """EDGE's ``FiLMTransformerDecoderLayer`` (``norm_first``, rotary)."""

    def __init__(self, dim: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.multihead_attn = MultiheadAttention(dim, heads)
        self.linear1 = Dense(dim, ff)
        self.linear2 = Dense(ff, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.film1 = DenseFiLM(dim)
        self.film2 = DenseFiLM(dim)
        self.film3 = DenseFiLM(dim)

    def films(self, mish_f: torch.Tensor) -> List[torch.Tensor]:
        """(gamma, beta) rows [B, 2E] of the three FiLMs from Mish(f)."""
        return [film.block[1](mish_f)
                for film in (self.film1, self.film2, self.film3)]

    def forward(self, h: torch.Tensor, b: int, gbs: List[torch.Tensor],
                groups, table: torch.Tensor) -> torch.Tensor:
        """h [b * seq, E]; gbs from :meth:`films`; `groups` the
        cross-attention's key sets (:meth:`MultiheadAttention.
        cross_attend`)."""
        seq = h.shape[0] // b
        n1, r1 = film_op.rotary(h, table, seq, 0, self.norm1.weight,
                                self.norm1.bias, self.norm1.eps, normed=True)
        h = film_op.film_residual(h, self.self_attn.self_attend(r1, n1, b),
                                  gbs[0], seq)
        r2 = film_op.rotary(h, table, seq, 0, self.norm2.weight,
                            self.norm2.bias, self.norm2.eps)
        h = film_op.film_residual(
            h, self.multihead_attn.cross_attend(r2, groups), gbs[1], seq)
        return film_op.film_residual(h, feedforward(self, self.norm3(h)),
                                     gbs[2], seq)


class DecoderLayerStack(nn.Module):
    """EDGE's ``DecoderLayerStack``: the layers under ``stack``."""

    def __init__(self, layers: List[FiLMDecoderLayer]):
        super().__init__()
        self.stack = nn.ModuleList(layers)


class DispatchMemory:
    """What a sampler dispatch computes once (:meth:`EDGE.music_memory`):
    every decoder layer's cross-attention keys and values, music rows
    first, then the two time-token rows that each step rewrites, for the
    conditional chunks ([chunks, seq + 2, E] each) and for the
    unconditional branch (one set, [1, seq + 2, E]); and the condition
    vectors c_h of the conditional chunks and of the null condition."""

    def __init__(self, model: "EDGE", chunks: int, dtype, device):
        e, n = model.latent_dim, model.seq_len + TIME_TOKENS
        layers = len(model.seqTransDecoder.stack)

        def buf(b):
            return [torch.empty(b, n, e, dtype=dtype, device=device)
                    for _ in range(layers)]
        self.chunks = chunks
        self.k_cond, self.v_cond = buf(chunks), buf(chunks)
        self.k_null, self.v_null = buf(1), buf(1)
        self.c_hidden = torch.empty(2 * chunks, e, dtype=dtype,
                                    device=device)

    def groups(self, layer: int, seq: int):
        rows = self.chunks * seq
        return [(rows, self.k_cond[layer], self.v_cond[layer]),
                (rows, self.k_null[layer], self.v_null[layer])]


class EDGE(nn.Module):
    """EDGE's ``DanceDecoder``; construct with an
    :class:`EDGEModelConfig`."""

    def __init__(self, config: EDGEModelConfig):
        super().__init__()
        e, heads, ff = config.latent_dim, config.num_heads, config.ff_size
        if e % heads or e % 2:
            raise ValueError(f"latent_dim {e} over {heads} heads")
        self.config = config
        self.latent_dim, self.seq_len = e, config.seq_len
        self.nfeats = config.nfeats
        self.input_projection = Dense(config.nfeats, e)
        self.cond_projection = Dense(config.cond_feature_dim, e)
        self.cond_encoder = nn.ModuleList(
            [EncoderLayer(e, heads, ff)
             for _ in range(config.cond_encoder_layers)])
        self.null_cond_embed = nn.Parameter(torch.randn(1, config.seq_len, e))
        self.null_cond_hidden = nn.Parameter(torch.randn(1, e))
        self.norm_cond = LayerNorm(e)
        self.non_attn_cond_projection = nn.Sequential(
            LayerNorm(e), Dense(e, e), nn.SiLU(), Dense(e, e))
        self.time_mlp = nn.Sequential(nn.Identity(), Dense(e, 4 * e),
                                      nn.Mish())
        self.to_time_cond = nn.Sequential(Dense(4 * e, e))
        self.to_time_tokens = nn.Sequential(Dense(4 * e, TIME_TOKENS * e))
        self.seqTransDecoder = DecoderLayerStack(
            [FiLMDecoderLayer(e, heads, ff)
             for _ in range(config.num_layers)])
        self.final_layer = Dense(e, config.nfeats)
        self._tables = {}

    @property
    def device(self) -> torch.device:
        return self.final_layer.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_layer.weight.dtype

    def table(self, device) -> torch.Tensor:
        """The rotary (cos, sin) table over the memory's positions,
        float32 whatever the model's dtype (made once a device)."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = film_op.rotary_table(
                self.seq_len + TIME_TOKENS, self.latent_dim, device)
        return self._tables[device]

    def encode_music(self, cond: torch.Tensor) -> torch.Tensor:
        """Music tokens u [b, seq, E] of features [b, seq, F]."""
        b, n, _ = cond.shape
        y = self.cond_projection(cond.reshape(b * n, -1))
        table = self.table(y.device)
        for layer in self.cond_encoder:
            y = layer(y, b, table)
        return y.view(b, n, -1)

    def condition_hidden(self, u: torch.Tensor) -> torch.Tensor:
        """c_h [b, E] of music tokens u [b, seq, E]."""
        return self.non_attn_cond_projection(u.mean(dim=1))

    def time_hidden(self, times: torch.Tensor) -> torch.Tensor:
        """t_h [b, 4E] of timesteps [b]."""
        return self.time_mlp(sinusoidal(times, self.latent_dim))

    def time_tokens(self, t_hidden: torch.Tensor) -> torch.Tensor:
        return self.to_time_tokens(t_hidden).view(t_hidden.shape[0],
                                                  TIME_TOKENS, -1)

    def _decode(self, x: torch.Tensor, f: torch.Tensor, groups_of
                ) -> torch.Tensor:
        """The decoder stack and the output layer: x [b, seq, nfeats]
        noisy motion, f [b, E] the FiLM condition, `groups_of(layer)` the
        cross-attention key sets of each layer."""
        b, n, _ = x.shape
        h = self.input_projection(x.reshape(b * n, -1))
        mish_f = F.mish(f)
        table = self.table(h.device)
        for i, layer in enumerate(self.seqTransDecoder.stack):
            h = layer(h, b, layer.films(mish_f), groups_of(i), table)
        return self.final_layer(h).view(b, n, -1)

    def music_memory(self, cond: torch.Tensor,
                     memory: DispatchMemory) -> None:
        """Once a dispatch: the conditional chunks' music tokens, their c_h
        and every layer's music keys and values (rows :seq of
        ``memory.k_cond``), and the unconditional branch's, from the null
        embedding once for every chunk, written into `memory`."""
        c, n, _ = cond.shape
        e = self.latent_dim
        u = self.encode_music(cond)
        memory.c_hidden[:c] = self.condition_hidden(u)
        memory.c_hidden[c:] = self.null_cond_hidden.to(u.dtype)
        table = self.table(u.device)
        rows_c = self.norm_cond(u.reshape(c * n, e))
        rows_0 = self.norm_cond(self.null_cond_embed.to(u.dtype)
                                .reshape(n, e))
        rot_c = film_op.rotary(rows_c, table, n)
        rot_0 = film_op.rotary(rows_0, table, n)
        for i, layer in enumerate(self.seqTransDecoder.stack):
            attn = layer.multihead_attn
            k, v = attn.memory_kv(torch.cat([rows_c, rows_0]),
                                  torch.cat([rot_c, rot_0]))
            memory.k_cond[i][:, :n] = k[:c * n].view(c, n, e)
            memory.v_cond[i][:, :n] = v[:c * n].view(c, n, e)
            memory.k_null[i][:, :n] = k[c * n:].view(1, n, e)
            memory.v_null[i][:, :n] = v[c * n:].view(1, n, e)

    def denoise(self, x: torch.Tensor, times: torch.Tensor,
                memory: DispatchMemory) -> torch.Tensor:
        """Both branches' x0 [2 chunks, seq, nfeats] of the chunks' state x
        [chunks, seq, nfeats] at one timestep (times [1]): the conditional
        branch first.  Writes the step's time-token keys and values into
        `memory` (rows seq: of every layer's buffers)."""
        n = self.seq_len
        t_hidden = self.time_hidden(times)
        f = self.to_time_cond(t_hidden) + memory.c_hidden
        tokens = self.norm_cond(self.time_tokens(t_hidden)
                                .reshape(TIME_TOKENS, -1))
        rotated = film_op.rotary(tokens, self.table(tokens.device),
                                 TIME_TOKENS, n)
        for i, layer in enumerate(self.seqTransDecoder.stack):
            k, v = layer.multihead_attn.memory_kv(tokens, rotated)
            memory.k_cond[i][:, n:] = k
            memory.v_cond[i][:, n:] = v
            memory.k_null[i][:, n:] = k
            memory.v_null[i][:, n:] = v
        return self._decode(torch.cat([x, x]), f,
                            lambda i: memory.groups(i, n))
