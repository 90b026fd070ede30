"""Transformer building blocks of FACT, in PyTorch.

Counterparts of ``mint_tpu/models/layers.py``, with the same module names,
so the Flax parameter tree maps onto ``state_dict`` keys one to one
(``mint_tpu_torch/models/weights.py``).  Parity contract, as there:

- pre-LN blocks: ``x + Attn(LN(x))`` then ``x + MLP(LN(x))``;
- LayerNorm epsilon 1e-5;
- attention: fused QKV Dense(3*dim, no bias) whose columns are ordered
  (qkv, head, dim), scores scaled by the FULL model dim ** -0.5;
- GELU is the tanh form, not ``nn.GELU()``'s erf;
- the position table is cast to x's dtype before the add.

``Attention`` always goes through ``ops.attention`` and ``MLP`` through
``ops.fused_mlp``: on a CUDA tensor those launch the hand-written kernels,
on a CPU tensor they run the kernels' plain versions.

Dtype, two ways (``models/builder.py`` picks one):

- **Whole-model cast** (``compute_dtype=None``, the default): the model is
  cast once at build (``module.to(dtype)``) and every layer computes in its
  parameters' dtype.  The server and the decoder use it: in bf16 it gives
  the forward values of Flax's per-call cast without a cast per call.
- **``compute_dtype``**, as the JAX package's ``compute_dtype``: the
  parameters stay in their own dtype (f32) and each layer casts on every
  call, at the Flax cast points: ``Dense`` casts its input, kernel and bias
  (``Dense(dtype=...)``), ``LayerNorm`` takes its statistics and affine in
  f32 and casts its output (Flax's ``LayerNorm(dtype=...)``,
  ``mint_tpu/models/layers.py:143-153``), ``PositionEmbedding`` casts its
  table (``:236``).  The trainer uses it: the casts are differentiable, so
  the gradients and Adam's state stay f32 while the kernels see bf16
  operands, as they do in serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mint_tpu_torch.ops import attention as attention_op
from mint_tpu_torch.ops import mlp as mlp_op

gelu_tanh = mlp_op.gelu_tanh


def trunc_normal_(t: torch.Tensor, stddev: float = 0.02,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's ``truncated_normal(stddev, lower=-2, upper=2)``: a standard
    normal truncated to [-2, 2], times `stddev` (no variance correction).
    """
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, stddev, -2 * stddev,
                                     2 * stddev, generator=generator)


class Dense(nn.Linear):
    """nn.Linear with the Keras defaults: glorot-uniform kernel, zero bias.

    The input is cast to the layer's dtype first, as Flax's
    ``Dense(dtype=...)`` does; with a ``compute_dtype`` the kernel and bias
    are cast to it too, on every call.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x.to(self.weight.dtype))
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm, epsilon 1e-5.  With a ``compute_dtype`` it follows
    Flax's ``LayerNorm(dtype=...)``: statistics and the affine in f32 with
    the f32 parameters, the output cast to ``compute_dtype``."""

    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.compute_dtype)


class Attention(nn.Module):
    """Unmasked multi-head self-attention (``layers.py:61-96``)."""

    def __init__(self, dim: int, heads: int = 8,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.to_qkv = Dense(dim, 3 * dim, bias=False,
                            compute_dtype=compute_dtype)
        self.to_out = Dense(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, n_queries: int | None = None
                ) -> torch.Tensor:
        """With ``n_queries=q`` only the first q positions attend (keys
        and values still cover every token), returning [b, q, dim]."""
        b, n, _ = x.shape
        scale = self.dim ** -0.5  # full model dim, reference parity
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads,
                                     self.dim // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        nq = n if n_queries is None else min(n_queries, n)
        if nq != n:
            q = q[:, :, :nq]
        out = attention_op.attention(q, k, v, scale)
        out = out.transpose(1, 2).reshape(b, nq, self.dim)
        return self.to_out(out)


class MLP(nn.Module):
    """GELU feedforward (``layers.py:99-116``) through ``ops.fused_mlp``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden_dim, out_dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Weights enter in the JAX layout [in, out]: .t() of nn.Linear's
        # [out, in] is a view, and the kernel reads that storage as is.
        dt = self.fc1.compute_dtype
        if dt is None:
            return mlp_op.fused_mlp(x.to(self.fc1.weight.dtype),
                                    self.fc1.weight.t(), self.fc1.bias,
                                    self.fc2.weight.t(), self.fc2.bias)
        return mlp_op.fused_mlp(x.to(dt), self.fc1.weight.to(dt).t(),
                                self.fc1.bias.to(dt),
                                self.fc2.weight.to(dt).t(),
                                self.fc2.bias.to(dt))


class Block(nn.Module):
    """One pre-LN block: Residual(Norm(Attn)) + Residual(Norm(MLP))."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.norm_attn = LayerNorm(hidden_size, compute_dtype)
        self.attn = Attention(hidden_size, num_heads, compute_dtype)
        self.norm_mlp = LayerNorm(hidden_size, compute_dtype)
        self.mlp = MLP(hidden_size, intermediate_size, hidden_size,
                       compute_dtype)

    def forward(self, x: torch.Tensor, n_out: int | None = None
                ) -> torch.Tensor:
        """With ``n_out=q`` only the first q output tokens are computed
        (exact: the attention's keys and values still span all of x)."""
        att = self.attn(self.norm_attn(x), n_queries=n_out)
        x = (x if n_out is None else x[:, :n_out]) + att
        return x + self.mlp(self.norm_mlp(x))


class Transformer(nn.Module):
    """Stack of pre-LN blocks named ``block_{i}``."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12,
                 intermediate_size: int = 3072,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        for i in range(num_hidden_layers):
            self.add_module(f"block_{i}", Block(
                hidden_size, num_attention_heads, intermediate_size,
                compute_dtype))

    def forward(self, x: torch.Tensor, last_n_out: int | None = None
                ) -> torch.Tensor:
        """With ``last_n_out=q`` the FINAL block emits only its first q
        tokens (earlier blocks stay full-width: the final block's
        attention reads every token of their output)."""
        for i in range(self.num_hidden_layers):
            last = i == self.num_hidden_layers - 1
            x = getattr(self, f"block_{i}")(
                x, n_out=last_n_out if last else None)
        return x


class LinearEmbedding(nn.Module):
    """Linear input projection (``layers.py:212-220``)."""

    def __init__(self, in_dim: int, dim: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.dense = Dense(in_dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class PositionEmbedding(nn.Module):
    """Additive learned position embedding (``layers.py:223-236``)."""

    def __init__(self, seq_length: int, dim: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.pos_embedding = nn.Parameter(torch.empty(seq_length, dim))
        trunc_normal_(self.pos_embedding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x if self.compute_dtype is None else x.to(self.compute_dtype)
        return x + self.pos_embedding.to(x.dtype)


class CrossModalLayer(nn.Module):
    """Sequence-wise concat -> transformer -> output head
    (``layers.py:239-280``)."""

    def __init__(self, hidden_size: int, num_hidden_layers: int,
                 num_attention_heads: int, intermediate_size: int,
                 out_dim: int, output_initializer_range: float = 0.02,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.output_initializer_range = output_initializer_range
        self.transformer = Transformer(hidden_size, num_hidden_layers,
                                       num_attention_heads,
                                       intermediate_size, compute_dtype)
        self.cross_output_layer = Dense(hidden_size, out_dim,
                                        compute_dtype=compute_dtype)
        trunc_normal_(self.cross_output_layer.weight,
                      output_initializer_range)

    def forward(self, modal_a: torch.Tensor, modal_b: torch.Tensor,
                first_n_out: int | None = None) -> torch.Tensor:
        """With ``first_n_out=q`` only the first q output frames are
        computed (final block and output head truncated to q rows)."""
        if modal_a.shape[-1] != modal_b.shape[-1]:
            raise ValueError(
                "The modal_a hidden size (%d) should be the same with the "
                "modal_b hidden size (%d)"
                % (modal_a.shape[-1], modal_b.shape[-1]))
        merged = torch.cat([modal_a, modal_b], dim=1)
        merged = self.transformer(merged, last_n_out=first_n_out)
        return self.cross_output_layer(merged)
