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

Tensor parallelism (``mesh`` with a model axis over 1,
``parallel/mesh.py``): each rank's ``Attention`` holds its slice of the
heads (``to_qkv``'s rows for them, ``to_out``'s columns) and each rank's
``MLP`` its slice of the hidden width (fc1's rows and bias, fc2's
columns).  The input enters through an identity whose backward
all-reduces over the model group; ``to_out`` and fc2 are row-parallel:
each rank's partial product is summed over the model group in f32 and
the bias, replicated, is added once after the sum, then cast to the
layer's dtype.  The fused MLP kernel adds its b2 inside its reduction, so
a rank passes it none (``ops.mlp.fused_mlp(..., b2=None)``).  In f32 a
sharded layer differs from one device by summation order only; in bf16
each rank's kernel rounds its partial sum to bf16 before the all-reduce,
where one device rounds the whole sum once: up to one bf16 rounding of
each partial more.

Dtype, two ways (``models/builder.py`` picks one):

- **Whole-model cast** (``compute_dtype=None``, the default): the model is
  cast once at build (``module.to(dtype)``), all but the LayerNorms, whose
  weight and bias stay f32 as Flax keeps them under ``dtype=...``.  Dense,
  attention, MLP and the position table compute in their parameters'
  dtype, with no cast per call; LayerNorm computes statistics and affine
  in f32 from its bf16 input and f32 parameters and returns bf16, in one
  launch of ``ops.layer_norm``'s kernel on the card.  The server, the
  decoder and the evaluator use it: in bf16 it gives the forward values of
  Flax's per-call cast, for any LayerNorm parameters (a bf16 copy of
  trained ones would round them: 2^-9 relative, which lands on a small
  output where the bias cancels the normalised term).
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
from mint_tpu_torch.ops import layer_norm as layer_norm_op
from mint_tpu_torch.ops import mlp as mlp_op
from mint_tpu_torch.parallel import mesh as mesh_lib

gelu_tanh = mlp_op.gelu_tanh

#: The activations by name (``mint_tpu/models/layers.py``'s table; GELU
#: is the tanh form), read by ``models/model_utils.get_activation``.
ACTIVATIONS = {
    "gelu": gelu_tanh,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "linear": None,
}


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
    """nn.LayerNorm, epsilon 1e-5, with f32 parameters in either dtype mode
    (``models/builder.py`` keeps them f32 under the whole-model cast), or
    with none (``affine=False``: Flax's ``use_scale=False,
    use_bias=False``, the LayerNorms of a model whose affines are folded
    into the next matmul, ``models/fold.py``).

    A bf16 input, or a ``compute_dtype``, follows Flax's
    ``LayerNorm(dtype=...)``: statistics and the affine in f32 with the f32
    parameters, the output cast to ``compute_dtype`` (or kept in the
    input's dtype).  A bf16 input that stays bf16 goes through
    ``ops.layer_norm``: one kernel launch on the card (the affine-free
    form of the kernel without parameters), its plain version on the CPU.
    An f32 input without a ``compute_dtype`` is one ``layer_norm`` call."""

    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None,
                 affine: bool = True):
        super().__init__(dim, eps=1e-5, elementwise_affine=affine)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.compute_dtype or x.dtype
        if (self.weight is not None
                and x.dtype == out_dtype == self.weight.dtype):
            return super().forward(x)
        if x.dtype == out_dtype == torch.bfloat16:
            return layer_norm_op.layer_norm(x, self.weight, self.bias,
                                            self.eps)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(out_dtype)


def _tensor_parallel(mesh) -> bool:
    return mesh is not None and mesh.model > 1


def _row_parallel_out(partial: torch.Tensor, bias: torch.Tensor,
                      dtype: torch.dtype, mesh) -> torch.Tensor:
    """A row-parallel layer's output: the ranks' partial products summed
    over the model group in f32, the bias added once, cast to `dtype`."""
    total = mesh_lib.reduce_from_model(partial.float(), mesh)
    return (total + bias.float()).to(dtype)


class Attention(nn.Module):
    """Unmasked multi-head self-attention (``layers.py:61-96``).  With a
    model axis in `mesh`, this rank's run of the heads only
    (``mesh_lib.head_split``: ``heads / model`` rounded up on the first
    ``heads % model`` ranks, down on the rest); with more model ranks
    than heads, this rank's run of one head's columns
    (``mesh_lib.head_columns``), the head gathered whole from its group
    before the kernel, which runs the whole head, and this rank's columns
    of the output kept for ``to_out``.  ``qkv_bias`` gives ``to_qkv`` a
    bias, which carries the folded LayerNorm bias of a model with
    ``ln_affine_folded`` (``models/fold.py``)."""

    def __init__(self, dim: int, heads: int = 8,
                 compute_dtype: torch.dtype | None = None, mesh=None,
                 qkv_bias: bool = False):
        super().__init__()
        self.dim = dim
        self.mesh = mesh if _tensor_parallel(mesh) else None
        self.total_heads = heads
        self.head_dim = dim // heads
        self.group = None  # the ranks that share this rank's head
        parts = self.mesh.model if self.mesh else 1
        if parts > heads:  # a run of one head's columns
            index = self.mesh.model_index
            start, stop = mesh_lib.head_columns(heads, self.head_dim,
                                                parts, index)
            self.head_start, self.heads = start // self.head_dim, 1
            self.columns = start % self.head_dim, stop - start
            # Every rank asks (it makes every group); a rank alone on its
            # head gets None and holds the whole head.
            self.group = self.mesh.head_group(heads)
        else:  # this rank's run of whole heads
            self.head_start, self.heads = (
                mesh_lib.head_split(heads, parts, self.mesh.model_index)
                if self.mesh else (0, heads))
            self.columns = 0, self.heads * self.head_dim
        local = self.columns[1]
        self.to_qkv = Dense(dim, 3 * local, bias=qkv_bias,
                            compute_dtype=compute_dtype)
        self.to_out = Dense(local, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, n_queries: int | None = None
                ) -> torch.Tensor:
        """With ``n_queries=q`` only the first q positions attend (keys
        and values still cover every token), returning [b, q, dim]."""
        b, n, _ = x.shape
        scale = self.dim ** -0.5  # full model dim, reference parity
        if self.mesh:
            x = mesh_lib.copy_to_model(x, self.mesh)
        qkv = self.to_qkv(x)
        start, cols = self.columns
        if cols < self.head_dim:  # this rank's columns of its head
            qkv = mesh_lib.gather_head(qkv.reshape(b, n, 3, cols),
                                       self.group, start, self.head_dim)
        qkv = qkv.reshape(b, n, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        nq = n if n_queries is None else min(n_queries, n)
        if nq != n:
            q = q[:, :, :nq]
        out = attention_op.attention(q, k, v, scale)
        out = out.transpose(1, 2).reshape(b, nq, self.heads * self.head_dim)
        if cols < self.head_dim:
            out = out[..., start:start + cols]
        if not self.mesh:
            return self.to_out(out)
        dense = self.to_out
        dt = dense.compute_dtype or dense.weight.dtype
        return _row_parallel_out(F.linear(out.to(dt), dense.weight.to(dt)),
                                 dense.bias, dt, self.mesh)


class MLP(nn.Module):
    """GELU feedforward (``layers.py:99-116``) through ``ops.fused_mlp``.
    With a model axis in `mesh`, this rank's ``hidden_dim / model``
    slice of the hidden width only."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 compute_dtype: torch.dtype | None = None, mesh=None):
        super().__init__()
        self.mesh = mesh if _tensor_parallel(mesh) else None
        parts = self.mesh.model if self.mesh else 1
        if hidden_dim % parts:
            raise ValueError(f"MLP width {hidden_dim} does not split over "
                             f"{parts} model ranks")
        self.fc1 = Dense(in_dim, hidden_dim // parts,
                         compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden_dim // parts, out_dim,
                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Weights enter in the JAX layout [in, out]: .t() of nn.Linear's
        # [out, in] is a view, and the kernel reads that storage as is.
        dt = self.fc1.compute_dtype
        if self.mesh:
            dt = dt or self.fc1.weight.dtype
            x = mesh_lib.copy_to_model(x, self.mesh)
            partial = mlp_op.fused_mlp(
                x.to(dt), self.fc1.weight.to(dt).t(), self.fc1.bias.to(dt),
                self.fc2.weight.to(dt).t(), None)
            return _row_parallel_out(partial, self.fc2.bias, dt, self.mesh)
        if dt is None:
            return mlp_op.fused_mlp(x.to(self.fc1.weight.dtype),
                                    self.fc1.weight.t(), self.fc1.bias,
                                    self.fc2.weight.t(), self.fc2.bias)
        return mlp_op.fused_mlp(x.to(dt), self.fc1.weight.to(dt).t(),
                                self.fc1.bias.to(dt),
                                self.fc2.weight.to(dt).t(),
                                self.fc2.bias.to(dt))


class Block(nn.Module):
    """One pre-LN block: Residual(Norm(Attn)) + Residual(Norm(MLP)).

    With ``ln_affine_folded`` the two LayerNorms carry no scale or bias:
    ``models/fold.py`` moves them into ``to_qkv`` (which then has a bias)
    and fc1, as ``mint_tpu/models/layers.py:119-157`` does."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int,
                 compute_dtype: torch.dtype | None = None, mesh=None,
                 ln_affine_folded: bool = False):
        super().__init__()
        affine = not ln_affine_folded
        self.norm_attn = LayerNorm(hidden_size, compute_dtype, affine)
        self.attn = Attention(hidden_size, num_heads, compute_dtype, mesh,
                              qkv_bias=ln_affine_folded)
        self.norm_mlp = LayerNorm(hidden_size, compute_dtype, affine)
        self.mlp = MLP(hidden_size, intermediate_size, hidden_size,
                       compute_dtype, mesh)

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
                 compute_dtype: torch.dtype | None = None, mesh=None,
                 ln_affine_folded: bool = False):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        for i in range(num_hidden_layers):
            self.add_module(f"block_{i}", Block(
                hidden_size, num_attention_heads, intermediate_size,
                compute_dtype, mesh, ln_affine_folded))

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


class PatchEmbedding(nn.Module):
    """Image patch embedding (``layers.py:188-209``; unused by FACT, part
    of the modality-model surface): [B, H*p, W*p, C] -> [B, H*W, hidden],
    the patches flattened as (p1, p2, c) and projected by
    ``patch_embed_layer``, a Dense whose kernel bridges as [in, out]
    (``models/weights.py``)."""

    def __init__(self, hidden_size: int, patch_size: int, num_channel: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.num_channel = num_channel
        self.patch_embed_layer = Dense(patch_size * patch_size * num_channel,
                                       hidden_size,
                                       compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hp, wp, c = x.shape
        p = self.patch_size
        if c != self.num_channel or hp % p or wp % p:
            raise ValueError(f"input {tuple(x.shape)} is not [B, H*{p}, "
                             f"W*{p}, {self.num_channel}]")
        h, w = hp // p, wp // p
        # b (h p1) (w p2) c -> b (h w) (p1 p2 c)
        x = x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.patch_embed_layer(x.reshape(b, h * w, p * p * c))


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
                 compute_dtype: torch.dtype | None = None, mesh=None,
                 ln_affine_folded: bool = False):
        super().__init__()
        self.output_initializer_range = output_initializer_range
        self.transformer = Transformer(hidden_size, num_hidden_layers,
                                       num_attention_heads,
                                       intermediate_size, compute_dtype,
                                       mesh, ln_affine_folded)
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
