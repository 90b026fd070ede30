"""EDGE's element-wise FiLM residual and rotary rotation: hand-written CUDA
kernels for bf16 rows and their plain versions.

Both serve ``models/edge.py``'s FiLM-conditioned decoder (Tseng et al.,
EDGE, CVPR 2023; ``model/model.py``'s ``featurewise_affine`` and
``rotary_embedding_torch``'s ``rotate_queries_or_keys``).  They replace no
TPU kernel: the JAX package has no EDGE.  The kernels' source is
``mint_tpu_torch/csrc/film.cu`` (namespace ``mint_film``).

- :func:`film_residual`: ``h + (1 + gamma) * a + beta``, gamma and beta
  one row of a [B, 2C] tensor a sequence of `seq` rows (the FiLM linear's
  output, gamma its first half), in f32, rounded to the rows' dtype once.
- :func:`rotary`: the rows' rotation by their positions ``pos0 + r %
  seq``, interleaved by pairs, its (cos, sin) from :func:`rotary_table`;
  with LayerNorm parameters the rows are LayerNorm'd first (f32
  statistics, rounded, as ``ops.layer_norm``) and the normed rows are
  returned beside their rotation where asked: one kernel where LayerNorm
  and then the rotation would be two passes.

A CPU tensor takes the plain version; a CUDA tensor launches the bf16
kernel, and one in another dtype is refused (EDGE runs bf16 on the card:
``builder.check_edge_limits``).  No gradient is taken through them: EDGE
here generates only.
"""

from __future__ import annotations

import torch

from mint_tpu_torch.ops import _build
from mint_tpu_torch.ops.layer_norm import layer_norm_reference

# Kernel launches made on the card: the FiLM residual, and the rotation
# (with LayerNorm or without).
launches = 0
rotary_launches = 0

ROTARY_BASE = 10000.0
#: The widest row the bf16 rotary kernel holds (csrc/film.cu's kMaxCols).
ROTARY_MAX_COLS = 1024


def rotary_table(positions: int, dim: int, device=None) -> torch.Tensor:
    """(cos, sin) of p * theta_i, [positions, dim / 2, 2] float32, with
    theta_i = base ** (-2 i / dim), as ``rotary_embedding_torch`` computes
    its frequencies (float32 throughout)."""
    inv = 1.0 / (ROTARY_BASE ** (torch.arange(0, dim, 2, device=device)
                                 [:dim // 2].float() / dim))
    freqs = torch.arange(positions, device=device).float()[:, None] * inv
    return torch.stack([freqs.cos(), freqs.sin()], dim=-1).contiguous()


def film_reference(h: torch.Tensor, a: torch.Tensor, gb: torch.Tensor,
                   seq: int) -> torch.Tensor:
    """h + (1 + gamma) * a + beta on [rows, C] rows in f32, rounded to h's
    dtype; gb [rows / seq, 2C], gamma = gb[:, :C], beta = gb[:, C:]."""
    c = h.shape[-1]
    g = gb[:, :c].float().repeat_interleave(seq, dim=0)
    b = gb[:, c:].float().repeat_interleave(seq, dim=0)
    return (h.float() + (1.0 + g) * a.float() + b).to(h.dtype)


def rotary_reference(z: torch.Tensor, table: torch.Tensor, seq: int,
                     pos0: int = 0) -> torch.Tensor:
    """z [rows, C] rotated by position pos0 + r % seq: pairs (2i, 2i + 1)
    by the table's (cos, sin) at i, products and sums in f32, rounded to
    z's dtype."""
    rows, c = z.shape
    pos = pos0 + torch.arange(rows, device=z.device) % seq
    t = table[pos]
    cos, sin = t[..., 0], t[..., 1]
    x = z.float().view(rows, c // 2, 2)
    lo = x[..., 0] * cos + (-x[..., 1]) * sin
    hi = x[..., 1] * cos + x[..., 0] * sin
    return torch.stack([lo, hi], dim=-1).view(rows, c).to(z.dtype)


def film_residual(h: torch.Tensor, a: torch.Tensor, gb: torch.Tensor,
                  seq: int) -> torch.Tensor:
    """FiLM residual of [rows, C] rows h and a, gb [rows / seq, 2C]."""
    if h.device.type == "cpu":
        return film_reference(h, a, gb, seq)
    return _film_launch(h, a, gb, seq)


def rotary(z: torch.Tensor, table: torch.Tensor, seq: int, pos0: int = 0,
           weight: torch.Tensor | None = None,
           bias: torch.Tensor | None = None, eps: float = 1e-5,
           normed: bool = False):
    """z [rows, C] rotated by position (:func:`rotary_reference`); with
    `weight` and `bias` LayerNorm'd first, and with `normed` the pair
    (normed rows, their rotation)."""
    if z.device.type == "cpu":
        n = (layer_norm_reference(z, weight, bias, eps)
             if weight is not None else z)
        r = rotary_reference(n, table, seq, pos0)
        return (n, r) if normed else r
    return _rotary_launch(z, table, seq, pos0, weight, bias, eps, normed)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"film: {what}")


def _film_launch(h, a, gb, seq):
    global launches
    rows, c = h.shape
    h, a = h.contiguous(), a.contiguous()
    _check(h.dtype == a.dtype == gb.dtype == torch.bfloat16
           and a.shape == h.shape and gb.shape == (rows // seq, 2 * c)
           and rows % seq == 0 and c % 8 == 0 and gb.stride(1) == 1
           and gb.stride(0) % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in (h, a, gb))
           and a.device == h.device == gb.device,
           f"the bf16 kernel's 16-byte rows: h {tuple(h.shape)} {h.dtype}, "
           f"a {tuple(a.shape)}, gb {tuple(gb.shape)} "
           f"(stride {gb.stride()}), seq {seq}")
    out = torch.empty_like(h)
    err = _build.library().mint_film_residual_bf16(
        h.data_ptr(), a.data_ptr(), gb.data_ptr(), out.data_ptr(), rows, c,
        seq, gb.stride(0), torch._C._cuda_getCurrentRawStream(
            h.get_device()))
    _build.check(err, "FiLM residual kernel launch")
    launches += 1
    return out


def _rotary_launch(z, table, seq, pos0, weight, bias, eps, normed):
    global rotary_launches
    rows, c = z.shape
    norm = weight is not None
    _check(z.dtype == torch.bfloat16 and table.dtype == torch.float32
           and table.shape[1:] == (c // 2, 2)
           and table.shape[0] >= pos0 + min(seq, rows)
           and (not normed or norm) and (bias is not None) == norm
           and (not norm or weight.dtype == bias.dtype == torch.float32),
           f"z {tuple(z.shape)} {z.dtype}, table {tuple(table.shape)}, "
           f"seq {seq}, pos0 {pos0}")
    z, table = z.contiguous(), table.contiguous()
    out = torch.empty_like(z)
    n = torch.empty_like(z) if normed else None
    err = _build.library().mint_film_rotary_bf16(
        z.data_ptr(), weight.data_ptr() if norm else None,
        bias.data_ptr() if norm else None, table.data_ptr(),
        None if n is None else n.data_ptr(), out.data_ptr(), rows, c, seq,
        pos0, eps, torch._C._cuda_getCurrentRawStream(z.get_device()))
    _build.check(err, "rotary kernel launch")
    rotary_launches += 1
    return (n, out) if normed else out
