"""The benchmark's own count of the work of EDGE's DDIM sampler
(``kinds/diffuse.py``), from the configuration's widths alone, with
``work.py``'s rules (each input byte read once, each output byte written
once) and peaks.

A unit is one DDIM step over a dispatch of `chunks` chunks: guidance's
denoiser call over 2 x chunks sequences of seq_len frames, the time
tokens' keys and values and the FiLM vectors, and the update.  The music
memory (the encoder over the conditional chunks, the null branch's rows,
every layer's music keys and values) is computed once a dispatch; it is
counted once a dispatch, spread over its steps.  Ops by the kernel
families that run them: ``projections`` (the library's GEMMs),
``attention``, ``mlp`` (the fused erf MLP), ``layer_norm`` (the
LayerNorms that are no rotation's: the feedforward's, the memory's),
``film`` (the FiLM residuals and the rotations, with the LayerNorms they
fuse).
"""

from __future__ import annotations

from typing import Dict, List

from lib.work import (PEAK_FLOPS, Call, ELEM_BYTES, attention_work,
                      bound_seconds, dense_work, layer_norm_work, mlp_work)

__all__ = ["PEAK_FLOPS", "bound_seconds", "step_calls", "step_flops"]

TIME_TOKENS = 2


def rotary_work(rows, cols, elem, normed_out: bool, norm: bool = True):
    """(flops, bytes) of a rotation of [rows, cols] rows (and the
    LayerNorm before it): x read, the rotated rows written, and the
    normed rows where written; about 6 operations an element, 8 more with
    the LayerNorm.  The (cos, sin) table and the parameters are small."""
    outs = 2 if normed_out else 1
    return ((14.0 if norm else 6.0) * rows * cols,
            elem * rows * cols * (1 + outs))


def film_work(rows, cols, seqs, elem):
    """(flops, bytes) of a FiLM residual: h and a read, the output written,
    a (gamma, beta) row a sequence read; 4 operations an element."""
    return 4.0 * rows * cols, elem * (3 * rows * cols + 2 * seqs * cols)


def _step(g: dict, chunks: int, elem: int) -> List[Call]:
    """One DDIM step's calls: both branches' denoiser call (2 x chunks
    sequences), its time tokens' keys and values and FiLM vectors."""
    e, ff, n = g["latent_dim"], g["ff_size"], g["seq_len"]
    heads, nf = g["num_heads"], g["nfeats"]
    b = 2 * chunks
    rows, d = b * n, e // heads
    m = n + TIME_TOKENS
    calls: List[Call] = [
        ("projections", *dense_work(1, e, 4 * e, elem)),  # time MLP
        ("projections", *dense_work(1, 4 * e, e, elem)),
        ("projections", *dense_work(1, 4 * e, TIME_TOKENS * e, elem)),
        ("layer_norm", *layer_norm_work(TIME_TOKENS, e, elem)),
        ("film", *rotary_work(TIME_TOKENS, e, elem, False, norm=False)),
        ("projections", *dense_work(rows, nf, e, elem)),
        ("projections", *dense_work(rows, e, nf, elem)),
    ]
    for _ in range(g["num_layers"]):
        calls += [
            ("projections", *dense_work(TIME_TOKENS, e, 2 * e, elem)),
            ("projections", *dense_work(b, e, 2 * e, elem)),  # FiLM x 3
            ("projections", *dense_work(b, e, 2 * e, elem)),
            ("projections", *dense_work(b, e, 2 * e, elem)),
            ("film", *rotary_work(rows, e, elem, True)),
            ("projections", *dense_work(rows, e, 2 * e, elem)),  # Q, K
            ("projections", *dense_work(rows, e, e, elem)),  # V
            ("attention", *attention_work(b, heads, n, n, d, elem)),
            ("projections", *dense_work(rows, e, e, elem)),  # out
            ("film", *film_work(rows, e, b, elem)),
            ("film", *rotary_work(rows, e, elem, False)),
            ("projections", *dense_work(rows, e, e, elem)),  # Q
            ("attention", *attention_work(chunks, heads, n, m, d, elem)),
            ("attention", *attention_work(1, heads, chunks * n, m, d, elem)),
            ("projections", *dense_work(rows, e, e, elem)),  # out
            ("film", *film_work(rows, e, b, elem)),
            ("layer_norm", *layer_norm_work(rows, e, elem)),
            ("mlp", *mlp_work(rows, e, ff, e, elem)),
            ("film", *film_work(rows, e, b, elem)),
        ]
    return calls


def _memory(g: dict, chunks: int, elem: int) -> List[Call]:
    """The once-a-dispatch music memory: the conditional chunks through
    the projection and the encoder, c_h, the memory rows of both branches
    (the null branch's one set) and every layer's keys and values."""
    e, ff, n = g["latent_dim"], g["ff_size"], g["seq_len"]
    heads = g["num_heads"]
    rows = chunks * n
    calls: List[Call] = [
        ("projections", *dense_work(rows, g["cond_feature_dim"], e, elem))]
    for _ in range(g["cond_encoder_layers"]):
        calls += [
            ("film", *rotary_work(rows, e, elem, True)),
            ("projections", *dense_work(rows, e, 2 * e, elem)),
            ("projections", *dense_work(rows, e, e, elem)),
            ("attention", *attention_work(chunks, heads, n, n, e // heads,
                                          elem)),
            ("projections", *dense_work(rows, e, e, elem)),
            ("layer_norm", *layer_norm_work(rows, e, elem)),
            ("mlp", *mlp_work(rows, e, ff, e, elem)),
        ]
    calls += [("layer_norm", *layer_norm_work(chunks, e, elem)),
              ("projections", *dense_work(chunks, e, e, elem)),
              ("projections", *dense_work(chunks, e, e, elem)),
              ("layer_norm", *layer_norm_work(rows + n, e, elem)),
              ("film", *rotary_work(rows + n, e, elem, False, norm=False))]
    for _ in range(g["num_layers"]):
        calls += [("projections", *dense_work(rows + n, e, e, elem)),
                  ("projections", *dense_work(rows + n, e, e, elem))]
    return calls


def step_calls(g: dict, chunks: int, steps: int) -> List[Call]:
    """The calls of one unit: a step's, and the dispatch's memory's over
    its `steps` steps."""
    elem = ELEM_BYTES[g["precision"]]
    return _step(g, chunks, elem) + [
        (op, flops / steps, nbytes / steps)
        for op, flops, nbytes in _memory(g, chunks, elem)]


def _matmul_flops(calls: List[Call]) -> float:
    return sum(f for op, f, _ in calls
               if op in ("projections", "attention", "mlp"))


def step_flops(g: dict, chunks: int, steps: int) -> float:
    """Model FLOPs of one unit: every matmul of a step (both branches) and
    the dispatch's music memory over its steps."""
    elem = ELEM_BYTES[g["precision"]]
    return (_matmul_flops(_step(g, chunks, elem))
            + _matmul_flops(_memory(g, chunks, elem)) / steps)


def work_by_op(g: dict, chunks: int, steps: int) -> Dict[str, float]:
    """FLOPs of a unit by op, for the record."""
    out: Dict[str, float] = {}
    for op, flops, _ in step_calls(g, chunks, steps):
        out[op] = out.get(op, 0.0) + flops
    return out
