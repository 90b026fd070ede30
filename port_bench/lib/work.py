"""The benchmark's own count of the work a FACT step needs.

The peaks, ``bound``, ``attention_work`` and ``mlp_work`` are copied from
``chip_smoke.py`` (each input byte read once, each output byte written
once).  ``dense_work`` and ``layer_norm_work`` follow the same rule.  The
call lists below give each op's calls in one decode step or one training
forward at their logical shapes, from the configuration and the cell; no
kernel's work is read from the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 on
# the tensor cores, f32 on the FMA pipes (the f32 kernels' exact-f32
# route), TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4}


def bound(flops: float, nbytes: float, peak: str):
    """Least time (ms) the card could take: the larger of the flops over
    the peak rate and the bytes (each input read once, each output
    written once) over HBM's rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def attention_work(b, h, nq, nk, d, elem):
    """(flops, bytes) of attention: Q.K^T and P.V, q/k/v in, out out."""
    return 4.0 * b * h * nq * nk * d, elem * b * h * d * (2 * nq + 2 * nk)


def mlp_work(m, h, f, o, elem):
    """(flops, bytes) of the fused MLP: x, W1, b1, W2, b2 in, out out."""
    return (2.0 * m * (h * f + f * o),
            elem * (m * h + h * f + f + f * o + o + m * o))


def dense_work(m, k, n, elem, bias=True):
    """(flops, bytes) of a dense layer: x [m, k], W [k, n] and the bias
    in, [m, n] out."""
    return 2.0 * m * k * n, elem * (m * k + k * n + (n if bias else 0)
                                    + m * n)


def layer_norm_work(rows, cols, elem, param_elem=4):
    """(flops, bytes) of a LayerNorm with a scale and a bias: about 8
    operations an element (``chip_smoke.py``'s count); x read and the
    output written in `elem` bytes, scale and bias in `param_elem`."""
    return 8.0 * rows * cols, (2 * elem * rows * cols
                               + 2 * param_elem * cols)


Call = Tuple[str, float, float]  # (op, flops, bytes)


def _block(calls: List[Call], b: int, n: int, q: int, g: dict,
           elem: int, ln_elem: int) -> None:
    """One pre-LN block over `n` tokens of `b` clips, `q` query rows."""
    h, heads, f = g["hidden_size"], g["num_attention_heads"], \
        g["intermediate_size"]
    calls.append(("layer_norm", *layer_norm_work(b * n, h, ln_elem)))
    calls.append(("projections", *dense_work(b * n, h, 3 * h, elem,
                                             bias=False)))
    calls.append(("attention", *attention_work(b, heads, q, n, h // heads,
                                               elem)))
    calls.append(("projections", *dense_work(b * q, h, h, elem)))
    calls.append(("layer_norm", *layer_norm_work(b * q, h, ln_elem)))
    calls.append(("mlp", *mlp_work(b * q, h, f, h, elem)))


def decode_step_calls(g: dict, batch: int) -> List[Call]:
    """The calls of one decode step of `batch` clips: the new frame's
    embedding, the motion and audio encoders over their windows, the
    cross-modal blocks over both, the last with the one query row a clip
    that the step keeps, and the output head over that row (as
    :func:`decode_step_flops` counts it: rows the program computes past
    it are its own cost).  The audio track's embedding is made once a
    dispatch and is not counted."""
    elem = ELEM_BYTES[g["precision"]]
    calls: List[Call] = []
    calls.append(("projections", *dense_work(batch, g["motion_dim"],
                                             g["hidden_size"], elem)))
    nm, na = g["motion_seq_length"], g["audio_seq_length"]
    for n, layers in ((nm, g["motion_layers"]), (na, g["audio_layers"])):
        for _ in range(layers):
            _block(calls, batch, n, n, g, elem, elem)
    n = nm + na
    for i in range(g["cross_layers"]):
        last = i == g["cross_layers"] - 1
        _block(calls, batch, n, 1 if last else n, g, elem, elem)
    calls.append(("projections", *dense_work(batch, g["hidden_size"],
                                             g["out_dim"], elem)))
    return calls


def train_forward_calls(g: dict, batch: int) -> List[Call]:
    """The calls of one training forward of `batch` samples, in the
    compute precision (bf16 compute casts the f32 parameters)."""
    elem = ELEM_BYTES[g["precision"]]
    calls: List[Call] = []
    nm, na = g["motion_seq_length"], g["audio_seq_length"]
    h = g["hidden_size"]
    calls.append(("projections", *dense_work(batch * nm, g["motion_dim"], h,
                                             elem)))
    calls.append(("projections", *dense_work(batch * na, g["audio_dim"], h,
                                             elem)))
    for n, layers in ((nm, g["motion_layers"]), (na, g["audio_layers"]),
                      (nm + na, g["cross_layers"])):
        for _ in range(layers):
            _block(calls, batch, n, n, g, elem, elem)
    calls.append(("projections", *dense_work(batch * (nm + na), h,
                                             g["out_dim"], elem)))
    return calls


def bound_seconds(calls: List[Call], precision: str) -> Dict[str, float]:
    """Σ of each op's calls' bounds, in seconds."""
    out: Dict[str, float] = {}
    for op, flops, nbytes in calls:
        out[op] = out.get(op, 0.0) + bound(flops, nbytes, precision)[0] / 1e3
    return out


def _block_flops(n: int, q: int, g: dict) -> float:
    h, f = g["hidden_size"], g["intermediate_size"]
    return (2.0 * n * h * 3 * h + 4.0 * q * n * h + 2.0 * q * h * h
            + 4.0 * q * h * f)


def forward_flops(g: dict, out_rows: int | None = None) -> float:
    """Model FLOPs of one forward of one sample: every matmul of the
    encoders and the cross-modal blocks and the head, with the final
    block and the head over `out_rows` query rows (None: all)."""
    nm, na, h = g["motion_seq_length"], g["audio_seq_length"], \
        g["hidden_size"]
    n = nm + na
    total = 2.0 * nm * g["motion_dim"] * h + 2.0 * na * g["audio_dim"] * h
    total += g["motion_layers"] * _block_flops(nm, nm, g)
    total += g["audio_layers"] * _block_flops(na, na, g)
    q = n if out_rows is None else out_rows
    total += (g["cross_layers"] - 1) * _block_flops(n, n, g)
    total += _block_flops(n, q, g)
    return total + 2.0 * q * h * g["out_dim"]


def decode_step_flops(g: dict) -> float:
    """Model FLOPs of one generated frame: the forward that frame needs,
    whose final block and head compute the one row kept, with the audio
    track's embedding made once a clip and the motion window's by one
    new frame (the position-independent embeddings, hoisted as the
    published decoder does)."""
    nm, na, h = g["motion_seq_length"], g["audio_seq_length"], \
        g["hidden_size"]
    full = forward_flops(g, out_rows=1)
    return (full - 2.0 * nm * g["motion_dim"] * h
            - 2.0 * na * g["audio_dim"] * h
            + 2.0 * g["motion_dim"] * h + 2.0 * g["audio_dim"] * h)


def train_step_flops(g: dict) -> float:
    """Model FLOPs of one training sample: the forward and twice it for
    the backward."""
    return 3.0 * forward_flops(g)
