"""Rounding of matmul operands to a lower precision, for the controls.

Each function rounds a float32 tensor to the values a lower-precision
matmul would read and returns them in float32, so the reference computes
with them on any device (the CPU tests included) and accumulates in
float32, as tensor cores do.
"""

from __future__ import annotations

import torch


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32's 10 mantissa bits, to nearest (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale a tensor (its largest
    magnitude onto e4m3's largest value, 448)."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _straight_through(fn):
    """`fn`'s values forward; where a gradient is taken, the identity's
    backward (each matmul's backward then reads the rounded operands it
    saved)."""
    def rounded(x: torch.Tensor) -> torch.Tensor:
        if not x.requires_grad:
            return fn(x)
        return x + (fn(x.detach()) - x).detach()
    rounded.__doc__ = fn.__doc__
    return rounded


ROUNDING = {"f32": f32, "tf32": _straight_through(tf32),
            "bf16": _straight_through(bf16), "fp8": _straight_through(fp8)}

#: The control of each stated precision: the nearest below it.
CONTROL = {"f32": "tf32", "bf16": "fp8"}
