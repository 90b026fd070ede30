"""LayerNorm of a bf16 input with f32 parameters: a hand-written CUDA kernel
and its plain version.

Flax's ``LayerNorm(dtype=bfloat16)`` keeps its scale and bias f32, takes
the statistics and the affine in f32 and rounds only the output
(``mint_tpu/models/layers.py:143-153``).  PyTorch's CUDA ``layer_norm``
refuses a bf16 input with f32 parameters, so the plain version,
:func:`layer_norm_reference`, casts the input to f32 and the output back:
three launches.  :func:`layer_norm` launches one kernel instead (its
source is ``mint_tpu_torch/csrc/layer_norm.cu``).  It is no port of a TPU
kernel: the JAX package leaves LayerNorm to XLA, which fuses the casts.

Without parameters (``weight`` and ``bias`` both None) it is Flax's
``LayerNorm(use_scale=False, use_bias=False, dtype=bfloat16)``, the
LayerNorm of a model whose affines are folded (``models/fold.py``): the
statistics in f32 and the normalised output rounded to bf16, the plain
version ``F.layer_norm(x.float(), ..., None, None, eps).to(bf16)``; the
kernel's affine-free form is the same launch with null parameters.

Gradients: where one is wanted, the launch runs inside
:class:`LayerNormFunction`, whose backward is the VJP of
:func:`layer_norm_reference` recomputed from the saved inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mint_tpu_torch.ops import _build

# Kernel launches made by :func:`layer_norm` (the CUDA path only): with
# parameters, and in the affine-free form.
launches = 0
affine_free_launches = 0

def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor | None,
                         bias: torch.Tensor | None, eps: float
                         ) -> torch.Tensor:
    """LayerNorm over x's last dim: statistics and affine in f32 with the
    f32 ``weight`` and ``bias`` (or no affine where both are None), the
    output in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias,
                        eps).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """LayerNorm of bf16 ``x`` [..., C] with f32 ``weight`` and ``bias``
    [C], or with neither (both None); returns bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises), through :class:`LayerNormFunction` only where
    autograd needs it (grad mode on and an input that requires grad).
    """
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)
            or (bias is not None and bias.requires_grad)):
        return LayerNormFunction.apply(x, weight, bias, eps, _launch)
    return _launch(x, weight, bias, eps)


class LayerNormFunction(torch.autograd.Function):
    """``forward(x, weight, bias, eps)`` as the forward, and the VJP of
    :func:`layer_norm_reference` as the backward.  ``forward`` is the
    kernel's launch on the card; the CPU tests pass the plain version in
    its place."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, forward):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm_reference(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t is not None], grad_out))
        grads = [None if t is None else next(grads) for t in inputs]
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None, None)


def _launch(x, weight, bias, eps):
    # A bf16 decode step makes 32 of these calls and is host-bound, so the
    # checks are plain comparisons and the launch takes few Python calls:
    # the raw stream in one call, each pointer read once.
    global launches, affine_free_launches
    cols = x.shape[-1]
    if weight is None and bias is None:  # the affine-free form
        if x.device.type != "cuda" or x.dtype != torch.bfloat16:
            raise ValueError(f"layer_norm: the kernel takes a bfloat16 "
                             f"CUDA input; got {x.dtype} on {x.device}")
        x = x.contiguous()
        px, pw, pb = x.data_ptr(), 0, 0
    else:
        if weight is None or bias is None:
            raise ValueError("layer_norm: weight and bias are both given "
                             "or both None")
        if (x.device.type != "cuda" or weight.device != x.device
                or bias.device != x.device):
            raise ValueError(f"layer_norm: inputs on {x.device}, "
                             f"{weight.device}, {bias.device} (one CUDA "
                             "device)")
        if (x.dtype != torch.bfloat16 or weight.dtype != torch.float32
                or bias.dtype != torch.float32):
            raise ValueError(f"layer_norm: the kernel takes a bfloat16 "
                             f"input with float32 weight and bias; got "
                             f"{x.dtype}, {weight.dtype}, {bias.dtype}")
        if weight.shape != (cols,) or bias.shape != (cols,):
            raise ValueError(f"layer_norm: x {tuple(x.shape)}, weight "
                             f"{tuple(weight.shape)}, bias "
                             f"{tuple(bias.shape)}")
        x, weight, bias = (x.contiguous(), weight.contiguous(),
                           bias.contiguous())
        px, pw, pb = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    out = torch.empty_like(x)
    rows = x.numel() // max(cols, 1)
    if rows == 0:
        return out
    err = _build.library().mint_layer_norm_bf16(
        px, pw, pb, out.data_ptr(), rows, cols, eps,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        _build.check(err, "layer_norm kernel launch")
    if pw:
        launches += 1
    else:
        affine_free_launches += 1
    return out
