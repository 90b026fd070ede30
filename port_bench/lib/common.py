"""What every kind of traffic shares: seeds, the weights and inputs made
from them, the program's configuration object, and the run's guards."""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import torch

from reference import fact as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "mint_tpu")
_MASK = (1 << 64) - 1


def sub_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one stream of draws (weights, inputs, corpus,
    samples) of a run's `seed`, mixed by splitmix64's finaliser."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03
         + index) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


STREAM_WEIGHTS, STREAM_INPUTS, STREAM_CHECK, STREAM_CORPUS, \
    STREAM_TRAIN = range(1, 6)


def generator(device, seed: int, stream: int, index: int = 0
              ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream, index))
    return g


def make_params(g: dict, seed: int, device, served: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """The run's weights, float32 on `device`, one draw a kind of leaf:
    glorot uniform kernels, truncated-normal position tables and head
    (sigma 0.02 and the head's range, cut at 2 sigma), and small random
    biases and LayerNorm affines, so that every term of the model is
    exercised.
    Every leaf but the LayerNorms' (served in float32) is rounded to
    `served`, the type it is served in."""
    spec = ref.param_spec(g)
    gen = generator(device, seed, STREAM_WEIGHTS)
    groups: Dict[str, List] = {}
    for name, shape, kind in spec:
        groups.setdefault(kind, []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for kind in ("dense", "table", "head", "bias", "ln_scale", "ln_bias"):
        leaves = groups.get(kind, [])
        total = sum(int(torch.Size(s).numel()) for _, s in leaves)
        if kind == "dense":
            flat = torch.rand(total, generator=gen, device=device) * 2 - 1
        else:
            flat = torch.randn(total, generator=gen, device=device)
        at = 0
        for name, shape in leaves:
            n = int(torch.Size(shape).numel())
            x = flat[at:at + n].view(shape)
            at += n
            if kind == "dense":
                x = x * (6.0 / (shape[0] + shape[1])) ** 0.5
            elif kind in ("table", "head"):
                sigma = (g["output_initializer_range"] if kind == "head"
                         else 0.02)
                x = x.clamp(-2.0, 2.0) * sigma
            elif kind == "bias":
                x = x * 0.02
            elif kind == "ln_scale":
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            if not kind.startswith("ln_"):
                x = x.to(served).float()
            out[name] = x.contiguous()
    return {name: out[name] for name, _, _ in spec}


def port_model_config(g: dict):
    """The program's model configuration object for the sizes in `g`."""
    from mint_tpu_torch.config import schema as s

    def tf(layers):
        return s.TransformerConfig(
            hidden_size=g["hidden_size"], num_hidden_layers=layers,
            num_attention_heads=g["num_attention_heads"],
            intermediate_size=g["intermediate_size"])

    audio = s.ModalityConfig(
        feature_name="audio", sequence_length=g["audio_seq_length"],
        feature_dim=g["audio_dim"],
        model=[s.ModalityModelConfig(transformer=tf(g["audio_layers"]))])
    motion = s.ModalityConfig(
        feature_name="motion", sequence_length=g["motion_seq_length"],
        feature_dim=g["motion_dim"],
        model=[s.ModalityModelConfig(transformer=tf(g["motion_layers"]))])
    cross = s.CrossModalModelConfig(
        modality_a="motion", modality_b="audio",
        transformer=tf(g["cross_layers"]),
        output_layer=s.MLPConfig(
            out_dim=g["out_dim"],
            initializer_range=g["output_initializer_range"]))
    return s.MultiModalModelConfig(fact_model=s.FACTModelConfig(
        modality=[audio, motion], cross_modal_model=cross))


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose whole top-level name is one
    the benchmark may not run (the JAX stack or the JAX package)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: List[float], q: int) -> float:
    """Python's ``statistics.quantiles`` cut point `q` of 100."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def worst_leaf_gap(prog: Dict[str, float], ref_: Dict[str, float],
                   keep: List[str]) -> float:
    """The largest gap between two norms a leaf over the leaves `keep`,
    each against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(ref_[k] for k in keep)
    return max(abs(prog[k] - ref_[k]) / max(ref_[k], median) for k in keep)
