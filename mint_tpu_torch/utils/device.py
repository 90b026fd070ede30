"""The device an entry point runs on: the card unless the caller asks for
the CPU; never a silent fallback."""

from __future__ import annotations

import torch


def resolve(device: torch.device | str, what: str) -> torch.device:
    """`device` as a torch.device; 'cuda' without a card raises, naming
    `what` asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device 'cuda' asked for (the default) "
                           "but no CUDA card is available; pass "
                           "device='cpu' to run on the CPU")
    return device
