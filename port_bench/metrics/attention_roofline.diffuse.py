"""Attention's share of its roofline in a DDIM step (self-attention over
150 frames, the conditional chunks against their 152 keys, the
unconditional rows against one shared key set), in %."""


def read(trace):
    return trace.roofline("attention", "forward")
