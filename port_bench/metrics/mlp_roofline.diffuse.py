"""The fused erf MLP's share of its roofline in a DDIM step, in %."""


def read(trace):
    return trace.roofline("mlp", "forward")
