"""The fused MLP's share of its roofline in the training forward,
in %."""


def read(trace):
    return trace.roofline("mlp", "forward")
