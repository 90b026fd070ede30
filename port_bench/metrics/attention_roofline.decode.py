"""Attention's share of its roofline in a decode step, in %."""


def read(trace):
    return trace.roofline("attention", "forward")
