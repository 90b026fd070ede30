"""Attention's share of its roofline in the training forward, in
%."""


def read(trace):
    return trace.roofline("attention", "forward")
