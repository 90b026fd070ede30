"""The FiLM residuals' and rotations' (``mint_film::``) share of their
roofline in a DDIM step, in %."""


def read(trace):
    return trace.roofline("film", "forward")
