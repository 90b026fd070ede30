"""The projections' (the library's GEMMs: QKV, attention output,
the new frame's embedding, the head) share of their roofline in a
decode step, in %."""


def read(trace):
    return trace.roofline("projections")
