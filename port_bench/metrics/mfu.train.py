"""The training steps' model FLOPs (this rank's rows of the global batch)
over the traced window, as a share of one chip's peak in the
configuration's precision, in %."""


def read(trace):
    return trace.mfu()
