"""The decode's model FLOPs over the traced window, as a share of the
chip's peak in the configuration's precision, in %."""


def read(trace):
    return trace.mfu()
