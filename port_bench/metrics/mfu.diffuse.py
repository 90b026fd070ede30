"""The DDIM steps' model FLOPs (both guidance branches of every chunk, the
dispatch's music memory counted once and spread over its steps) over the
traced window, as a share of the chip's peak in the configuration's
precision, in %."""


def read(trace):
    return trace.mfu()
