"""Device ms a training step from the gradients to their mean over the
data-parallel ranks (the flat buffer's copies, the all-reduce, the
division), from the program's phase stamps in the trace (rank 0's)."""

from lib import phases


def read(trace):
    return phases.phase_ms(trace, "exchange")
