"""Device ms a training step from the loss to the gradients (the
backward), from the program's phase stamps in the trace."""

from lib import phases


def read(trace):
    return phases.phase_ms(trace, "backward")
