"""Device ms a training step from the body's first launch to the loss
(the forward), from the program's phase stamps in the trace."""

from lib import phases


def read(trace):
    return phases.phase_ms(trace, "forward")
