"""Device ms a training step from the gradients (over ranks: their
mean) to the updated state (the clip and Adam), from the program's phase
stamps in the trace."""

from lib import phases


def read(trace):
    return phases.phase_ms(trace, "update")
