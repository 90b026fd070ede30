"""Device ms from one training step's update to the next step's first
launch: the batch draw, its copy into the static batch, the step's
scalars, the loss's copy and the device's idle time between them, from
the program's phase stamps in the trace."""

from lib import phases


def read(trace):
    return phases.phase_ms(trace, "between")
