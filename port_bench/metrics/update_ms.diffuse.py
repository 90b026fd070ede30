"""Device ms a DDIM step from the guided x0 to the next state (the
update and the stitch within songs), from the program's phase stamps."""

from lib import diffuse_phases


def read(trace):
    return diffuse_phases.phase_ms(trace, "update")
