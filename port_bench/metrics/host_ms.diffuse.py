"""The host's own ms a DDIM step: the program's ``mint.diffuse.step``
spans (a step's graph replay), less the CUDA calls under them."""

from lib import phases


def read(trace):
    return phases.host_ms(trace, ("mint.diffuse.step",))
