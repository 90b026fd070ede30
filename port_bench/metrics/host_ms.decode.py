"""The host's own ms a decode step: the program's ``mint.decode.step``
spans, less the CUDA calls under them."""

from lib import phases


def read(trace):
    return phases.host_ms(trace, ("mint.decode.step",))
