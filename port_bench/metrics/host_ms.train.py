"""The host's own ms a training step: the program's ``mint.train.step``
and ``mint.train.sample`` spans, less the CUDA calls under them."""

from lib import phases


def read(trace):
    return phases.host_ms(trace, ("mint.train.step", "mint.train.sample"))
