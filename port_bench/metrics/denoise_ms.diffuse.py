"""Device ms a DDIM step from its first launch to the guided, clipped x0
(the denoiser over both branches), from the program's phase stamps."""

from lib import diffuse_phases


def read(trace):
    return diffuse_phases.phase_ms(trace, "denoise")
