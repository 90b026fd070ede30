"""Device idle share of the traced diffusion window (one dispatch: its
music memory and every DDIM step), in %: one less the union of device
operations' intervals over the window."""


def read(trace):
    return trace.idle_share()
