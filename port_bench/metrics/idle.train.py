"""Device idle share of the traced training window, in %: one less the
union of device operations' intervals over the window."""


def read(trace):
    return trace.idle_share()
