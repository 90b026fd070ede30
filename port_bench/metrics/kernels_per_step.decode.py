"""Device kernels a decode step launches, counted in the trace."""


def read(trace):
    kernels = trace.kernels()
    return len(kernels) / trace.units if kernels and trace.units else None
