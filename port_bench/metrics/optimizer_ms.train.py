"""Device ms a step of the optimizer's kernels (Adam's foreach
kernels), from the trace."""


def read(trace):
    seconds = trace.op_seconds("optimizer")
    return 1e3 * seconds / trace.units if seconds > 0 else None
