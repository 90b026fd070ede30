"""Device ms a step of the gradient all-reduce's NCCL kernels that no
compute kernel overlaps, from the trace (rank 0's)."""


def read(trace):
    if not trace.of_op("allreduce"):
        return None
    return 1e3 * trace.exposed_seconds("allreduce") / trace.units
