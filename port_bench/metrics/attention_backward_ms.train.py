"""Device ms a step of the attention backward's kernels
(mint_attention_bwd::), from the trace."""


def read(trace):
    seconds = trace.op_seconds("attention_backward")
    return 1e3 * seconds / trace.units if seconds > 0 else None
