"""The host's time a call spends launching: the ``fused_dag.launch``
span (library, blocks, stream, allocations, pointers, the megakernel's
ctypes launch and its check) and the ``fused_dag.combine`` span (the
output's allocation, the combine's launch, its check, the slicing) per
call, in the port segment.  Nothing without that segment."""
from bench.port_trace import per_call_us


def read(rec):
    return per_call_us(rec, "fused_dag.launch", "fused_dag.combine")
