"""The host's time a call spends making its inputs kernel inputs: the
``fused_dag.stage`` spans (the pipeline's ``as_tensor(...).to(dev)``,
the DAG call's ``_staged``, the wrapper's checks) per call, in the port
segment.  Nothing without that segment."""
from bench.port_trace import per_call_us


def read(rec):
    return per_call_us(rec, "fused_dag.stage")
