"""The yardstick: the card's peaks, and the bytes and operations a
call into the port needs, from the shapes of what it reads and writes.

Bytes count each input byte read once and each output byte written
once, whatever a kernel reads again.  Operations are those the
program's bodies do, as its reference counts them (``ops`` in
``reference/<program>.py``).  A call's bound is the larger of its bytes
over the memory rate and its operations over the float32 (FFMA,
outside the tensor cores) rate: the least time the card could take for
it.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

# NVIDIA H100 SXM5 datasheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def elems(shape) -> int:
    n = 1
    for e in shape:
        n *= int(e)
    return n


def bytes_per_call(inputs: Mapping[str, Tuple[int, ...]],
                   outputs: Mapping[str, Tuple[int, ...]],
                   itemsize: int = 4) -> int:
    """Each input read once and each output written once."""
    return itemsize * (sum(elems(s) for s in inputs.values())
                       + sum(elems(s) for s in outputs.values()))


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for this work: bytes over the memory rate against
    operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def work(ops: Callable[[Mapping], int],
         inputs: Mapping[str, Tuple[int, ...]],
         outputs: Mapping[str, Tuple[int, ...]]) -> Dict[str, float]:
    """A call's bytes, operations (``ops(inputs)``) and bound in
    seconds."""
    b = bytes_per_call(inputs, outputs)
    o = ops(inputs)
    return {"bytes": b, "ops": o, "bound_s": bound_s(b, o)}
