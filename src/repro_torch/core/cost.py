"""Analytic cost model: main-memory traffic and metapipeline overlap.

Reproduces the accounting of the paper's Fig. 5c ("minimum number of
words read from main memory and on-chip storage ... after each IR
transformation") and the metapipeline throughput model of §6.

Read model ("register promotion"): an access or tile copy is loaded
once per iteration of the loop nest *down to the deepest loop index it
depends on*; loops deeper than that reuse the buffered value.  A copy
with a constant base (``hoisted``) is loaded exactly once -- the Pipe-0
preload of Fig. 6.

Traffic *word counts* are independent of the hardware.  The time and
capacity constants live in a named ``Tier``: ``TPU`` holds the figures
the JAX reference prices with (so the port reproduces its plans
exactly when handed that tier), ``H100_SXM`` / ``H100_PCIE`` hold the
NVIDIA datasheet figures, and ``device_tier`` builds the tier of the
card a run is on, reading its per-block shared-memory limit from the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from . import ir
from .affine import AffineMap


@dataclasses.dataclass(frozen=True)
class Tier:
    """Hardware constants one pricing uses.

    ``onchip_bytes`` is the per-kernel on-chip budget the memory plan is
    checked against (TPU VMEM; on the GPU the shared memory one block
    may opt into).  ``dma_latency_s`` is the fixed per-grid-step load
    issue cost the metapipeline depth hides (see ``metapipeline_time``).
    """

    name: str
    hbm_bytes_per_s: float
    peak_flops: float
    onchip_bytes: int
    dma_latency_s: float


# The JAX reference's constants (its cost.py): TPU-v5e-class HBM rate,
# bf16 peak, 16 MiB VMEM and a 1 us DMA issue latency.  Used by the
# parity tests; no figure of the port is derived from it.
TPU = Tier("tpu", 819e9, 197e12, 16 * 2 ** 20, 1e-6)

# NVIDIA H100 datasheet: 3.35 TB/s HBM3 (SXM) or 2.0 TB/s (PCIe), 67 /
# 51 TFLOP/s fp32 outside the tensor cores (the kernels' FFMA path),
# 227 KB (232,448 B) of shared memory one block may opt into.  The
# per-step issue latency is a model parameter that has not been
# measured on the card; it keeps the reference model's 1 us.
H100_SXM = Tier("h100-sxm", 3.35e12, 67e12, 232_448, 1e-6)
H100_PCIE = Tier("h100-pcie", 2.0e12, 51e12, 232_448, 1e-6)

# the port's default target when no card is asked (planning on the CPU)
DEFAULT_TIER = H100_SXM
ONCHIP_WORDS = DEFAULT_TIER.onchip_bytes // 4


def device_tier(device=None) -> Tier:
    """The tier of the card ``device`` names: datasheet bandwidth keyed
    by the device name, the on-chip budget read from the device.  A CPU
    device plans for ``DEFAULT_TIER`` (the port's target card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return DEFAULT_TIER
    props = torch.cuda.get_device_properties(dev)
    if "H100" not in props.name:
        raise ValueError(f"no datasheet tier for device '{props.name}'")
    base = H100_PCIE if "PCIe" in props.name else H100_SXM
    return dataclasses.replace(
        base, name=props.name,
        onchip_bytes=int(props.shared_memory_per_block_optin))


@dataclasses.dataclass
class TrafficReport:
    """Main-memory words read per tensor + on-chip words per buffer."""

    reads: Dict[str, int]
    on_chip: Dict[str, int]

    @property
    def total_reads(self) -> int:
        return sum(self.reads.values())

    @property
    def total_on_chip(self) -> int:
        return sum(self.on_chip.values())


def _deepest_dep(amap: AffineMap) -> int:
    deps = amap.dependent_dims()
    return max(deps) if deps else -1


def _probe(index_map, n_in: int) -> Optional[AffineMap]:
    if isinstance(index_map, AffineMap):
        return index_map
    try:
        return AffineMap.probe(index_map, n_in)
    except Exception:
        return None  # non-affine


def _extent_of_dim(levels: List[Tuple[ir.Pattern, int]], dim: int) -> int:
    for p, off in levels:
        if off <= dim < off + len(p.domain):
            return p.domain[dim - off]
    raise KeyError(dim)


def _trips_to(levels: List[Tuple[ir.Pattern, int]], deepest: int) -> int:
    """Product of loop extents from the root down to ``deepest`` incl."""
    t = 1
    for p, off in levels:
        for j, e in enumerate(p.domain):
            if off + j <= deepest:
                t *= e
    return t


def traffic(p: ir.Pattern) -> TrafficReport:
    reads: Dict[str, int] = {}
    on_chip: Dict[str, int] = {}
    buf_idx = [0]

    def visit(q: ir.Pattern, levels):
        off = (levels[-1][1] + len(levels[-1][0].domain)) if levels else 0
        path = levels + [(q, off)]
        stack_len = off + len(q.domain)

        for tc in q.loads:
            if isinstance(tc.src, ir.Tensor):
                amap = _probe(tc.index_map, stack_len)
                if tc.hoisted or (amap is not None
                                  and not amap.dependent_dims()):
                    trips = 1
                else:
                    trips = _trips_to(path, _deepest_dep(amap))
                reads[tc.src.name] = (reads.get(tc.src.name, 0)
                                      + trips * tc.words // tc.reuse)
                on_chip[f"{tc.name}#{buf_idx[0]}"] = tc.words
            else:
                on_chip[f"{tc.name}#{buf_idx[0]}"] = tc.words
                visit(tc.src, path)
            buf_idx[0] += 1

        for a in q.accesses:
            if isinstance(a.src, ir.Tensor):
                amap = _probe(a.index_map, stack_len)
                if amap is None:  # non-affine: every iteration pays
                    trips = _trips_to(path, stack_len - 1)
                else:
                    deep = _deepest_dep(amap)
                    trips = _trips_to(path, deep) if deep >= 0 else 1
                reads[a.src.name] = (reads.get(a.src.name, 0)
                                     + trips * a.words)
                # untiled direct access still needs a window's worth of
                # registers/buffer (the paper's "d" for fused k-means)
                key = f"{a.src.name}_window"
                on_chip[key] = max(on_chip.get(key, 0), a.words)
            elif isinstance(a.src, ir.Pattern):
                visit(a.src, path)
        if q.inner is not None:
            visit(q.inner, path)

    visit(p, [])
    return TrafficReport(reads, on_chip)


# ------------------------------------------------------------------ time
@dataclasses.dataclass
class StageCost:
    name: str
    kind: str            # load | compute | store
    seconds: float


def metapipeline_time(stage_costs: List[StageCost],
                      outer_trips: int, depth: int = 2,
                      dma_latency_s: float = DEFAULT_TIER.dma_latency_s
                      ) -> Tuple[float, float]:
    """(sequential, metapipelined) execution time for an outer loop whose
    body is the given stages.

    Sequential = sum per iteration; the metapipeline overlaps stages
    across outer iterations (buffers of depth >= 2), so steady-state
    cost = max stage (plus pipeline fill) plus the *exposed* DMA issue
    latency.  A buffer of depth ``d`` lets a load's DMA be issued up to
    ``d - 1`` iterations ahead, giving it ``(d - 1) x max_stage``
    seconds to land before its consumer needs it; whatever remains of
    ``dma_latency_s`` is charged once per steady-state step (issue
    latencies of concurrent loads overlap each other).  The term
    saturates at zero, so deepening past the point where latency is
    fully hidden buys nothing -- that is what keeps the DSE's optimum
    depth workload-dependent instead of "deeper is always better".
    """
    per_iter = [s.seconds for s in stage_costs]
    seq = outer_trips * sum(per_iter)
    step = max(per_iter)
    exposed = 0.0
    if any(s.kind == "load" for s in stage_costs):
        exposed = max(0.0, dma_latency_s - (max(depth, 1) - 1) * step)
    fill = sum(per_iter) - step
    pipe = fill + outer_trips * (step + exposed)
    return seq, pipe


def stage_seconds_load(words: int, bytes_per_word: int = 4,
                       tier: Tier = DEFAULT_TIER) -> float:
    return words * bytes_per_word / tier.hbm_bytes_per_s


def stream_seconds(words: int, *, bytes_per_word: int = 4,
                   tier: Tier = DEFAULT_TIER) -> float:
    """Main-memory stream seconds for ``words`` words at the tier's
    datasheet bandwidth (the uncalibrated pricing)."""
    return words * bytes_per_word / tier.hbm_bytes_per_s


def stage_seconds_compute(flops: float,
                          tier: Tier = DEFAULT_TIER) -> float:
    return flops / tier.peak_flops


# ------------------------------------------------- serving decode traffic
def dense_decode_traffic_words(batch: int, cache_len: int, kv_heads: int,
                               head_dim: int) -> int:
    """Modeled main-memory words one decode step streams through a
    *dense* (unpaged) KV cache: every request reads its full
    ``cache_len`` extent of K and V regardless of how many tokens are
    live, plus the new token's K/V write and the query read."""
    kv = 2 * batch * cache_len * kv_heads * head_dim
    token = 2 * batch * kv_heads * head_dim      # K/V append
    q = batch * kv_heads * head_dim
    return kv + token + q


def paged_decode_traffic_words(seq_lens, page_size: int, kv_heads: int,
                               head_dim: int) -> int:
    """Modeled main-memory words one decode step streams through the
    paged cache: each request touches only its live pages (``seq_len``
    rounded up to page granularity), plus its K/V append and query.  The
    two layouts (split and head-interleaved fused K/V) move the same
    words."""
    total = 0
    for ln in seq_lens:
        pages = -(-int(ln) // page_size)
        total += 2 * pages * page_size * kv_heads * head_dim
        total += 3 * kv_heads * head_dim         # K/V append + query
    return total
