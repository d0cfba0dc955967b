"""Shape bucketing + warm-start re-tuning for the DSE stack (the
reference's ``core/buckets``).

Tuned plans are keyed on *exact* shapes, so a service facing arbitrary
user shapes either compile-storms (one full exploration per novel
shape) or falls off the tuned path entirely.  This module adds the
middle path, AnyHLS-style specialization classes with best-effort
background refinement:

  * every concrete extent maps to a **bucket** -- the next value on a
    power-of-two-ish ladder ``{s*2^j, s*3*2^(j-1)}`` floored at the
    dtype's sublane multiple ``s`` (``bucket_extent``).  Two shapes in
    one bucket share a specialization class;
  * each completed exploration records its winning plan in a **bucket
    index** inside the tuning-cache document (keyed by a
    shape-independent *family* signature of the pattern / pipeline, the
    device, the tier and, for a hand kernel's own space, the kernel and
    its path), so the index rides the existing crash-safe store;
  * a cold shape whose family has tuned buckets is served a
    **warm-start plan** immediately: the nearest bucket's plan, its
    tiles re-fitted onto the cold shape's candidates (the divisor grid
    ``dse.axis_candidates``, or the tiles a hand kernel takes at that
    shape, ``dse.KernelSpace``) and re-priced analytically.  No kernel
    is lowered, nothing is measured, nothing is cached -- the warm plan
    is a loan;
  * a **background re-tune** (daemon thread, bounded by the
    ``resilience.Policy`` deadline, deduplicated per cache key) runs
    the full exploration for the exact shape and promotes its winner
    into the tuning cache -- but only after the winner **certifies**
    against the oracle (``resilience.certify_*``; a hand kernel's plan
    by running that kernel), regardless of ``policy.certify``: an
    unattended background write demands validation.  Its CUDA work is
    synchronized before the winner is promoted.  Once promoted, the
    next request for that shape is an exact cache hit.

``STATS`` counts exact hits / warm starts / misses / promotions for
the serving loop; ``drain()`` joins outstanding re-tunes (tests,
chip_smoke.py) and raises if one is still running.

Enabled per call via ``Options(bucketing=True)`` (or fleet-wide with
``REPRO_BUCKETING=1`` -- read by ``Options.from_env``); ``dse.explore``
/ ``dse.explore_pipeline`` own the call sites.
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

from . import ir, resilience, telemetry

# ---------------------------------------------------------------- buckets


def bucket_extent(n: int, *, sublane: int = 1) -> int:
    """Smallest ladder value >= ``n`` from ``{s*2^j, s*3*2^(j-1)}``
    (``s`` = the dtype sublane multiple): powers of two plus their 1.5x
    midpoints, so consecutive buckets are at most 33% apart and every
    bucket is sublane-aligned.  ``n <= s`` collapses to ``s``."""
    n = max(int(n), 1)
    s = max(int(sublane), 1)
    v = s
    while v < n:
        mid = v + v // 2
        if v % 2 == 0 and mid % s == 0 and mid >= n:
            return mid
        v *= 2
    return v


def _bucket_sig(domains: Dict[str, Tuple[int, ...]]) -> str:
    return ";".join(f"{k}={'x'.join(map(str, v))}"
                    for k, v in sorted(domains.items()))


# ------------------------------------------------------- family signatures


def _device() -> str:
    """The device the plans are for: the CUDA card's name when there is
    one, else the CPU's (``measure.device_kind``)."""
    from . import measure
    return measure.device_kind()


def _context(tier, device: Optional[str], kernel) -> Tuple:
    """What a family adds beside the pattern: the device kind, the
    tier's constants (one device may plan for several tiers) and a hand
    kernel's family (its source and path)."""
    from . import dse
    return (device or _device(),
            dse._tier_sig(tier) if tier is not None else (),
            tuple(kernel.family) if kernel is not None else ())


def tile_family(p: ir.Pattern, *, vmem_budget: int, align: int,
                tier=None, device: Optional[str] = None,
                kernel=None) -> str:
    """Shape-independent identity of a tile exploration: pattern tree
    structure (types, names, domain ranks, dtypes), input tensor ranks
    and dtypes, constraints, device kind, tier and hand kernel.
    Deliberately excludes extents (that is what buckets vary over) and
    the calibration profile hash (warm starts are heuristic seeds; they
    must survive recalibration)."""
    from . import dse
    parts = tuple((type(q).__name__, q.name, len(q.domain),
                   str(q.dtype), bool(q.strided)) for q in ir.walk(p))
    inputs = tuple((t.name, len(t.shape), str(t.dtype))
                   for t in ir.inputs_of(p))
    raw = repr((dse.MODEL_VERSION, _context(tier, device, kernel), "tile",
                parts, inputs, int(vmem_budget), int(align)))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def tile_buckets(p: ir.Pattern, *, align: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Per tileable pattern domain, the bucketed extents (mirrors
    ``dse.tile_space``'s iteration: named, untiled, unstrided)."""
    from . import dse
    out: Dict[str, Tuple[int, ...]] = {}
    for q in ir.walk(p):
        if q.strided or not q.domain or q.name in out:
            continue
        sub = dse.dtype_sublane(q.dtype)
        out[q.name] = tuple(bucket_extent(d, sublane=sub)
                            for d in q.domain)
    return out


def pipeline_family(pipe, *, vmem_budget: int, align: int, tier=None,
                    device: Optional[str] = None) -> str:
    """Shape-independent identity of a pipeline exploration: per-stage
    structure in topological order plus wiring, device kind, tier and
    constraints (extent-free analogue of ``dse.pipeline_key``)."""
    from . import dse
    from . import pipeline as plmod
    parts = tuple((s.name, type(s).__name__, str(s.dtype), len(s.shape),
                   len(s.domain)) for s in plmod.topo_stages(pipe))
    edges = tuple(sorted(set(plmod._edges(pipe))))
    raw = repr((dse.MODEL_VERSION, _context(tier, device, None),
                "pipeline", pipe.name, parts, edges,
                tuple(plmod.output_names(pipe)), int(vmem_budget),
                int(align)))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def pipeline_buckets(pipe) -> Dict[str, Tuple[int, ...]]:
    from . import dse
    from . import pipeline as plmod
    sub = max(dse.dtype_sublane(s.dtype)
              for s in plmod.topo_stages(pipe))
    return {"extent": (bucket_extent(pipe.shared_extent, sublane=sub),)}


# ------------------------------------------------------------ bucket index


def record_tile(p: ir.Pattern, plan, tc, *, vmem_budget: int,
                align: int, tier=None, device: Optional[str] = None,
                kernel=None) -> None:
    """Register ``plan`` as the donor for its bucket (idempotent: an
    identical existing entry skips the disk write; a newer tuned plan
    for the same bucket overwrites -- latest wins)."""
    doms = tile_buckets(p, align=align)
    if not doms:
        return
    fam = tile_family(p, vmem_budget=vmem_budget, align=align, tier=tier,
                      device=device, kernel=kernel)
    _put(tc, fam, doms, plan, "tile")


def record_pipeline(pipe, plan, tc, *, vmem_budget: int, align: int,
                    tier=None, device: Optional[str] = None) -> None:
    """Register a *fused* pipeline plan as its bucket's donor (split
    plans are not warm-start donors: their cut structure is priced for
    one extent and does not transfer)."""
    if not plan.fused:
        return
    fam = pipeline_family(pipe, vmem_budget=vmem_budget, align=align,
                          tier=tier, device=device)
    _put(tc, fam, pipeline_buckets(pipe), plan, "pipeline")


def record_kernel_plan(kernel: str, extents: Dict[str, Tuple[int, ...]],
                       plan, tc, *, tier=None, device: Optional[str] = None,
                       context: Tuple = ()) -> None:
    """Register a hand kernel's plan that no pattern explores (the
    paged-decode kernel's, ``dse._paged_kernel_plan``) as the donor of
    the bucket of ``extents`` in the family of ``kernel`` and its
    ``context``."""
    raw = repr((_context(tier, device, None), "kernel", kernel,
                tuple(context)))
    fam = hashlib.sha256(raw.encode()).hexdigest()[:16]
    doms = {k: tuple(bucket_extent(e) for e in v)
            for k, v in extents.items()}
    _put(tc, fam, doms, plan, "kernel")


def _put(tc, family: str, doms: Dict[str, Tuple[int, ...]], plan,
         kind: str) -> None:
    sig = _bucket_sig(doms)
    entry = {"kind": kind,
             "domains": {k: list(v) for k, v in doms.items()},
             "plan": plan.to_json()}
    if tc.bucket_entries(family).get(sig) == entry:
        return
    tc.bucket_put(family, sig, entry)


def _nearest(entries: Dict[str, Dict],
             want: Dict[str, Tuple[int, ...]],
             kind: str) -> Optional[Dict]:
    """The compatible entry whose bucket is log-nearest to ``want``
    (exact bucket first, then donors >= on every dim -- shrinking a
    tuned tile onto a smaller shape loses less than growing one)."""
    best = None
    best_rank: Tuple = ()
    for _sig, e in entries.items():
        if e.get("kind") != kind:
            continue
        doms = {k: tuple(v) for k, v in e.get("domains", {}).items()}
        if set(doms) != set(want) or any(
                len(doms[k]) != len(want[k]) for k in want):
            continue
        dist = sum(abs(math.log2(max(a, 1)) - math.log2(max(b, 1)))
                   for k in sorted(want)
                   for a, b in zip(doms[k], want[k]))
        ge = all(a >= b for k in want
                 for a, b in zip(doms[k], want[k]))
        rank = (dist > 0, not ge, dist)
        if best is None or rank < best_rank:
            best, best_rank = e, rank
    return best


# -------------------------------------------------------------- warm start


def _fit(cands, want_tile: int) -> int:
    """The largest candidate <= ``want_tile``, else the smallest."""
    le = [c for c in cands if c <= want_tile]
    return max(le) if le else min(cands)


def warm_start_tile(p: ir.Pattern, tc, *, vmem_budget: int, align: int,
                    tier=None, device: Optional[str] = None, kernel=None):
    """A ``TilePlan`` adapted from the nearest tuned bucket, or None.

    The donor's per-domain tile is mapped onto the cold shape's own
    candidate grid: the largest ``axis_candidates`` divisor <= the
    donor tile (the ragged tail falls out of the divisor enumeration),
    at the donor's buffer depth, re-priced analytically.  For a hand
    kernel's space (``kernel``) the grid is the tiles the kernel takes
    at the cold shape and the price is its own (``dse.price_kernel``),
    so the loaned plan is one the kernel launches.  Zero lowering, zero
    measurement; the plan is flagged ``warm_start`` and never
    persisted.  ``tier`` defaults to the card's (``dse.tier_of``)."""
    from . import dse
    want = tile_buckets(p, align=align)
    if not want:
        return None
    tier = dse.tier_of(tier, None)
    fam = tile_family(p, vmem_budget=vmem_budget, align=align, tier=tier,
                      device=device, kernel=kernel)
    entry = _nearest(tc.bucket_entries(fam), want, "tile")
    if entry is None:
        return None
    donor = dse.TilePlan.from_json(entry["plan"])
    grid = kernel.candidates() if kernel is not None else None
    sizes: Dict[str, Tuple[int, ...]] = {}
    for q in ir.walk(p):
        if q.strided or not q.domain or q.name in sizes:
            continue
        dt = donor.sizes.get(q.name)
        if dt is None or len(dt) != len(q.domain):
            return None
        if grid is not None:
            cands = grid.get(q.name)
            if not cands:
                return None
            sizes[q.name] = tuple(
                _fit([c[i] for c in cands], want_tile)
                for i, want_tile in enumerate(dt))
            continue
        sub = dse.dtype_sublane(q.dtype)
        sizes[q.name] = tuple(
            _fit(dse.axis_candidates(extent, align, sublane=sub), want_tile)
            for extent, want_tile in zip(q.domain, dt))
    if grid is not None:
        if any(sizes[n] not in grid[n] for n in grid):
            return None
        if donor.depth not in kernel.depths:
            return None
        priced = dse.price_kernel(p, sizes, kernel, tier=tier,
                                  vmem_budget=vmem_budget,
                                  depth=donor.depth)
    else:
        priced = dse.price(p, sizes, tier=tier, vmem_budget=vmem_budget,
                           profile=None, depth=donor.depth)
    if priced is None:
        return None
    return dse.TilePlan(
        sizes=sizes, depths={k: int(priced.depth) for k in sizes},
        traffic_words=priced.traffic_words,
        vmem_bytes=priced.vmem_bytes,
        modeled_seconds=priced.calibrated_seconds,
        warm_start=True,
        bucket=_bucket_sig({k: tuple(v) for k, v
                            in entry["domains"].items()}))


def warm_start_pipeline(pipe, tc, *, vmem_budget: int, align: int,
                        max_points: int, tier=None,
                        device: Optional[str] = None):
    """A fully fused ``PipelinePlan`` adapted from the nearest tuned
    bucket (donor block re-fitted to the cold extent's divisors,
    donor depth kept, re-priced analytically), or None."""
    from . import dse
    from . import pipeline as plmod
    tier = dse.tier_of(tier, None)
    fam = pipeline_family(pipe, vmem_budget=vmem_budget, align=align,
                          tier=tier, device=device)
    entry = _nearest(tc.bucket_entries(fam), pipeline_buckets(pipe),
                     "pipeline")
    if entry is None:
        return None
    donor = dse.PipelinePlan.from_json(entry["plan"])
    b = _fit(dse._pipeline_candidates(pipe, align, max_points), donor.block)
    n_stages = len(plmod.topo_stages(pipe))
    try:
        whole = plmod.sub_pipeline(pipe, 0, n_stages)
    except (ValueError, NotImplementedError):
        return None
    # profile=None -> uncalibrated analytic pricing
    res = dse._price_pipeline_group(
        whole, b, vmem_budget=vmem_budget, tier=tier, profile=None,
        counters={"explored": 0, "pruned": 0}, depth=donor.depth)
    if res is None:
        return None
    words, vmem, _s_ana, s_cal, _steps = res
    return dse.PipelinePlan(
        block=int(b), groups=((0, n_stages),), group_blocks=(int(b),),
        depths=(int(donor.depth),), traffic_words=int(words),
        unfused_traffic_words=plmod.unfused_traffic_words(pipe),
        vmem_bytes=int(vmem), modeled_seconds=float(s_cal),
        warm_start=True,
        bucket=_bucket_sig({k: tuple(v) for k, v
                            in entry["domains"].items()}))


# -------------------------------------------------- background re-tuning

STATS: Dict[str, int] = {}
_LOCK = threading.Lock()
_INFLIGHT: set = set()
_THREADS: list = []


def _zero() -> Dict[str, int]:
    return {"exact_hits": 0, "warm_hits": 0, "misses": 0,
            "retunes": 0, "promotions": 0, "retune_failures": 0}


STATS.update(_zero())


def note(kind: str) -> None:
    with _LOCK:
        STATS[kind] = STATS.get(kind, 0) + 1
    # mirror into the unified metrics registry (always on): serving
    # stats read bucket activity from telemetry
    telemetry.count(f"bucket.{kind}")


def stats() -> Dict[str, int]:
    with _LOCK:
        return dict(STATS)


def snapshot() -> Dict[str, int]:
    """Point-in-time copy of the counters, for per-call deltas: the
    process-wide ``STATS`` survive across serve invocations, so any
    hit rate quoted for *one* call must diff two snapshots
    (``delta``), not read the globals."""
    return stats()


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Per-key counter growth since ``before`` (a ``snapshot()``)."""
    now = stats()
    return {k: now.get(k, 0) - before.get(k, 0)
            for k in set(now) | set(before)}


def delta_hit_rate(d: Dict[str, int]) -> float:
    """``hit_rate`` over one ``delta()`` window; 0.0 on no lookups."""
    served = d.get("exact_hits", 0) + d.get("warm_hits", 0)
    total = served + d.get("misses", 0)
    return served / total if total else 0.0


def hit_rate() -> float:
    """(exact + warm) / all lookups under bucketing; 0.0 when unused."""
    s = stats()
    served = s["exact_hits"] + s["warm_hits"]
    total = served + s["misses"]
    return served / total if total else 0.0


def reset_stats() -> None:
    with _LOCK:
        STATS.clear()
        STATS.update(_zero())


def _sync_cuda() -> None:
    """Wait for this thread's CUDA work (none when CUDA never started)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def schedule_retune(tag: str, retune: Callable[[], object], *,
                    certify: Callable[[object], Tuple[bool, str]],
                    promote: Callable[[object], None],
                    policy: resilience.Policy) -> Optional[threading.Thread]:
    """Run ``retune()`` on a daemon thread under the policy deadline;
    ``certify(plan)`` gates ``promote(plan)`` -- an uncertified winner
    is discarded and recorded, never promoted.  Deduplicated on
    ``tag`` (one in-flight re-tune per exact cache key).  The work runs
    on the thread itself, so ``drain`` waits for all of it: a re-tune
    that finishes past the deadline is abandoned (recorded as a
    ``deadline`` event), not promoted.  Its CUDA work is synchronized
    before ``promote``.  Expected failures (deadline, lowering, a build
    error, injected faults) degrade to a recorded event; unexpected
    exceptions from the exploration itself are still confined to the
    worker thread."""
    with _LOCK:
        if tag in _INFLIGHT:
            return None
        _INFLIGHT.add(tag)
        STATS["retunes"] += 1
    telemetry.count("bucket.retunes")

    def worker() -> None:
        # the daemon thread gets its own lane in the exported trace
        # (the span records this thread's name/ident)
        with telemetry.span("buckets.retune", tag=tag) as sp:
            try:
                t0 = time.perf_counter()
                plan = retune()
                elapsed = time.perf_counter() - t0
                if policy.timeout_s and elapsed > policy.timeout_s:
                    raise resilience.DeadlineExceeded(
                        f"retune:{tag} took {elapsed:.3g}s, past the "
                        f"{policy.timeout_s:g}s deadline")
                ok, reason = certify(plan)
                _sync_cuda()
                if not ok:
                    note("retune_failures")
                    sp.set(outcome="certify-failed")
                    resilience.record("retune", "certify-failed", tag,
                                      "discarded", reason)
                    return
                promote(plan)
                note("promotions")
                sp.set(outcome="promoted")
            except resilience.EXPECTED_ERRORS as e:
                note("retune_failures")
                sp.set(outcome="abandoned")
                resilience.record("retune", resilience.classify(e), tag,
                                  "abandoned", str(e))
            except Exception:  # a bug: recorded, kept in the thread
                note("retune_failures")
                sp.set(outcome="error")
                resilience.record("retune", "bug", tag, "abandoned",
                                  traceback.format_exc())
            finally:
                with _LOCK:
                    _INFLIGHT.discard(tag)

    t = threading.Thread(target=worker, daemon=True,
                         name=f"repro-retune-{tag[:24]}")
    with _LOCK:
        _THREADS.append(t)
    t.start()
    return t


def drain(timeout: float = 60.0) -> None:
    """Join outstanding background re-tunes (tests and chip_smoke.py
    call this before asserting on promotions).  Raises
    ``resilience.DeadlineExceeded`` when one is still running after
    ``timeout`` seconds: ``drain`` never returns with work in flight."""
    with _LOCK:
        pending = list(_THREADS)
        _THREADS.clear()
    t_end = time.monotonic() + timeout
    for t in pending:
        t.join(max(t_end - time.monotonic(), 0.0))
    alive = [t.name for t in pending if t.is_alive()]
    if alive:
        with _LOCK:
            _THREADS.extend(t for t in pending if t.is_alive())
        raise resilience.DeadlineExceeded(
            f"re-tunes still running after {timeout:g}s: {alive}")
