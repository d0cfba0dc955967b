"""Tile-size design-space exploration (paper §4): single patterns and
joint tile/fusion search for pipelines, analytic or measured.

    "In future work, tile sizes for all pattern dimensions will instead
     be determined by the compiler through automated tile size selection
     using modeling and design space exploration."  (paper, §4)

This is the JAX reference's ``dse`` on the card:

* ``explore`` (one untiled pattern) enumerates lane/sublane-aligned
  divisor tiles for every named pattern domain (``tile_space``),
  crossed with the metapipeline buffer depths, tiles each candidate
  with ``strip_mine.tile`` and prices it (``price``): main-memory reads
  over the tier's bandwidth, scaled by the metapipeline schedule's
  overlap, with ``depth x`` on-chip bytes charged per stage buffer.
  The argmin is a ``TilePlan``: fewest words, then modeled seconds,
  then the shallowest depth, then the largest footprint.
* ``explore_pipeline`` (a pipeline DAG) does the same for the shared
  streaming tile of the fused megakernel and, when nothing fused fits,
  splits the DAG at its cheapest contiguous topological cuts by a
  prefix DP.

Both prune what busts the on-chip budget (the paper's BRAM-capacity
compile check; on the GPU the shared memory one block may use).  Handed
``cost.TPU`` the DSE reproduces the reference's plans exactly; by
default it plans for the card a run is on (``cost.device_tier``).

Measured mode (``measure="top_k"``): the analytic shortlist's top ``k``
candidates are built with nvcc (all at once, outside any deadline),
lowered through the CUDA templates (``codegen_cuda.lower_for_timing``)
and timed on the card (``core.measure``: warm-up excluded, median of
``repeat``, a device-keyed timing DB); the fastest candidate that
certifies against the eager oracle (``resilience.certify_*``) wins, and
the samples refit the device's calibration profile (``core.calibrate``)
that later analytic pricing uses.  A candidate no template takes is
recorded as ``lower-unsupported`` and dropped: on the card the oracle is
never timed.  Plans and measurements are cached (``TuningCache``, keyed
by the program, the constraints, the tier, the device kind and the
calibration hash), so a second exploration lowers and runs nothing.
Deadlines, retries, quarantine and crash-safe stores come from
``core.resilience``; spans and counters from ``core.telemetry``.

Shape-bucketed warm starts (``bucketing=True``, the reference's
``core/buckets``) are not part of the port yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import operator
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from . import calibrate, ir, resilience, telemetry
from . import measure as measure_mod
from . import pipeline as plmod
from .cost import TPU, Tier, device_tier, stream_seconds, traffic
from .memory import plan_memory
# The exploration-option constants and the Options surface live in
# core.options (a leaf module); re-exported here as the reference does.
from .options import (DEPTHS, MAX_POINTS, MEASURE_REPEAT,  # noqa: F401
                      MEASURE_WARMUP, MXU, SUBLANE, TOP_K, UNSET, Options,
                      refuse_bucketing)
from .scheduling import build_schedule, model_speedup
from .strip_mine import insert_tile_copies, strip_mine, tile

# Cost/memory-model revision, folded into every tuning-cache key (the
# reference's: the port prices with the same model).
MODEL_VERSION = 5

# min-tile row (sublane) multiples per dtype: the fp32 8-row tile
# becomes 16 rows for bf16/f16 and 32 for int8/fp8 (packed sublanes)
_DTYPE_SUBLANE = {
    "bfloat16": 16, "float16": 16, "half": 16,
    "int8": 32, "uint8": 32,
    "float8_e4m3fn": 32, "float8_e5m2": 32, "float8_e4m3b11fnuz": 32,
}


def dtype_sublane(dtype) -> int:
    """Sublane (row) alignment for a dtype's minimum tile."""
    return _DTYPE_SUBLANE.get(str(dtype), SUBLANE)


# the one part of the reference's tuning runtime the port refuses:
# shape-bucketed warm starts (``Options.resolved`` calls it)
_refuse_tuning_runtime = refuse_bucketing


def _measure_mode(measure: Optional[str]) -> Optional[str]:
    """Validate a resolved ``measure`` value (``Options.from_env`` is the
    single env reader, merged by ``_resolve_options``)."""
    if measure in (None, False, ""):
        return None
    if measure != "top_k":
        raise ValueError(f"measure={measure!r}; supported: None, 'top_k'")
    return measure


def _resolve_options(options: Optional[Options], **kw) -> Options:
    """Merge one exploration's option layers: explicit kwarg >
    ``options=Options(...)`` > ``Options.from_env()`` > defaults.
    Returns a fully resolved ``Options`` (no ``UNSET`` fields)."""
    explicit = Options(**{k: v for k, v in kw.items()
                          if v is not None and v is not UNSET})
    return Options.merged(explicit, options or Options(),
                          Options.from_env()).resolved()


def _resolve_profile(profile, kind: str):
    """``None`` -> the device kind's persisted calibration profile (if
    any), ``False`` -> uncalibrated, else the given profile."""
    if profile is False:
        return None
    if profile is None:
        return calibrate.load_profile(kind)
    return profile


def axis_candidates(extent: int, align: int = MXU, *,
                    sublane: int = 1) -> List[int]:
    """Divisors of ``extent`` that are multiples of both
    ``min(align, extent)`` and the dtype ``sublane``, falling back to
    the full extent (which is always a candidate)."""
    floor = min(align, extent)
    divs: List[int] = []
    d = 1
    while d * d <= extent:
        if extent % d == 0:
            divs.append(d)
            if d != extent // d:
                divs.append(extent // d)
        d += 1
    out = sorted(c for c in divs
                 if c == extent
                 or (c % floor == 0 and c % sublane == 0))
    return out or [extent]


def tier_of(tier: Optional[Tier], device) -> Tier:
    """``tier``, else the tier of ``device`` (the card unless the caller
    names another device; raises without one)."""
    if tier is not None:
        return tier
    from ..device import resolve
    return device_tier(resolve(device))


@dataclasses.dataclass(frozen=True)
class _Target:
    """What one exploration plans for and where it measures: the tier
    priced, the on-chip budget, the device kind keying its stores, and
    the device candidates run on (measured mode only)."""

    tier: Tier
    vmem_budget: int
    kind: str
    device: Optional[torch.device]


def _target(tier: Optional[Tier], device, vmem_budget: Optional[int],
            measured: bool) -> _Target:
    """Resolve an exploration's ``_Target``.  Measured mode runs on
    ``device`` (the card unless the caller names another; raises
    without one); an analytic exploration needs a device only to find
    its tier (``tier=None``).  The device kind keys the stores either
    way: ``device``'s, else the card's when there is one, else the
    CPU's."""
    from ..device import resolve

    dev = resolve(device) if (measured or tier is None
                              or device is not None) else None
    tier = tier if tier is not None else device_tier(dev)
    budget = tier.onchip_bytes if vmem_budget is None else int(vmem_budget)
    return _Target(tier, budget, measure_mod.device_kind(dev),
                   dev if measured else None)


def _tier_sig(tier: Tier) -> Tuple:
    """The tier's constants, part of every plan key: one device kind may
    plan for several tiers (the CPU, handed ``cost.TPU`` or an H100)."""
    return ("tier", tier.name, float(tier.hbm_bytes_per_s),
            float(tier.peak_flops), float(tier.dma_latency_s))


# --------------------------------------------------------------------
# Tile plans
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """DSE result for one pattern: per-pattern tile sizes plus the
    model's accounting.

    ``depths`` maps each tiled pattern name to the metapipeline buffer
    depth the search selected (one searched depth per plan, recorded per
    pattern like ``sizes``); ``depth`` is the scalar view.  The JSON form
    is the reference's, so a plan carries across the two packages.
    """

    sizes: Dict[str, Tuple[int, ...]]
    traffic_words: int
    vmem_bytes: int
    modeled_seconds: float
    explored: int = 0        # candidates priced
    pruned: int = 0          # candidates rejected by the on-chip budget
    thinned: bool = False    # search space was capped (MAX_POINTS)
    cached: bool = False     # served from the tuning cache
    measured: bool = False   # winner backed by a real timing
    measured_seconds: float = 0.0   # winner's median wall time
    timed: int = 0           # candidates actually lowered and timed
    depths: Dict[str, int] = dataclasses.field(default_factory=dict)
    key: str = ""            # tuning-cache key (dse.explain provenance)

    @property
    def depth(self) -> int:
        """The plan's stage-buffer depth (2 when unrecorded)."""
        return next(iter(self.depths.values()), 2)

    def to_json(self) -> Dict:
        return {
            "sizes": {k: list(v) for k, v in self.sizes.items()},
            "depths": {k: int(v) for k, v in self.depths.items()},
            "traffic_words": int(self.traffic_words),
            "vmem_bytes": int(self.vmem_bytes),
            "modeled_seconds": float(self.modeled_seconds),
            "explored": int(self.explored),
            "pruned": int(self.pruned),
            "thinned": bool(self.thinned),
            "measured": bool(self.measured),
            "measured_seconds": float(self.measured_seconds),
            "timed": int(self.timed),
            "key": str(self.key),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "TilePlan":
        return cls(sizes={k: tuple(v) for k, v in d["sizes"].items()},
                   depths={k: int(v)
                           for k, v in d.get("depths", {}).items()},
                   traffic_words=int(d["traffic_words"]),
                   vmem_bytes=int(d["vmem_bytes"]),
                   modeled_seconds=float(d["modeled_seconds"]),
                   explored=int(d.get("explored", 0)),
                   pruned=int(d.get("pruned", 0)),
                   thinned=bool(d.get("thinned", False)),
                   measured=bool(d.get("measured", False)),
                   measured_seconds=float(d.get("measured_seconds", 0.0)),
                   timed=int(d.get("timed", 0)),
                   key=str(d.get("key", "")),
                   cached=True)


# --------------------------------------------------------------------
# Persistent tuning cache
# --------------------------------------------------------------------


def default_cache_path() -> str:
    return measure_mod.cache_sibling_path("dse_cache.json",
                                          "REPRO_DSE_CACHE")


# reserved top-level key of the cache document: the candidate
# quarantine (plan keys are 32-hex digests, so no collision is possible)
QUARANTINE_KEY = "__quarantine__"


class TuningCache:
    """On-disk key -> plan store, crash-safe.

    Persistence goes through ``core.resilience``'s store layer:
    checksummed JSON, atomic replace, lock-protected read-modify-write
    on every put (concurrent explorations merge instead of clobbering),
    and a truncated or corrupt file is quarantined to
    ``<path>.corrupt`` (a warning names it) with the cache rebuilding
    fresh -- the cache is an accelerator, never a correctness
    dependency.

    The same document persists the **candidate quarantine**: a
    candidate whose lowering, timing or certification failed is
    recorded under ``__quarantine__`` (keyed per device kind and
    plain/kernel mode) and is never re-attempted by later explorations.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, Dict]] = None

    def _load(self) -> Dict[str, Dict]:
        if self._data is None:
            self._data = resilience.load_store(self.path,
                                               label="DSE tuning cache")
        return self._data

    def _update(self, mutate) -> None:
        """Apply ``mutate(data)`` to the in-memory view AND, under the
        file lock, to the freshly re-read on-disk state -- entries a
        concurrent process wrote between our load and this put
        survive, and our view keeps its own entries even when the
        write fails (read-only FS)."""
        mine = self._load()
        mutate(mine)
        disk = resilience.locked_update(self.path, mutate,
                                        label="DSE tuning cache",
                                        prefix=".dse_cache.")
        q = {**mine.get(QUARANTINE_KEY, {}),
             **disk.get(QUARANTINE_KEY, {})}
        merged = {**mine, **disk}
        if q:
            merged[QUARANTINE_KEY] = q
        self._data = merged

    def get(self, key: str, cls=None):
        """Fetch a plan; ``cls`` selects the plan dataclass (default
        ``TilePlan``; ``PipelinePlan`` for joint pipeline plans)."""
        d = self._load().get(key)
        if d is None:
            return None
        try:
            return (cls or TilePlan).from_json(d)
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, key: str, plan) -> None:
        doc = plan.to_json()
        self._update(lambda data: data.__setitem__(key, doc))

    def quarantine(self, key: str, kind: str, detail: str = "") -> None:
        """Persist a failed candidate so it is never re-attempted."""
        entry = {"kind": kind, "detail": detail[:500]}

        def mutate(data: Dict) -> None:
            data.setdefault(QUARANTINE_KEY, {})[key] = entry

        self._update(mutate)

    def quarantined(self, key: str) -> Optional[Dict]:
        """The quarantine record for ``key`` ({"kind", "detail"}), or
        None when the candidate has never failed."""
        q = self._load().get(QUARANTINE_KEY)
        entry = q.get(key) if isinstance(q, dict) else None
        return entry if isinstance(entry, dict) else None

    def clear(self) -> None:
        self._data = {}
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _resolve_cache(cache: Union[None, bool, str, "TuningCache"]
                   ) -> Optional[TuningCache]:
    """``None`` -> default on-disk cache, path/TuningCache -> that cache,
    ``False`` -> no caching."""
    if cache is False:
        return None
    if cache is None:
        return TuningCache()
    if isinstance(cache, str):
        return TuningCache(cache)
    return cache


def _reads_sig(p: ir.Pattern, enc: int = 0) -> Tuple:
    """Access descriptors in pre-order: (src, window, affine, index map).

    ``ir.signature`` covers domains/nesting/loads but not reads, and an
    untiled program carries all its shape information in reads -- two
    programs differing only in an access window must not share a key.
    Index maps are probed best-effort (non-affine maps hash as opaque).
    """
    from .affine import AffineMap

    out: List = []
    stack = enc + len(p.domain)
    for a in p.accesses:
        src = a.src.name if isinstance(a.src, ir.Tensor) \
            else type(a.src).__name__
        if isinstance(a.index_map, AffineMap):
            m: object = (a.index_map.base, a.index_map.mat)
        else:
            try:
                amap = AffineMap.probe(a.index_map, stack)
                m = (amap.base, amap.mat)
            except (TypeError, ValueError, IndexError):
                m = "nonaffine"
        out.append((src, tuple(a.window), a.affine, m))
        if isinstance(a.src, ir.Pattern):
            out.append(_reads_sig(a.src, stack))
    if p.inner is not None:
        out.append(_reads_sig(p.inner, stack))
    return tuple(out)


def _key_context(device: Optional[str],
                 profile_hash: Optional[str]) -> Tuple[str, str]:
    """(device kind, calibration-profile hash) folded into every cache
    key: a plan tuned on one device, or priced under one calibration,
    must not be replayed on another device / after recalibration.
    Explicit values (including ``""`` to opt out, e.g. for timing-DB
    keys that identify the *computation*, not its pricing) pass through.
    """
    if device is None:
        device = measure_mod.device_kind()
    if profile_hash is None:
        profile_hash = calibrate.active_profile_hash(device)
    return device, profile_hash


def pattern_key(p: ir.Pattern, *,
                vmem_budget: int = TPU.onchip_bytes,
                align: int = MXU,
                extra: Tuple = (),
                device: Optional[str] = None,
                profile_hash: Optional[str] = None) -> str:
    """Tuning-cache key: structural signature + access descriptors +
    input shapes/dtypes + exploration constraints + device kind +
    calibration-profile hash (the reference's key; ``explore`` adds the
    tier to ``extra``)."""
    device, profile_hash = _key_context(device, profile_hash)
    inputs = tuple((t.name, tuple(t.shape), t.dtype)
                   for t in ir.inputs_of(p))
    raw = repr((MODEL_VERSION, device, profile_hash,
                ir.signature(p), _reads_sig(p), inputs,
                int(vmem_budget), int(align), tuple(extra)))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


# --------------------------------------------------------------------
# Single patterns: enumeration and pricing
# --------------------------------------------------------------------


def tile_space(p: ir.Pattern, *, align: int = MXU
               ) -> Dict[str, List[Tuple[int, ...]]]:
    """Per-named-pattern candidate tile tuples for every untiled domain
    (the design space is their cross product).  Patterns that already
    carry a strided domain are left alone; rows are aligned to the
    pattern dtype's sublane multiple."""
    space: Dict[str, List[Tuple[int, ...]]] = {}
    for q in ir.walk(p):
        if q.strided or not q.domain or q.name in space:
            continue
        sub = dtype_sublane(q.dtype)
        per_dim = [axis_candidates(d, align, sublane=sub) for d in q.domain]
        space[q.name] = [tuple(c) for c in itertools.product(*per_dim)]
    return space


def _thin(space: Dict[str, List[Tuple[int, ...]]],
          max_points: int) -> Tuple[Dict[str, List[Tuple[int, ...]]], bool]:
    """Halve the densest axis list (keeping endpoints) until the cross
    product is within budget.  Returns (space, was_thinned)."""
    def total(s):
        t = 1
        for v in s.values():
            t *= len(v)
        return t

    thinned = False
    space = {k: list(v) for k, v in space.items()}
    while total(space) > max_points:
        name = max(space, key=lambda k: len(space[k]))
        v = space[name]
        if len(v) <= 2:
            break
        space[name] = v[::2] if v[-1] == v[::2][-1] else v[::2] + [v[-1]]
        thinned = True
    return space, thinned


def grid_steps(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]]) -> int:
    """Grid steps the tiled program executes: the product of extent /
    tile over every tiled domain (the trip count the calibration model
    charges per-step overhead against)."""
    steps = 1
    for q in ir.walk(p):
        if q.name not in sizes or not q.domain:
            continue
        for d, s in zip(q.domain, sizes[q.name]):
            steps *= max(1, -(-d // max(int(s), 1)))
    return steps


def _tile_ir(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]],
             vmem_budget_words: int) -> ir.Pattern:
    """``tile(p, sizes)``, or strip mining plus tile copies alone where
    interchange or stage lifting does not apply (recorded once per
    pattern, as the reference does)."""
    try:
        return tile(p, sizes, vmem_budget_words=vmem_budget_words)
    except resilience.EXPECTED_ERRORS as e:
        resilience.record_once(
            "tile", resilience.classify(e),
            f"{type(p).__name__}:{p.name}", "fallback",
            f"tile() failed ({e}); strip-mine+copies fallback")
        return insert_tile_copies(strip_mine(p, sizes),
                                  vmem_budget_words=vmem_budget_words)


@dataclasses.dataclass(frozen=True)
class Priced:
    sizes: Dict[str, Tuple[int, ...]]
    traffic_words: int
    vmem_bytes: int
    modeled_seconds: float           # uncalibrated analytic prediction
    calibrated_seconds: float = -1.0  # profile-adjusted (== analytic
    steps: int = 1                    # when uncalibrated); grid steps
    depth: int = 2                    # metapipeline buffer depth

    def __post_init__(self):
        if self.calibrated_seconds < 0:
            object.__setattr__(self, "calibrated_seconds",
                               self.modeled_seconds)


def price(p: ir.Pattern, sizes: Dict[str, Tuple[int, ...]], *, tier: Tier,
          vmem_budget: int, profile=None, depth: int = 2
          ) -> Optional[Priced]:
    """Tile ``p`` with ``sizes`` and price it at stage-buffer ``depth``;
    None if it busts the on-chip budget.

    Modeled seconds = the tiled IR's main-memory reads over the tier's
    bandwidth, scaled by the metapipeline time ratio of its schedule
    (steady state vs. sequential, with whatever load issue latency
    ``depth - 1`` steps of lookahead cannot hide).  With a calibration
    profile (a ``calibrate.CalibrationProfile``; None is uncalibrated)
    ``calibrated_seconds`` reprices the same stream at the measured
    effective bandwidth plus the per-pattern overhead per grid step."""
    t = _tile_ir(p, sizes, vmem_budget // 4)
    plan = plan_memory(t, vmem_budget_bytes=vmem_budget, depth=depth)
    if not plan.fits:
        return None
    # an affine tensor read left in place means its tile copy would not
    # fit on chip (insert_tile_copies' streaming fallback): over budget
    for q in ir.walk(t):
        for a in q.accesses:
            if isinstance(a.src, ir.Tensor) and a.affine:
                return None
    tr = traffic(t)
    seconds = stream_seconds(tr.total_reads, tier=tier)
    mp = build_schedule(t, vmem_budget // 4, depth=depth)
    if mp is not None:
        body_words = sum(s.words for s in mp.stages if s.kind == "body")
        seq, pipe, _ = model_speedup(mp, flops_per_body=body_words * 100.0,
                                     tier=tier)
        if seq > 0 and pipe > 0:
            seconds *= pipe / seq
    steps = grid_steps(p, sizes)
    calibrated = calibrate.predicted_seconds(
        type(p).__name__, seconds * tier.hbm_bytes_per_s, steps,
        profile=profile, tier=tier)
    return Priced(dict(sizes), tr.total_reads, plan.total_bytes, seconds,
                  calibrated, steps, depth=depth)


def _rank_key(a: Priced) -> Tuple:
    # depth breaks seconds ties BEFORE the -vmem reuse term: once the
    # exposed-latency term saturates, deeper variants tie on seconds
    # and their larger footprint must not win via the reuse preference
    return (a.traffic_words, a.calibrated_seconds, a.depth, -a.vmem_bytes)


def _better(a: Priced, b: Optional[Priced]) -> bool:
    """Lexicographic: traffic, then (calibrated) modeled time, then
    shallowest depth, then prefer reuse."""
    if b is None:
        return True
    return _rank_key(a) < _rank_key(b)


def shortlist(p: ir.Pattern, *, tier: Tier, vmem_budget: int,
              align: int = MXU,
              space: Optional[Dict[str, List[Tuple[int, ...]]]] = None,
              max_points: int = MAX_POINTS, profile=None,
              depths: Tuple[int, ...] = DEPTHS
              ) -> Tuple[List[Priced], bool, int, int]:
    """Every feasible (tile sizes, depth) candidate, priced (``profile``:
    a calibration profile or None) and sorted best-first.  Returns
    ``(candidates, thinned, explored, pruned)``; the analytic argmin is
    ``candidates[0]``, measured mode lowers and times the top ``k``."""
    if space is None:
        space = tile_space(p, align=align)
    space, thinned = _thin(space, max_points)
    names = sorted(space)
    cands: List[Priced] = []
    explored = pruned = 0
    for combo in itertools.product(*(space[n] for n in names)):
        sizes = dict(zip(names, combo))
        for d in depths:
            priced = price(p, sizes, tier=tier, vmem_budget=vmem_budget,
                           profile=profile, depth=d)
            explored += 1
            if priced is None:
                pruned += 1
                continue
            cands.append(priced)
    cands.sort(key=_rank_key)
    return cands, thinned, explored, pruned


# --------------------------------------------------------------------
# Measured mode: build, time, observe
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CandidateTiming:
    """One shortlisted candidate, actually lowered and timed."""

    sizes: Dict[str, Tuple[int, ...]]
    traffic_words: int
    vmem_bytes: int
    analytic_seconds: float      # uncalibrated model prediction
    calibrated_seconds: float    # profile-adjusted model prediction
    steps: int
    measurement: measure_mod.Measurement
    lowering: str                # "cuda" | "oracle" (CPU) | "cached"
    depth: int = 2               # metapipeline buffer depth


def _workload_tag(p: ir.Pattern) -> str:
    shapes = "+".join(f"{t.name}:{'x'.join(map(str, t.shape))}"
                      for t in ir.inputs_of(p))
    return f"{type(p).__name__}:{p.name}:{shapes}"


def _top_distinct_sizes(cands: List[Priced], k: int) -> List[Priced]:
    """Best-first prefix of ``cands`` with at most one entry per tile
    assignment (the reference's rule: its single-pattern templates leave
    buffering to the Pallas pipeliner, so depth variants of one tile are
    one executable).  The port lowers the kept candidate at its own
    ranked depth."""
    out: List[Priced] = []
    seen = set()
    for c in cands:
        sig = tuple(sorted((n, tuple(v)) for n, v in c.sizes.items()))
        if sig in seen:
            continue
        seen.add(sig)
        out.append(c)
        if len(out) >= k:
            break
    return out


def _build_candidates(lowerings, *, db, device) -> None:
    """Build the kernels of every candidate not yet in the timing DB,
    before any of them is timed: one ``kernels.build.compile_all``, an
    nvcc process per translation unit, all at once, outside every
    deadline and timed window.  ``lowerings`` are ``(timing key,
    thunk)`` pairs; a thunk lowers its candidate without launching and
    returns the lowered call (a candidate no template takes raises, and
    its timing records why).  Nothing to build off the card.  The build
    seconds and nvcc processes go to the counters ``dse.build_s`` and
    ``dse.builds``."""
    from ..kernels import build
    from .codegen_cuda import kernel_sources

    if device is None or device.type != "cuda":
        return
    tdb = measure_mod.resolve_db(db, device)
    items = []
    for key, lower_fn in lowerings:
        if tdb is not None and tdb.get(key) is not None:
            continue
        try:
            items.extend(kernel_sources(lower_fn()))
        except resilience.EXPECTED_ERRORS:
            continue
    if not items:
        return
    n0 = build.compile_all.builds
    t0 = time.perf_counter()
    with telemetry.span("dse.build", sources=len(items)) as sp:
        try:
            build.compile_all(items)
        except RuntimeError as e:
            # the candidates whose nvcc failed rebuild when timed, and
            # are quarantined there as compile errors
            resilience.record("build", "compile-error", "compile_all",
                              "fallback", str(e)[:500])
        sp.set(builds=build.compile_all.builds - n0)
    telemetry.count("dse.build_s", time.perf_counter() - t0)
    telemetry.count("dse.builds", build.compile_all.builds - n0)


def _time_candidates(p: ir.Pattern, top: List[Priced], *,
                     target: _Target, align: int,
                     timing_db, warmup: int, repeat: int,
                     policy: Optional[resilience.Policy] = None,
                     cache: Optional[TuningCache] = None
                     ) -> List[CandidateTiming]:
    """Build, lower and time shortlisted candidates on
    ``target.device`` (timing-DB memoized).

    Every candidate's kernels are built first (``_build_candidates``);
    then each lower+time runs under the resilience policy's deadline
    with transient retry; an expected failure (no template, a launch
    the card refuses, deadline miss, injected fault) classifies the
    candidate, records a structured event, and -- when ``cache`` is
    given -- quarantines it so no later exploration re-attempts it.
    Unexpected exceptions and sticky CUDA errors propagate.
    """
    from .codegen_cuda import lower_candidate, lower_for_timing

    pol = resilience.resolve_policy(policy)
    dev = target.device
    vmem_budget = target.vmem_budget
    todo = []
    for cand in top:
        sizes_sig = tuple(sorted((k, tuple(v))
                                 for k, v in cand.sizes.items()))
        # identifies the computation, not its pricing: no device /
        # profile-hash component (the timing DB adds the device)
        key = pattern_key(p, vmem_budget=vmem_budget, align=align,
                          extra=("timing", sizes_sig),
                          device="", profile_hash="")
        qkey = "time|" + measure_mod.TimingDB.full_key(key, device=dev)
        if cache is not None:
            q = cache.quarantined(qkey)
            if q is not None:
                resilience.record_once(
                    "time", q.get("kind", "unknown"), qkey, "skipped",
                    "previously quarantined candidate not re-attempted")
                continue
        todo.append((cand, key, qkey))
    _build_candidates(
        [(key, lambda c=cand: lower_candidate(
            p, c.sizes, vmem_budget=vmem_budget, device=dev,
            depth=c.depth)) for cand, key, _ in todo],
        db=timing_db, device=dev)

    out: List[CandidateTiming] = []
    for cand, key, qkey in todo:
        how = ["cached"]

        def make_fn(cand=cand, how=how):
            fn, how[0] = lower_for_timing(p, cand.sizes,
                                          vmem_budget=vmem_budget,
                                          device=dev, depth=cand.depth)
            return fn

        try:
            m = resilience.call_guarded(
                lambda: measure_mod.timed(key, make_fn, db=timing_db,
                                          warmup=warmup, repeat=repeat,
                                          device=dev),
                stage="time", key=qkey, policy=pol)
        except resilience.CandidateFailure as e:
            resilience.record("time", e.kind, qkey, "quarantined",
                              e.detail)
            if cache is not None:
                cache.quarantine(qkey, e.kind, e.detail)
            continue
        out.append(CandidateTiming(
            sizes=dict(cand.sizes), traffic_words=cand.traffic_words,
            vmem_bytes=cand.vmem_bytes,
            analytic_seconds=cand.modeled_seconds,
            calibrated_seconds=cand.calibrated_seconds,
            steps=cand.steps, measurement=m, lowering=how[0],
            depth=cand.depth))
    return out


def _accuracy_gauges(kind: str, pairs: List[Tuple[float, float]]) -> None:
    """Model-accuracy gauges per pattern family, from one measured
    shortlist's (calibrated prediction, measured median) pairs:
    ``model.drift.<kind>`` the mean relative |predicted - measured| /
    measured, ``model.spearman.<kind>`` the rank correlation of the
    analytic ordering against the measured one (always on)."""
    if not pairs:
        return
    drift = sum(abs(p - m) / max(m, 1e-12) for p, m in pairs) / len(pairs)
    telemetry.gauge(f"model.drift.{kind}", drift)
    if len(pairs) >= 2:
        telemetry.gauge(f"model.spearman.{kind}",
                        measure_mod.spearman([p for p, _ in pairs],
                                             [m for _, m in pairs]))


def _observe(p_kind: str, workload: str, timings: List[CandidateTiming],
             target: _Target) -> None:
    bw = target.tier.hbm_bytes_per_s
    samples = [calibrate.Sample(
        workload=workload, kind=p_kind,
        stream_bytes=t.analytic_seconds * bw,
        steps=t.steps, measured_s=t.measurement.median_s,
        key=f"{workload}|{sorted(t.sizes.items())}")
        for t in timings]
    if samples:
        calibrate.observe(samples, device=target.kind, tier=target.tier)
    _accuracy_gauges(p_kind, [(t.calibrated_seconds,
                               t.measurement.median_s)
                              for t in timings])


def _record_plan(plan, *, source: str, **extra) -> None:
    """Stash a plan's exploration provenance for ``explain`` (tracing
    only; the record store is a bounded LRU in ``core.telemetry``).
    Merges into any existing record under the same key: a cache hit
    updates ``source`` without losing the original exploration's rank
    tables."""
    if not telemetry.enabled() or not plan.key:
        return
    prev = telemetry.get_record("plan", plan.key)
    payload = dict(prev) if isinstance(prev, dict) else {}
    payload.update({"source": source, **extra})
    telemetry.put_record("plan", plan.key, payload)


def _no_winner(tag: str, timed: int, failures: List[str]) -> None:
    """Record why measured mode shipped the analytic plan: as
    ``lower-unsupported`` when no shortlisted candidate has a template
    (nothing could be timed), else as ``no-measured-winner``."""
    if timed == 0 and failures and all(k == "lower-unsupported"
                                       for k in failures):
        resilience.record(
            "explore", "lower-unsupported", tag, "fallback",
            f"no template takes any of {len(failures)} shortlisted "
            "candidates; analytic argmin promoted")
        return
    resilience.record(
        "explore", "no-measured-winner", tag, "fallback",
        f"{timed} timed, 0 certified; analytic argmin promoted instead")


def _failures_since(n_events: int) -> List[str]:
    """The kinds of the candidates that failed timing (quarantined or
    skipped) since the log held ``n_events`` timing events."""
    return [e.kind for e in resilience.LOG.events(stage="time")[n_events:]
            if e.action in ("quarantined", "skipped")]


def measured_shortlist(p: ir.Pattern, *, top_k: int = TOP_K,
                       tier: Optional[Tier] = None,
                       vmem_budget: Optional[int] = None, device=None,
                       align: int = MXU,
                       space: Optional[Dict[str, List[Tuple[int, ...]]]]
                       = None,
                       max_points: int = MAX_POINTS,
                       profile=None,
                       timing_db=None,
                       warmup: int = MEASURE_WARMUP,
                       repeat: int = MEASURE_REPEAT,
                       calibrate_update: bool = True,
                       policy: Optional[resilience.Policy] = None,
                       cache: Union[None, bool, str, TuningCache] = False
                       ) -> List[CandidateTiming]:
    """The measured step as a library call: analytic shortlist, build,
    lower and time the top ``k`` on ``device`` (the card unless the
    caller names another), optionally fold the samples into the
    device's calibration profile.  ``policy`` bounds each lower+time
    with a deadline and transient retry; ``cache`` (default off for the
    library call) enables the persistent candidate quarantine shared
    with ``explore``."""
    target = _target(tier, device, vmem_budget, measured=True)
    cands, _, _, _ = shortlist(
        p, tier=target.tier, vmem_budget=target.vmem_budget, align=align,
        space=space, max_points=max_points,
        profile=_resolve_profile(profile, target.kind))
    timings = _time_candidates(p, _top_distinct_sizes(cands,
                                                      max(top_k, 1)),
                               target=target, align=align,
                               timing_db=timing_db, warmup=warmup,
                               repeat=repeat, policy=policy,
                               cache=_resolve_cache(cache))
    if calibrate_update:
        _observe(type(p).__name__, _workload_tag(p), timings, target)
    return timings


# --------------------------------------------------------------------
# Single patterns: exploration
# --------------------------------------------------------------------


def explore(p: ir.Pattern, *, tier: Optional[Tier] = None,
            vmem_budget: Optional[int] = None, device=None,
            align: Optional[int] = None,
            space: Optional[Dict[str, List[Tuple[int, ...]]]] = None,
            cache: Union[None, bool, str, TuningCache] = None,
            max_points: Optional[int] = None,
            measure: Optional[str] = None,
            top_k: Optional[int] = None,
            timing_db=None,
            profile=None,
            warmup: Optional[int] = None,
            repeat: Optional[int] = None,
            depths: Optional[Tuple[int, ...]] = None,
            policy: Optional[resilience.Policy] = None,
            bucketing: Optional[bool] = None,
            options: Optional[Options] = None) -> TilePlan:
    """Design-space exploration over tile sizes and metapipeline buffer
    depths for one *untiled* pattern program.

    Each (sizes, depth) candidate of ``tile_space`` x ``depths`` is
    priced with ``depth x`` on-chip bytes per stage buffer and the load
    latency the depth cannot hide; the lexicographic argmin (words,
    seconds, depth, -bytes) wins.  ``tier`` defaults to the tier of
    ``device`` (the card, CUDA unless said otherwise); ``vmem_budget``
    to the tier's on-chip bytes.  ``cache``: ``None`` -> the default
    on-disk tuning cache, a path or ``TuningCache`` -> that cache,
    ``False`` -> none.  Raises ``ValueError`` when no candidate fits.

    ``measure="top_k"`` (or ``REPRO_MEASURE=top_k``) runs on ``device``:
    the top ``top_k`` distinct tile assignments are built (nvcc, all at
    once, outside any deadline), lowered through the CUDA templates and
    timed (median of ``repeat``, ``warmup`` excluded, memoized in the
    device-keyed ``timing_db``); the fastest one that certifies against
    the eager oracle wins and the samples recalibrate the device's
    profile before the plan is cached -- so a second call is a pure
    cache hit.  Failing candidates are quarantined; a candidate no
    template takes is recorded as ``lower-unsupported`` (on the card the
    oracle is never timed).  When no candidate survives the analytic
    argmin ships, recorded as a fallback event; ``explore`` never raises
    for a candidate-level failure (a sticky CUDA error propagates).

    Every keyword can instead arrive in ``options=Options(...)``:
    explicit kwarg > options > the ``REPRO_*`` env vars > defaults.
    ``bucketing=True`` raises ``NotImplementedError``.
    """
    o = _resolve_options(options, vmem_budget=vmem_budget, align=align,
                         cache=cache, max_points=max_points,
                         measure=measure, top_k=top_k,
                         timing_db=timing_db, profile=profile,
                         warmup=warmup, repeat=repeat, depths=depths,
                         policy=policy, bucketing=bucketing)
    target = _target(tier, device, o.vmem_budget, bool(o.measure))
    if o.trace:
        telemetry.enable()
    with telemetry.span("dse.explore", kind=type(p).__name__,
                        pattern=p.name) as sp:
        return _explore_body(p, space, o, target, sp)


def _explore_body(p: ir.Pattern, space, o: Options, target: _Target,
                  sp) -> TilePlan:
    vmem_budget, align = target.vmem_budget, o.align
    max_points, measure, top_k = o.max_points, o.measure, o.top_k
    depths, policy = o.depths, o.policy
    tc = _resolve_cache(o.cache)

    if space is None:
        space = tile_space(p, align=align)
    space, thinned = _thin(space, max_points)
    names = sorted(space)

    # the key covers the *resolved* candidate space, the depth set, the
    # measured mode and the tier priced (the device kind and the
    # calibration hash come from _key_context)
    space_sig = tuple((n, tuple(space[n])) for n in names)
    extra = space_sig + (("depths",) + tuple(int(d) for d in depths),) \
        + ((("measure", measure, int(top_k)),) if measure else ()) \
        + (_tier_sig(target.tier),)

    def key_now() -> str:
        return pattern_key(p, vmem_budget=vmem_budget, align=align,
                           extra=extra, device=target.kind)

    if tc is not None:
        hit = tc.get(key_now())
        if hit is not None:
            telemetry.count("dse.cache_hits")
            hit = dataclasses.replace(hit, key=key_now())
            sp.set(source="cache")
            _record_plan(hit, source="cache")
            return hit

    prof = _resolve_profile(o.profile, target.kind)
    with telemetry.span("dse.shortlist", thinned=thinned) as ssp:
        cands, _, explored, pruned = shortlist(
            p, tier=target.tier, vmem_budget=vmem_budget, align=align,
            space=space, max_points=max_points, profile=prof,
            depths=depths)
        ssp.set(explored=explored, pruned=pruned, feasible=len(cands))
    if not cands:
        raise ValueError(
            f"DSE: no tile candidate fits on-chip budget {vmem_budget} B "
            f"({explored} candidates over {names})")

    measured_s = 0.0
    timed_n = 0
    best = cands[0]
    prov_measured: List[Dict] = []
    prov_cert: List[Dict] = []
    n_short = n_timed = 0
    if measure == "top_k":
        pol = resilience.resolve_policy(policy)
        with telemetry.span("dse.measure", top_k=int(top_k)) as msp:
            top = _top_distinct_sizes(cands, max(top_k, 1))
            n_short = len(top)
            n_events = len(resilience.LOG.events(stage="time"))
            timings = _time_candidates(p, top, target=target, align=align,
                                       timing_db=o.timing_db,
                                       warmup=o.warmup, repeat=o.repeat,
                                       policy=pol, cache=tc)
            failures = _failures_since(n_events)
            _observe(type(p).__name__, _workload_tag(p), timings, target)
            ranked = sorted(timings,
                            key=lambda t: (t.measurement.median_s,
                                           t.traffic_words, t.depth,
                                           -t.vmem_bytes))
            prov_measured = [
                {"sizes": {k: list(v) for k, v in t.sizes.items()},
                 "depth": int(t.depth),
                 "median_s": float(t.measurement.median_s),
                 "lowering": t.lowering} for t in ranked]
            n_timed = len(timings)
            msp.set(shortlisted=n_short, timed=n_timed)
            for win in ranked:
                if pol.certify:
                    sig = tuple(sorted((k, tuple(v))
                                       for k, v in win.sizes.items()))
                    ckey = "certify|" + measure_mod.TimingDB.full_key(
                        pattern_key(p, vmem_budget=vmem_budget,
                                    align=align, extra=("certify", sig),
                                    device="", profile_hash=""),
                        device=target.device)
                    if tc is not None \
                            and tc.quarantined(ckey) is not None:
                        # failed certification in a past run
                        prov_cert.append(
                            {"sizes": {k: list(v)
                                       for k, v in win.sizes.items()},
                             "ok": False, "reason": "quarantined"})
                        continue
                    ok, reason = resilience.certify_guarded(
                        lambda w=win: resilience.certify_tile_plan(
                            p, w.sizes, vmem_budget=vmem_budget,
                            device=target.device, depth=w.depth),
                        key=ckey, policy=pol)
                    prov_cert.append(
                        {"sizes": {k: list(v)
                                   for k, v in win.sizes.items()},
                         "ok": bool(ok), "reason": reason})
                    if not ok:
                        resilience.record("certify", "certify-failed",
                                          ckey, "quarantined", reason)
                        if tc is not None:
                            tc.quarantine(ckey, "certify-failed", reason)
                        continue
                best = Priced(win.sizes, win.traffic_words,
                              win.vmem_bytes, win.analytic_seconds,
                              win.calibrated_seconds, win.steps,
                              depth=win.depth)
                measured_s = win.measurement.median_s
                timed_n = len(timings)
                break
            else:
                # every shortlisted candidate failed timing or
                # certification: the analytic argmin ships, uncertified
                # measured data never does
                _no_winner(_workload_tag(p), len(timings), failures)

    # key recomputed AFTER the calibration update: the next call
    # prices under the new profile hash and must hit this entry
    final_key = key_now()
    plan = TilePlan(sizes={k: tuple(v) for k, v in best.sizes.items()},
                    depths={k: int(best.depth) for k in best.sizes},
                    traffic_words=best.traffic_words,
                    vmem_bytes=best.vmem_bytes,
                    modeled_seconds=best.calibrated_seconds,
                    explored=explored, pruned=pruned, thinned=thinned,
                    measured=timed_n > 0, measured_seconds=measured_s,
                    timed=timed_n, key=final_key)
    if tc is not None:
        tc.put(final_key, plan)
    sp.set(source="explored", explored=explored, pruned=pruned,
           timed=timed_n)
    _record_plan(
        plan, source="explored",
        enumerated=explored,
        pruned={"vmem": pruned,
                "dominated": (max(len(cands) - n_short, 0)
                              if measure == "top_k" else 0),
                "measure_failures": max(n_short - n_timed, 0)},
        analytic_ranks=[
            {"sizes": {k: list(v) for k, v in c.sizes.items()},
             "depth": int(c.depth),
             "traffic_words": int(c.traffic_words),
             "calibrated_seconds": float(c.calibrated_seconds)}
            for c in cands[:max(int(top_k), 3)]],
        measured_ranks=prov_measured,
        certification=prov_cert)
    return plan


def gemm_program(m: int, n: int, k: int) -> ir.Pattern:
    """The Table 3 GEMM of the benchmark suite, untiled."""
    from ..patterns.analytics import gemm
    return gemm(m, n, k)[0]


# --------------------------------------------------------------------
# Pipelines
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Joint DSE result for a pipeline DAG: streaming tiles plus the
    fusion grouping.

    ``groups`` are contiguous ``[start, end)`` ranges over the
    pipeline's *topological* stage order; a single group spanning the
    whole DAG means fully fused (intermediates stay on chip).  More
    than one group is the split fallback: every intermediate crossing a
    group boundary round-trips main memory, and each group carries its
    own streaming tile in ``group_blocks``.  ``depths`` (parallel to
    ``group_blocks``) records each group's metapipeline buffer depth.
    ``block`` / ``depth`` are the first group's values.  The JSON form
    is the reference's, so a plan carries across the two packages.
    """

    block: int
    groups: Tuple[Tuple[int, int], ...]
    traffic_words: int            # fused plan: main-memory reads + writes
    unfused_traffic_words: int    # every intermediate round-trips
    vmem_bytes: int               # max per-group on-chip footprint
    modeled_seconds: float
    group_blocks: Tuple[int, ...] = ()
    explored: int = 0
    pruned: int = 0
    cached: bool = False
    measured: bool = False          # winner backed by a real timing
    measured_seconds: float = 0.0   # winner's median wall time
    timed: int = 0                  # candidates lowered and timed
    depths: Tuple[int, ...] = ()    # per-group stage-buffer depth
    key: str = ""                   # tuning-cache key (dse.explain)

    def __post_init__(self):
        if not self.group_blocks:
            object.__setattr__(self, "group_blocks",
                               (self.block,) * len(self.groups))
        if not self.depths:
            object.__setattr__(self, "depths", (2,) * len(self.groups))

    @property
    def depth(self) -> int:
        return self.depths[0] if self.depths else 2

    @property
    def fused(self) -> bool:
        return len(self.groups) == 1

    @property
    def traffic_ratio(self) -> float:
        """Unfused / fused main-memory words (>= 1: the fusion win)."""
        return self.unfused_traffic_words / max(self.traffic_words, 1)

    def to_json(self) -> Dict:
        return {
            "block": int(self.block),
            "groups": [list(g) for g in self.groups],
            "group_blocks": [int(b) for b in self.group_blocks],
            "depths": [int(d) for d in self.depths],
            "traffic_words": int(self.traffic_words),
            "unfused_traffic_words": int(self.unfused_traffic_words),
            "vmem_bytes": int(self.vmem_bytes),
            "modeled_seconds": float(self.modeled_seconds),
            "explored": int(self.explored),
            "pruned": int(self.pruned),
            "measured": bool(self.measured),
            "measured_seconds": float(self.measured_seconds),
            "timed": int(self.timed),
            "key": str(self.key),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "PipelinePlan":
        return cls(block=int(d["block"]),
                   groups=tuple(tuple(g) for g in d["groups"]),
                   group_blocks=tuple(int(b)
                                      for b in d.get("group_blocks", ())),
                   depths=tuple(int(x) for x in d.get("depths", ())),
                   traffic_words=int(d["traffic_words"]),
                   unfused_traffic_words=int(d["unfused_traffic_words"]),
                   vmem_bytes=int(d["vmem_bytes"]),
                   modeled_seconds=float(d["modeled_seconds"]),
                   explored=int(d.get("explored", 0)),
                   pruned=int(d.get("pruned", 0)),
                   measured=bool(d.get("measured", False)),
                   measured_seconds=float(d.get("measured_seconds", 0.0)),
                   timed=int(d.get("timed", 0)),
                   key=str(d.get("key", "")),
                   cached=True)


def pipeline_key(pipe, *, vmem_budget: int = TPU.onchip_bytes,
                 align: int = MXU, extra: Tuple = (),
                 device: Optional[str] = None,
                 profile_hash: Optional[str] = None) -> str:
    """Tuning-cache key over the pipeline's *topological DAG*
    signature: every stage's structural signature, access descriptors,
    input tensor shapes/dtypes -- hashed in canonical topological order
    -- plus the wiring edges, the output set, the exploration
    constraints, the device kind and the calibration-profile hash (the
    reference's key)."""
    device, profile_hash = _key_context(device, profile_hash)
    parts = []
    for s in plmod.topo_stages(pipe):
        inputs = tuple((t.name, tuple(t.shape), t.dtype)
                       for t in ir.inputs_of(s))
        # ir.signature omits a Map's elem_shape; the stage output shape
        # is part of the wiring, so hash it explicitly
        parts.append((s.name, ir.signature(s), _reads_sig(s), inputs,
                      s.dtype, tuple(s.shape)))
    edges = tuple(sorted(set(plmod._edges(pipe))))
    raw = repr((MODEL_VERSION, device, profile_hash, pipe.name,
                tuple(parts), edges,
                tuple(plmod.output_names(pipe)),
                int(vmem_budget), int(align), tuple(extra)))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def _pipeline_candidates(pipe, align: int = MXU,
                         max_points: int = MAX_POINTS) -> List[int]:
    sub = max(dtype_sublane(s.dtype) for s in plmod.topo_stages(pipe))
    cands = axis_candidates(pipe.shared_extent, align, sublane=sub)
    while len(cands) > max_points and len(cands) > 2:
        cands = (cands[::2] if cands[-1] == cands[::2][-1]
                 else cands[::2] + [cands[-1]])
    return cands


def _price_pipeline_group(sub_pipe, b: int, *, vmem_budget: int, tier: Tier,
                          counters: Dict[str, int], profile=None,
                          depth: int = 2):
    """Price the sub-pipeline fused at tile ``b`` with stage-buffer
    ``depth``: returns ``(words, onchip_bytes, analytic_s,
    calibrated_s, steps)`` or None when it busts the budget or cannot
    fuse.  Uncalibrated (``profile`` None), ``calibrated_s`` is the
    analytic time."""
    budget_words = max(vmem_budget // 4, 1)
    try:
        fdag = plmod.fuse_dag(sub_pipe, b, vmem_budget_words=budget_words)
    except (ValueError, NotImplementedError):
        return None
    counters["explored"] += 1
    mem = plan_memory(fdag.patterns, vmem_budget_bytes=vmem_budget,
                      depth=depth)
    if not mem.fits:
        counters["pruned"] += 1
        return None
    for t in fdag.patterns:   # streaming fallback left in place
        for q in ir.walk(t):
            for a in q.accesses:
                if isinstance(a.src, ir.Tensor) and a.affine:
                    counters["pruned"] += 1
                    return None
    reads = sum(plmod.dag_external_reads(fdag).values())
    out_w = plmod.output_words(sub_pipe)
    seconds = stream_seconds(reads + out_w, tier=tier)
    # time ratio: most conservative terminal schedule of the kernel
    # (pipe/seq < 1 is overlap speedup, > 1 exposed-latency slowdown)
    ratios = []
    for t in fdag.patterns:
        mp = build_schedule(t, budget_words, depth=depth)
        if mp is not None:
            body_words = sum(s.words for s in mp.stages
                             if s.kind in ("body", "compute"))
            seq, pipe, _ = model_speedup(
                mp, flops_per_body=body_words * 100.0, tier=tier)
            if seq > 0 and pipe > 0:
                ratios.append(pipe / seq)
    if ratios:
        seconds *= max(ratios)
    steps = int(fdag.grid)
    calibrated = calibrate.predicted_seconds(
        "Pipeline", seconds * tier.hbm_bytes_per_s, steps,
        profile=profile, tier=tier)
    return (reads + out_w, mem.total_bytes, seconds, calibrated, steps)


@dataclasses.dataclass(frozen=True)
class PipelineTiming:
    """One shortlisted fused-pipeline candidate, lowered + timed."""

    block: int
    traffic_words: int
    vmem_bytes: int
    analytic_seconds: float
    calibrated_seconds: float
    steps: int
    measurement: measure_mod.Measurement
    plan: "PipelinePlan"
    depth: int = 2               # stage-buffer depth of the megakernel


def _time_pipeline_candidates(pipe, priced: List[Tuple], *,
                              target: _Target, align: int,
                              timing_db, warmup: int, repeat: int,
                              policy: Optional[resilience.Policy] = None,
                              cache: Optional[TuningCache] = None
                              ) -> List[PipelineTiming]:
    """Build, lower and time whole fused-pipeline candidates (each a
    fully fused single-group ``PipelinePlan`` at one (block, depth)
    point) on ``target.device``.  Depth is part of the timing key: the
    megakernel's ring holds ``depth`` slots, so depth variants are
    different executables.  Same discipline as ``_time_candidates``:
    every candidate built first, then deadline + retry + quarantine
    per candidate, never a crash of the exploration."""
    from .codegen_cuda import lower_fused_pipeline, \
        lower_pipeline_for_timing

    n_stages = len(plmod.topo_stages(pipe))
    unfused = plmod.unfused_traffic_words(pipe)
    pol = resilience.resolve_policy(policy)
    dev, vmem_budget = target.device, target.vmem_budget
    todo = []
    for (b, d), (words, vmem, s_ana, s_cal, steps) in priced:
        variant = PipelinePlan(
            block=int(b), groups=((0, n_stages),),
            group_blocks=(int(b),), depths=(int(d),),
            traffic_words=int(words),
            unfused_traffic_words=unfused, vmem_bytes=int(vmem),
            modeled_seconds=float(s_cal))
        key = pipeline_key(pipe, vmem_budget=vmem_budget, align=align,
                           extra=("timing", int(b), int(d)),
                           device="", profile_hash="")
        qkey = "time|" + measure_mod.TimingDB.full_key(key, device=dev)
        if cache is not None:
            q = cache.quarantined(qkey)
            if q is not None:
                resilience.record_once(
                    "time", q.get("kind", "unknown"), qkey, "skipped",
                    "previously quarantined candidate not re-attempted")
                continue
        todo.append(((b, d), (words, vmem, s_ana, s_cal, steps), variant,
                     key, qkey))
    _build_candidates(
        [(key, lambda v=variant: lower_fused_pipeline(
            pipe, plan=v, vmem_budget=vmem_budget, device=dev))
         for _, _, variant, key, _ in todo],
        db=timing_db, device=dev)

    out: List[PipelineTiming] = []
    for (b, d), (words, vmem, s_ana, s_cal, steps), variant, key, qkey \
            in todo:
        def make_fn(variant=variant):
            return lower_pipeline_for_timing(pipe, variant,
                                             vmem_budget=vmem_budget,
                                             device=dev)

        try:
            m = resilience.call_guarded(
                lambda: measure_mod.timed(key, make_fn, db=timing_db,
                                          warmup=warmup, repeat=repeat,
                                          device=dev),
                stage="time", key=qkey, policy=pol)
        except resilience.CandidateFailure as e:
            resilience.record("time", e.kind, qkey, "quarantined",
                              e.detail)
            if cache is not None:
                cache.quarantine(qkey, e.kind, e.detail)
            continue
        out.append(PipelineTiming(
            block=int(b), traffic_words=int(words), vmem_bytes=int(vmem),
            analytic_seconds=s_ana, calibrated_seconds=s_cal,
            steps=steps, measurement=m, plan=variant, depth=int(d)))
    return out


def _observe_pipeline(pipe, timings: List[PipelineTiming],
                      target: _Target) -> None:
    bw = target.tier.hbm_bytes_per_s
    samples = [calibrate.Sample(
        workload=f"Pipeline:{pipe.name}:{pipe.shared_extent}",
        kind="Pipeline",
        stream_bytes=t.analytic_seconds * bw,
        steps=t.steps, measured_s=t.measurement.median_s,
        key=f"Pipeline:{pipe.name}:{pipe.shared_extent}"
            f"|b={t.block}d{t.depth}")
        for t in timings]
    if samples:
        calibrate.observe(samples, device=target.kind, tier=target.tier)
    _accuracy_gauges("Pipeline", [(t.calibrated_seconds,
                                   t.measurement.median_s)
                                  for t in timings])


def _price_whole_pipeline(pipe, *, vmem_budget: int, tier: Tier,
                          counters: Dict[str, int], align: int = MXU,
                          max_points: int = MAX_POINTS, profile=None,
                          depths: Tuple[int, ...] = DEPTHS) -> List[Tuple]:
    """Every feasible fully fused (block, depth) candidate, priced and
    sorted best-first (the analytic shortlist of the whole DAG).
    Entries are ``((block, depth), (words, vmem, s_ana, s_cal, steps))``;
    ties in calibrated seconds break toward the shallowest depth."""
    n_stages = len(plmod.topo_stages(pipe))
    try:
        whole = plmod.sub_pipeline(pipe, 0, n_stages)
    except (ValueError, NotImplementedError):
        return []
    priced = []
    for b in _pipeline_candidates(pipe, align, max_points):
        for d in depths:
            res = _price_pipeline_group(whole, b, vmem_budget=vmem_budget,
                                        tier=tier, counters=counters,
                                        profile=profile, depth=d)
            if res is not None:
                priced.append(((b, d), res))
    priced.sort(key=lambda t: (t[1][0], t[1][3], t[0][1], -t[1][1]))
    return priced


def measured_pipeline_shortlist(pipe, *, top_k: int = TOP_K,
                                tier: Optional[Tier] = None,
                                vmem_budget: Optional[int] = None,
                                device=None,
                                align: int = MXU,
                                max_points: int = MAX_POINTS,
                                profile=None,
                                timing_db=None,
                                warmup: int = MEASURE_WARMUP,
                                repeat: int = MEASURE_REPEAT,
                                calibrate_update: bool = True,
                                priced: Optional[List[Tuple]] = None,
                                depths: Tuple[int, ...] = DEPTHS,
                                policy: Optional[resilience.Policy]
                                = None,
                                cache: Union[None, bool, str,
                                             TuningCache] = False
                                ) -> List[PipelineTiming]:
    """The measured step for a pipeline DAG: analytically shortlist
    fully fused (block, depth) candidates, build, lower and time the top
    ``k`` whole megakernels on ``device`` (the card unless the caller
    names another), optionally fold the samples into the calibration
    profile.  ``priced`` reuses an already-computed shortlist
    (``explore_pipeline`` passes its DP's whole-range pricing).
    ``policy``/``cache`` mirror ``measured_shortlist``."""
    target = _target(tier, device, vmem_budget, measured=True)
    if priced is None:
        priced = _price_whole_pipeline(
            pipe, vmem_budget=target.vmem_budget, tier=target.tier,
            counters={"explored": 0, "pruned": 0}, align=align,
            max_points=max_points,
            profile=_resolve_profile(profile, target.kind), depths=depths)
    timings = _time_pipeline_candidates(
        pipe, priced[:max(top_k, 1)], target=target, align=align,
        timing_db=timing_db, warmup=warmup, repeat=repeat,
        policy=policy, cache=_resolve_cache(cache))
    if calibrate_update:
        _observe_pipeline(pipe, timings, target)
    return timings


def explore_pipeline(pipe, *, tier: Optional[Tier] = None,
                     vmem_budget: Optional[int] = None, device=None,
                     align: Optional[int] = None,
                     cache: Union[None, bool, str, TuningCache] = None,
                     max_points: Optional[int] = None,
                     measure: Optional[str] = None,
                     top_k: Optional[int] = None,
                     timing_db=None,
                     profile=None,
                     warmup: Optional[int] = None,
                     repeat: Optional[int] = None,
                     depths: Optional[Tuple[int, ...]] = None,
                     policy: Optional[resilience.Policy] = None,
                     bucketing: Optional[bool] = None,
                     options: Optional[Options] = None) -> PipelinePlan:
    """Joint design-space exploration for a pattern pipeline DAG.

    One tile candidate set is enumerated for the shared streaming
    domain and crossed with the buffer ``depths``; each (block, depth)
    prices the *fused* megakernel across the whole terminal set
    (external traffic, fan-out tiles and stages charged once, plus
    metapipeline overlap and the exposed load latency at that depth),
    with ``depth x`` on-chip bytes charged per stage buffer.  Ties break
    toward the shallowest depth.  When no fused candidate fits, the DAG
    is split into contiguous topological groups at the cheapest cuts
    (prefix DP, fewer groups on ties), each group with its own block
    and depth.  ``tier`` / ``vmem_budget`` / ``device`` / ``cache`` as
    in ``explore``.

    ``measure="top_k"``: when the analytic winner is fully fused, the
    top ``k`` (block, depth) megakernels are built, lowered and timed on
    ``device``; the fastest that certifies against the unfused per-stage
    oracle (``pipeline.run_unfused``) wins and the samples update the
    device's calibration profile before the plan is cached.  A split
    winner keeps the analytic choice.  Candidate-level failures never
    raise; ``bucketing=True`` raises ``NotImplementedError``.
    """
    o = _resolve_options(options, vmem_budget=vmem_budget, align=align,
                         cache=cache, max_points=max_points,
                         measure=measure, top_k=top_k,
                         timing_db=timing_db, profile=profile,
                         warmup=warmup, repeat=repeat, depths=depths,
                         policy=policy, bucketing=bucketing)
    target = _target(tier, device, o.vmem_budget, bool(o.measure))
    if o.trace:
        telemetry.enable()
    with telemetry.span("dse.explore_pipeline", pipeline=pipe.name) as sp:
        return _explore_pipeline_body(pipe, o, target, sp)


def _explore_pipeline_body(pipe, o: Options, target: _Target,
                           sp) -> PipelinePlan:
    vmem_budget, align = target.vmem_budget, o.align
    max_points, measure, top_k = o.max_points, o.measure, o.top_k
    depths, policy = o.depths, o.policy
    tier = target.tier
    tc = _resolve_cache(o.cache)
    topo = plmod.topo_stages(pipe)
    n_stages = len(topo)
    cands = _pipeline_candidates(pipe, align, max_points)

    extra: Tuple = (tuple(cands),
                    ("depths",) + tuple(int(d) for d in depths))
    if measure:
        extra += (("measure", measure, int(top_k)),)
    extra += (_tier_sig(tier),)

    def key_now() -> str:
        return pipeline_key(pipe, vmem_budget=vmem_budget, align=align,
                            extra=extra, device=target.kind)

    if tc is not None:
        hit = tc.get(key_now(), PipelinePlan)
        if hit is not None:
            telemetry.count("dse.cache_hits")
            hit = dataclasses.replace(hit, key=key_now())
            sp.set(source="cache")
            _record_plan(hit, source="cache")
            return hit

    prof = _resolve_profile(o.profile, target.kind)
    counters = {"explored": 0, "pruned": 0}

    # the fully fused (whole-range) candidates are priced once and
    # shared: they seed the DP's (0, n) entry AND the measured shortlist
    with telemetry.span("dse.shortlist", pipeline=pipe.name) as ssp:
        priced_whole = _price_whole_pipeline(
            pipe, vmem_budget=vmem_budget, tier=tier, counters=counters,
            align=align, max_points=max_points, profile=prof,
            depths=depths)
        ssp.set(fused_candidates=len(priced_whole))

    def best_group(i0: int, i1: int, memo: Dict):
        """Per-group (block, depth) choice: cheapest (words, seconds,
        depth, -vmem) for topo stages [i0, i1)."""
        if (i0, i1) in memo:
            return memo[(i0, i1)]
        best = None
        try:
            sub_pipe = plmod.sub_pipeline(pipe, i0, i1)
        except (ValueError, NotImplementedError):
            sub_pipe = None   # e.g. a cut making a terminal also consumed
        if sub_pipe is not None:
            for b in cands:
                for d in depths:
                    priced = _price_pipeline_group(
                        sub_pipe, b, vmem_budget=vmem_budget, tier=tier,
                        counters=counters, profile=prof, depth=d)
                    if priced is None:
                        continue
                    rank = (priced[0], priced[3], d, -priced[1])
                    if best is None or rank < (best[0], best[1],
                                               best[4], -best[2]):
                        best = (priced[0], priced[3], priced[1], b, d)
        memo[(i0, i1)] = best
        return best

    # prefix DP over contiguous topological groups; fewer groups
    # preferred on ties (the j == 0 single-group candidate is tried
    # first and later candidates must be strictly cheaper)
    memo: Dict = {}
    if priced_whole:
        (b, d), (words, vmem, _, s_cal, _) = priced_whole[0]
        memo[(0, n_stages)] = (words, s_cal, vmem, b, d)
    else:
        memo[(0, n_stages)] = None
    state: List = [None] * (n_stages + 1)
    # words, seconds, vmem, groups, blocks, depths
    state[0] = (0, 0.0, 0, (), (), ())
    for i in range(1, n_stages + 1):
        for j in range(0, i):
            if state[j] is None:
                continue
            g = best_group(j, i, memo)
            if g is None:
                continue
            cand = (state[j][0] + g[0], state[j][1] + g[1],
                    max(state[j][2], g[2]),
                    state[j][3] + ((j, i),), state[j][4] + (g[3],),
                    state[j][5] + (g[4],))
            if state[i] is None or (cand[0], cand[1]) \
                    < (state[i][0], state[i][1]):
                state[i] = cand
    best = state[n_stages]
    if best is None:
        raise ValueError(
            "pipeline DSE: no tile candidate fits on-chip budget "
            f"{vmem_budget} B for '{pipe.name}' "
            f"({counters['explored']} candidates over {cands})")

    plan = PipelinePlan(
        block=int(best[4][0]), groups=best[3], group_blocks=best[4],
        traffic_words=int(best[0]),
        unfused_traffic_words=plmod.unfused_traffic_words(pipe),
        vmem_bytes=int(best[2]), modeled_seconds=float(best[1]),
        explored=counters["explored"], pruned=counters["pruned"],
        depths=best[5])

    prov_measured: List[Dict] = []
    prov_cert: List[Dict] = []
    if measure == "top_k" and plan.fused:
        pol = resilience.resolve_policy(policy)
        tag = f"Pipeline:{pipe.name}:{pipe.shared_extent}"
        with telemetry.span("dse.measure", top_k=int(top_k)) as msp:
            n_events = len(resilience.LOG.events(stage="time"))
            timings = measured_pipeline_shortlist(
                pipe, top_k=top_k, tier=tier, vmem_budget=vmem_budget,
                device=target.device, align=align, max_points=max_points,
                profile=prof if prof is not None else False,
                timing_db=o.timing_db, warmup=o.warmup, repeat=o.repeat,
                priced=priced_whole, depths=depths, policy=pol,
                cache=tc if tc is not None else False)
            failures = _failures_since(n_events)
            ranked = sorted(timings,
                            key=lambda t: (t.measurement.median_s,
                                           t.traffic_words, t.depth,
                                           -t.vmem_bytes))
            prov_measured = [
                {"block": int(t.block), "depth": int(t.depth),
                 "median_s": float(t.measurement.median_s)}
                for t in ranked]
            msp.set(timed=len(timings))
            promoted = False
            for win in ranked:
                if pol.certify:
                    ckey = "certify|" + measure_mod.TimingDB.full_key(
                        pipeline_key(pipe, vmem_budget=vmem_budget,
                                     align=align,
                                     extra=("certify", win.block,
                                            win.depth),
                                     device="", profile_hash=""),
                        device=target.device)
                    if tc is not None \
                            and tc.quarantined(ckey) is not None:
                        prov_cert.append({"block": int(win.block),
                                          "depth": int(win.depth),
                                          "ok": False,
                                          "reason": "quarantined"})
                        continue
                    ok, reason = resilience.certify_guarded(
                        lambda w=win: resilience.certify_pipeline_plan(
                            pipe, w.plan, vmem_budget=vmem_budget,
                            device=target.device),
                        key=ckey, policy=pol)
                    prov_cert.append({"block": int(win.block),
                                      "depth": int(win.depth),
                                      "ok": bool(ok), "reason": reason})
                    if not ok:
                        resilience.record("certify", "certify-failed",
                                          ckey, "quarantined", reason)
                        if tc is not None:
                            tc.quarantine(ckey, "certify-failed", reason)
                        continue
                plan = dataclasses.replace(
                    win.plan,
                    unfused_traffic_words=plan.unfused_traffic_words,
                    explored=counters["explored"],
                    pruned=counters["pruned"],
                    measured=True,
                    measured_seconds=win.measurement.median_s,
                    timed=len(timings))
                promoted = True
                break
            if not promoted:
                _no_winner(tag, len(timings), failures)

    # key recomputed AFTER any calibration update: the next call
    # prices under the new profile hash and must hit this entry
    final_key = key_now()
    plan = dataclasses.replace(plan, key=final_key)
    if tc is not None:
        tc.put(final_key, plan)
    sp.set(source="explored", explored=plan.explored,
           pruned=plan.pruned, groups=len(plan.groups),
           timed=plan.timed)
    _record_plan(
        plan, source="explored",
        enumerated=plan.explored,
        pruned={"vmem": plan.pruned,
                "dominated": max(len(priced_whole) - plan.timed, 0)
                if plan.timed else 0},
        analytic_ranks=[
            {"block": int(b), "depth": int(d),
             "traffic_words": int(words),
             "calibrated_seconds": float(s_cal)}
            for (b, d), (words, _v, _sa, s_cal, _st)
            in priced_whole[:max(int(top_k), 3)]],
        measured_ranks=prov_measured,
        certification=prov_cert)
    return plan


# --------------------------------------------------------------------
# Plan provenance: dse.explain
# --------------------------------------------------------------------


def explain_dict(plan) -> Dict:
    """Machine-readable provenance report for a ``TilePlan`` /
    ``PipelinePlan``: where the winner came from (fresh exploration or
    tuning-cache hit), what was enumerated and why candidates were
    rejected, the analytic and measured rankings and the certification
    outcomes.

    The deep exploration internals (rank tables, certification
    outcomes, per-reason pruning counts) are captured only while
    tracing is enabled (``REPRO_TRACE=1`` / ``Options(trace=True)``)
    and the plan was explored in this process; otherwise the report
    falls back to the accounting every plan carries on itself.
    """
    source = "cache" if plan.cached else "explored"
    d: Dict = {
        "kind": type(plan).__name__,
        "key": plan.key,
        "source": source,
        "explored": int(plan.explored),
        "pruned": int(plan.pruned),
        "traffic_words": int(plan.traffic_words),
        "vmem_bytes": int(plan.vmem_bytes),
        "modeled_seconds": float(plan.modeled_seconds),
        "measured": bool(plan.measured),
        "measured_seconds": float(plan.measured_seconds),
        "timed": int(plan.timed),
        "warm_start": False,
        "bucket": "",
        "cached": bool(plan.cached),
    }
    if isinstance(plan, PipelinePlan):
        d["block"] = int(plan.block)
        d["groups"] = [list(g) for g in plan.groups]
        d["depths"] = [int(x) for x in plan.depths]
    else:
        d["sizes"] = {k: list(v) for k, v in plan.sizes.items()}
        d["depths"] = {k: int(v) for k, v in plan.depths.items()}
        d["thinned"] = bool(plan.thinned)
    rec = telemetry.get_record("plan", plan.key) if plan.key else None
    if rec is not None:
        d["provenance"] = rec
        d["source"] = rec.get("source", source)
    return d


def explain(plan) -> str:
    """Human-readable plan-provenance report (``explain_dict`` as
    text): winner source, tile/group choice, analytic vs measured
    ranks, per-reason pruning counts, certification outcomes."""
    d = explain_dict(plan)
    lines = [f"{d['kind']} {d['key'] or '<no key>'}",
             f"  source: {d['source']}"]
    if "sizes" in d:
        lines.append("  sizes: " + ", ".join(
            f"{k}={tuple(v)}" for k, v in sorted(d["sizes"].items())))
    else:
        lines.append(f"  block: {d['block']}  groups: {d['groups']}")
    lines.append(f"  depths: {d['depths']}")
    lines.append(f"  traffic: {d['traffic_words']} words   "
                 f"on-chip: {d['vmem_bytes']} B   "
                 f"modeled: {d['modeled_seconds']:.3e} s")
    if d["measured"]:
        lines.append(f"  measured: {d['measured_seconds']:.3e} s "
                     f"({d['timed']} candidates timed)")
    lines.append(f"  enumerated: {d['explored']}  pruned: {d['pruned']}")
    rec = d.get("provenance")
    if rec:
        pr = rec.get("pruned")
        if isinstance(pr, dict):
            lines.append("  pruned by reason: " + ", ".join(
                f"{k}={v}" for k, v in sorted(pr.items())))
        for label, keyname in (("analytic ranks", "analytic_ranks"),
                               ("measured ranks", "measured_ranks")):
            rows = rec.get(keyname)
            if rows:
                lines.append(f"  {label}:")
                lines.extend(
                    f"    {i + 1}. " + ", ".join(f"{k}={v}"
                                                 for k, v in r.items())
                    for i, r in enumerate(rows))
        for c in rec.get("certification") or ():
            ident = ", ".join(f"{k}={v}" for k, v in c.items()
                              if k not in ("ok", "reason"))
            verdict = ("certified" if c.get("ok")
                       else f"FAILED ({c.get('reason', '')})")
            lines.append(f"  certify {ident}: {verdict}")
    else:
        lines.append("  (no in-process trace record; run with "
                     "REPRO_TRACE=1 for rank tables and pruning "
                     "reasons)")
    return "\n".join(lines)


# --------------------------------------------------------------------
# Proxy programs of the hand-written kernels (analysed, never lowered:
# torch bodies for the oracle, no CUDA body)
# --------------------------------------------------------------------


def attention_program(sq: int, sk: int, d: int) -> ir.Pattern:
    """Flash attention as Map(queries){ MultiFold(keys) } -- the online-
    softmax fold over keys nested in the query map.

    Tileable domains: ``fa_q`` (query block) and ``fa_kv`` (kv block).
    """
    q = ir.Tensor("q", (sq, d))
    k = ir.Tensor("k", (sk, d))
    v = ir.Tensor("v", (sk, d))
    kv = ir.MultiFold(
        domain=(sk,), range_shape=(d,), init=lambda: torch.zeros((d,)),
        reads=(ir.Access(q, lambda i, kk: (i, 0), (1, d)),
               ir.Access(k, lambda i, kk: (kk, 0), (1, d)),
               ir.Access(v, lambda i, kk: (kk, 0), (1, d))),
        out_index_map=lambda i, kk: (0,), update_shape=(d,),
        fn=lambda s, acc, qe, ke, ve:
            acc + (qe * ke).sum(-1, keepdim=True) * ve,
        combine=operator.add, name="fa_kv")
    return ir.Map(domain=(sq,), elem_shape=(d,), inner=kv, name="fa_q")


def scan_program(seq: int, n: int, dh: int) -> ir.Pattern:
    """The SSD chunked scan's sequence fold: per step read an x row, a
    dt scalar and B/C rows, update the carried (n, dh) state.

    Tileable domain: ``ssd`` (the chunk length).
    """
    x = ir.Tensor("x", (seq, dh))
    dt = ir.Tensor("dt", (seq,))
    B = ir.Tensor("B", (seq, n))
    C = ir.Tensor("C", (seq, n))
    return ir.MultiFold(
        domain=(seq,), range_shape=(n, dh), init=lambda: torch.zeros((n, dh)),
        reads=(ir.Access(x, lambda i: (i, 0), (1, dh)),
               ir.elem(dt),
               ir.Access(B, lambda i: (i, 0), (1, n)),
               ir.Access(C, lambda i: (i, 0), (1, n))),
        out_index_map=lambda i: (0, 0), update_shape=(n, dh),
        fn=lambda s, acc, xe, dte, be, ce:
            acc + be[..., :, None] * xe[..., None, :] * dte[..., None, None],
        combine=operator.add, name="ssd")


def filter_reduce_program(t: int) -> ir.Pattern:
    """TPC-H Q6 shape: fused filter + weighted-sum fold over one stream
    (tileable domain: ``fr``)."""
    x = ir.Tensor("x", (t,))
    w = ir.Tensor("w", (t,))
    return ir.MultiFold(
        domain=(t,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(x), ir.elem(w)),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, xe, we: acc + xe * we,
        combine=operator.add, name="fr")


def groupby_program(t: int, num_keys: int, ew: int) -> ir.Pattern:
    """Keyed fold over a (t,) stream into a dense (num_keys, ew)
    accumulator (tileable domain: ``gbf``)."""
    keys = ir.Tensor("keys", (t,), "int32")
    vals = ir.Tensor("vals", (t, ew))
    return ir.GroupByFold(
        domain=(t,), num_keys=num_keys, elem_shape=(ew,),
        init=lambda: torch.zeros((num_keys, ew)),
        reads=(ir.elem(keys),
               ir.Access(vals, lambda i: (i, 0), (1, ew))),
        fn=lambda s, ke, ve: (ke.to(torch.int32), ve),
        combine=operator.add, name="gbf")


def filter_fold_pipeline(t: int):
    """TPC-H Q6 as a two-stage pipeline: a mask Map producing the
    per-record contribution, folded by a separate sum stage.  The fused
    kernel keeps the (t,) intermediate on chip; unfused, it round-trips
    main memory (the quantity ``PipelinePlan.traffic_ratio`` reports)."""
    x = ir.Tensor("x", (t,))
    w = ir.Tensor("w", (t,))
    mask = ir.Map(domain=(t,), reads=(ir.elem(x), ir.elem(w)),
                  fn=lambda s, xe, we: xe * we, name="ff_mask")
    total = ir.MultiFold(
        domain=(t,), range_shape=(), init=lambda: torch.zeros(()),
        reads=(ir.elem(ir.Tensor("ff_mask", (t,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: acc + v,
        combine=operator.add, name="ff_sum")
    return plmod.Pipeline(name="filter_fold", stages=(mask, total))


# --------------------------------------------------------------------
# Block sizes of the hand-written kernels (one selector per kernel).
# Each takes ``tier`` / ``vmem_budget`` / ``device`` and the tuning
# arguments as ``explore`` does and returns ``(blocks, plan)``.
# --------------------------------------------------------------------


def _one(plan: TilePlan, name: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in plan.sizes[name])


def select_gemm_blocks(m: int, n: int, k: int, *, tier: Optional[Tier] = None,
                       vmem_budget: Optional[int] = None, device=None,
                       **tuning) -> Tuple[Tuple[int, int, int], TilePlan]:
    """``(block_m, block_n, block_k)`` for ``kernels.matmul``."""
    plan = explore(gemm_program(m, n, k), tier=tier, vmem_budget=vmem_budget,
                   device=device, **tuning)
    (bm, bn), (bk,) = _one(plan, "gemm"), _one(plan, "gemm_k")
    return (bm, bn, bk), plan


def select_attention_blocks(sq: int, sk: int, d: int, *,
                            tier: Optional[Tier] = None,
                            vmem_budget: Optional[int] = None, device=None,
                            **tuning) -> Tuple[Tuple[int, int], TilePlan]:
    """``(block_q, block_k)`` for ``kernels.flash_attention``."""
    plan = explore(attention_program(sq, sk, d), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bq,), (bk,) = _one(plan, "fa_q"), _one(plan, "fa_kv")
    return (bq, bk), plan


def select_scan_blocks(seq: int, n: int, dh: int, *,
                       tier: Optional[Tier] = None,
                       vmem_budget: Optional[int] = None, device=None,
                       **tuning) -> Tuple[int, TilePlan]:
    """``chunk`` for ``kernels.ssd_scan``."""
    plan = explore(scan_program(seq, n, dh), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (chunk,) = _one(plan, "ssd")
    return chunk, plan


def select_filter_reduce_blocks(t: int, *, tier: Optional[Tier] = None,
                                vmem_budget: Optional[int] = None,
                                device=None, **tuning
                                ) -> Tuple[int, TilePlan]:
    """``block_t`` for ``kernels.filter_reduce``."""
    plan = explore(filter_reduce_program(t), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bt,) = _one(plan, "fr")
    return bt, plan


def select_groupby_blocks(t: int, num_keys: int, ew: int, *,
                          tier: Optional[Tier] = None,
                          vmem_budget: Optional[int] = None, device=None,
                          **tuning) -> Tuple[int, TilePlan]:
    """``block_t`` for ``kernels.groupby_fold``."""
    plan = explore(groupby_program(t, num_keys, ew), tier=tier,
                   vmem_budget=vmem_budget, device=device, **tuning)
    (bt,) = _one(plan, "gbf")
    return bt, plan


def select_fused_filter_fold_blocks(t: int, *, tier: Optional[Tier] = None,
                                    vmem_budget: Optional[int] = None,
                                    device=None, **tuning
                                    ) -> Tuple[int, PipelinePlan]:
    """``block_t`` for ``kernels.fused_filter_fold``: one joint plan for
    the filter -> fold pipeline."""
    plan = explore_pipeline(filter_fold_pipeline(t), tier=tier,
                            vmem_budget=vmem_budget, device=device, **tuning)
    return plan.block, plan


def select_fused_kmeans_blocks(n: int, k: int, d: int, *,
                               tier: Optional[Tier] = None,
                               vmem_budget: Optional[int] = None,
                               device=None, **tuning
                               ) -> Tuple[int, PipelinePlan]:
    """``block_n`` for ``kernels.fused_kmeans``: one joint plan for the
    assign -> {scatter-sum, count} DAG."""
    from ..patterns.analytics import kmeans_pipeline
    pipe, _, _ = kmeans_pipeline(n, k, d)
    plan = explore_pipeline(pipe, tier=tier, vmem_budget=vmem_budget,
                            device=device, **tuning)
    return plan.block, plan


# --------------------------------------------------------------------
# Paged serving decode: layout x page_size x block as joint DSE axes
# --------------------------------------------------------------------

PAGED_LAYOUTS = ("split", "fused")   # split K/V pools vs head-interleaved
PAGE_SIZES = (8, 16, 32, 64)


def _append_fn(s, pagerow, new, ln):
    pagerow, new = pagerow.reshape(-1), new.reshape(-1)
    return torch.where(s[0] == ln.reshape(()), new, pagerow)


def paged_decode_pipeline(max_len: int, page_size: int, d: int,
                          layout: str = "split"):
    """One decode step as the ``decode_attention`` pipeline DAG: a
    KV-append producer Map (the step's token merged at the ``seq_len``
    slot) feeding a flash-attention MultiFold terminal, over a *ragged*
    streaming domain (``ir.RaggedExtent``: the static extent is the
    page-padded context bound, the live extent the run-time ``seq_len``,
    masked at page granularity).

    ``split`` streams separate K and V rows through two producer
    stages; ``fused`` one head-interleaved ``2d`` row through a single
    stage: the same words in half the streams, which the metapipeline
    model prices differently.  Analysed, never lowered (the kernel is
    ``codegen_cuda.lower_paged_decode``).
    """
    if layout not in PAGED_LAYOUTS:
        raise ValueError(f"layout {layout!r}; one of {PAGED_LAYOUTS}")
    padded = -(-max_len // page_size) * page_size
    rag = ir.RaggedExtent(max=padded, length_name="seq_len",
                          granularity=page_size)
    q = ir.Tensor("q", (1, d))
    seq_len = ir.Tensor("seq_len", (1,), "int32")
    scale = d ** -0.5

    def weight(s, krow, qv, ln):
        live = s[0] <= ln.reshape(())
        return torch.where(live, torch.exp((qv * krow).sum() * scale), 0.0)

    if layout == "fused":
        pages = ir.Tensor("kv_pages", (padded, 2 * d))
        new_kv = ir.Tensor("new_kv", (1, 2 * d))
        append = ir.Map(
            domain=(padded,), elem_shape=(2 * d,),
            reads=(ir.Access(pages, lambda i: (i, 0), (1, 2 * d)),
                   ir.whole(new_kv), ir.whole(seq_len)),
            fn=_append_fn, name="pd_append", ragged=rag)

        def fold_fn(s, acc, kvrow, qv, ln):
            kvrow, qv = kvrow.reshape(-1), qv.reshape(-1)
            return acc + weight(s, kvrow[:d], qv, ln) * kvrow[d:]

        fold = ir.MultiFold(
            domain=(padded,), range_shape=(d,),
            init=lambda: torch.zeros((d,)),
            reads=(ir.Access(ir.Tensor("pd_append", (padded, 2 * d)),
                             lambda i: (i, 0), (1, 2 * d)),
                   ir.whole(q), ir.whole(seq_len)),
            out_index_map=lambda i: (0,), update_shape=(d,),
            fn=fold_fn, combine=operator.add, name="pd_kv", ragged=rag)
        return plmod.Pipeline(name="paged_decode_fused",
                              stages=(append, fold))

    k_pages = ir.Tensor("k_pages", (padded, d))
    v_pages = ir.Tensor("v_pages", (padded, d))
    new_k = ir.Tensor("new_k", (1, d))
    new_v = ir.Tensor("new_v", (1, d))
    app_k = ir.Map(
        domain=(padded,), elem_shape=(d,),
        reads=(ir.Access(k_pages, lambda i: (i, 0), (1, d)),
               ir.whole(new_k), ir.whole(seq_len)),
        fn=_append_fn, name="pd_append_k", ragged=rag)
    app_v = ir.Map(
        domain=(padded,), elem_shape=(d,),
        reads=(ir.Access(v_pages, lambda i: (i, 0), (1, d)),
               ir.whole(new_v), ir.whole(seq_len)),
        fn=_append_fn, name="pd_append_v", ragged=rag)

    def fold_fn_split(s, acc, krow, vrow, qv, ln):
        krow, vrow, qv = krow.reshape(-1), vrow.reshape(-1), qv.reshape(-1)
        return acc + weight(s, krow, qv, ln) * vrow

    fold = ir.MultiFold(
        domain=(padded,), range_shape=(d,),
        init=lambda: torch.zeros((d,)),
        reads=(ir.Access(ir.Tensor("pd_append_k", (padded, d)),
                         lambda i: (i, 0), (1, d)),
               ir.Access(ir.Tensor("pd_append_v", (padded, d)),
                         lambda i: (i, 0), (1, d)),
               ir.whole(q), ir.whole(seq_len)),
        out_index_map=lambda i: (0,), update_shape=(d,),
        fn=fold_fn_split, combine=operator.add, name="pd_kv", ragged=rag)
    return plmod.Pipeline(name="paged_decode_split",
                          stages=(app_k, app_v, fold))


def select_paged_decode_blocks(
        max_len: int, d: int, *, tier: Optional[Tier] = None,
        vmem_budget: Optional[int] = None, device=None, **tuning
        ) -> Tuple[Tuple[str, int, int, int], TilePlan]:
    """``(layout, page_size, block, depth)`` for
    ``codegen_cuda.lower_paged_decode``: a joint search over KV layout x
    page size x streaming block x buffer depth.

    Every (layout, page_size) pair prices its own ``decode_attention``
    proxy DAG through ``explore_pipeline`` (block x depth inside, with
    the tuning arguments and cache); the argmin on modeled seconds wins.
    ``plan`` is a summary ``TilePlan`` recording the joint axes:
    ``sizes["pd_kv"]`` the streaming block, ``sizes["pd_page"]`` the
    page size, ``sizes["pd_layout"]`` the layout's ``PAGED_LAYOUTS``
    index, ``depths["pd_kv"]`` the depth.  Raises ``ValueError`` when
    no candidate of any pair fits the budget, as the reference does.
    """
    page_sizes = [p for p in PAGE_SIZES if p <= max(max_len, PAGE_SIZES[0])]
    best = None
    explored = pruned = timed = 0
    for layout in PAGED_LAYOUTS:
        for ps in page_sizes:
            pipe = paged_decode_pipeline(max_len, ps, d, layout)
            plan = explore_pipeline(pipe, tier=tier, vmem_budget=vmem_budget,
                                    device=device, **tuning)
            explored += plan.explored
            pruned += plan.pruned
            timed += plan.timed
            if best is None or (plan.modeled_seconds
                                < best[2].modeled_seconds):
                best = (layout, ps, plan)
    layout, ps, pplan = best
    summary = TilePlan(
        sizes={"pd_kv": (int(pplan.block),), "pd_page": (int(ps),),
               "pd_layout": (PAGED_LAYOUTS.index(layout),)},
        traffic_words=pplan.traffic_words, vmem_bytes=pplan.vmem_bytes,
        modeled_seconds=pplan.modeled_seconds, explored=explored,
        pruned=pruned, cached=pplan.cached, measured=pplan.measured,
        measured_seconds=pplan.measured_seconds, timed=timed,
        depths={"pd_kv": int(pplan.depth)}, key=pplan.key)
    return (layout, int(ps), int(pplan.block), int(pplan.depth)), summary
