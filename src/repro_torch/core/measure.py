"""Measured timing harness for lowered kernels (the measured half of
the DSE).

The analytic cost model (``core.cost``) prices candidates in modeled
main-memory seconds; this module supplies the *measured* side of the
analytic -> measured exploration:

  * ``measure``    -- median-of-k wall time of a zero-arg callable, each
    call fenced with ``torch.cuda.synchronize()`` on the card (the
    reference fences with ``jax.block_until_ready``); the first
    ``warmup`` calls run but are excluded, so reported seconds are
    steady state, never a build or a first-touch allocation.
  * ``TimingDB``   -- persistent device-keyed measurement store beside
    the DSE tuning cache (``REPRO_TIMING_DB``, defaulting to a sibling
    of ``REPRO_DSE_CACHE``, else ``~/.cache/repro_torch/``): a
    candidate timed once is never lowered or run again on that device.
  * ``synth_inputs`` -- deterministic concrete tensors for a pattern's
    symbolic ``ir.Tensor`` inputs, drawn with numpy exactly as the
    reference draws them, then moved to the requested device.

On the CPU the kernels' plain PyTorch versions run (``interpret_mode``
is true there), so CPU timings rank candidates but say nothing of the
card.  The DB key carries the device kind and that flag.  Device kinds
are the port's own (``torch-cpu`` on the CPU, the card's name on the
card), so no entry the JAX reference writes under the same
``REPRO_*`` paths is ever read as the port's.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from . import ir, resilience, telemetry


# --------------------------------------------------------------------------
# Device identity
# --------------------------------------------------------------------------


def _device(device=None):
    """``device`` as a ``torch.device``; with none, the card when there
    is one, else the CPU (a key names the device; it launches nothing)."""
    import torch
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """Normalized device identity keying the timing DB, the tuning cache
    and the calibration profile: the CUDA device's name on the card
    (``torch.cuda.get_device_name``, e.g. ``nvidia-h100-80gb-hbm3``),
    ``torch-<type>`` elsewhere (``torch-cpu``), never the reference's
    ``cpu``."""
    import torch
    dev = _device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        return str(kind).strip().lower().replace(" ", "-")
    return f"torch-{dev.type}"


def interpret_mode(device=None) -> bool:
    """True when the kernels' plain PyTorch versions run (the CPU);
    mirrored into every timing-DB key."""
    return _device(device).type != "cuda"


# --------------------------------------------------------------------------
# The measurement itself
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Steady-state wall time of one callable on one device."""

    median_s: float
    mean_s: float
    min_s: float
    max_s: float
    repeat: int
    warmup: int
    device: str = "unknown"
    interpret: bool = True
    cached: bool = False   # served from the TimingDB, nothing executed

    @property
    def spread(self) -> float:
        """(max - min) / median -- the noise figure of a measurement."""
        return (self.max_s - self.min_s) / max(self.median_s, 1e-12)

    def to_json(self) -> Dict:
        return {"median_s": self.median_s, "mean_s": self.mean_s,
                "min_s": self.min_s, "max_s": self.max_s,
                "repeat": self.repeat, "warmup": self.warmup,
                "device": self.device, "interpret": self.interpret}

    @classmethod
    def from_json(cls, d: Dict) -> "Measurement":
        return cls(median_s=float(d["median_s"]),
                   mean_s=float(d["mean_s"]),
                   min_s=float(d["min_s"]), max_s=float(d["max_s"]),
                   repeat=int(d["repeat"]), warmup=int(d["warmup"]),
                   device=str(d.get("device", "unknown")),
                   interpret=bool(d.get("interpret", True)),
                   cached=True)


def _fence(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def measure(fn: Callable[[], object], *, warmup: int = 1,
            repeat: int = 5, device=None) -> Measurement:
    """Median-of-``repeat`` wall seconds of ``fn()`` on ``device``.

    On the card every call is fenced with ``torch.cuda.synchronize()``
    (launches are asynchronous: without it the host's issue would be
    timed, not the kernel).  The first ``warmup`` calls run but are
    *excluded*: they absorb library loading and first-touch allocation.
    """
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    dev = _device(device)
    # chaos hook: REPRO_FAULTS=time:<p> makes this measurement fail
    # deterministically so the quarantine path can be exercised
    resilience.inject("time", "measure.measure")
    with telemetry.span("measure.measure", warmup=warmup,
                        repeat=repeat) as sp:
        _fence(dev)
        for _ in range(warmup):
            fn()
            _fence(dev)
        times = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            fn()
            _fence(dev)
            times.append(time.perf_counter() - t0)
        m = Measurement(median_s=statistics.median(times),
                        mean_s=sum(times) / len(times),
                        min_s=min(times), max_s=max(times),
                        repeat=repeat, warmup=warmup,
                        device=device_kind(dev),
                        interpret=interpret_mode(dev))
        sp.set(median_s=m.median_s, spread=m.spread)
    return m


# --------------------------------------------------------------------------
# Persistent timing DB
# --------------------------------------------------------------------------


def cache_sibling_path(name: str,
                       env_var: Optional[str] = None) -> str:
    """Shared path resolution for every persistent store (tuning
    cache, timing DB, calibration profile): the store's own env var if
    set, else a sibling of ``REPRO_DSE_CACHE`` (the stores persist
    together), else ``repro_torch/`` in the XDG cache dir
    (``~/.cache/repro_torch/``)."""
    if env_var:
        env = os.environ.get(env_var)
        if env:
            return env
    dse_cache = os.environ.get("REPRO_DSE_CACHE")
    if dse_cache:
        return os.path.join(os.path.dirname(dse_cache) or ".", name)
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", name)


# atomic JSON write of the crash-safe store layer (``core.resilience``)
atomic_write_json = resilience.atomic_write_json


def default_db_path() -> str:
    return cache_sibling_path("timing_db.json", "REPRO_TIMING_DB")


class TimingDB:
    """On-disk measurement store keyed by (device, interpret, key).

    Same contract as the DSE ``TuningCache``: crash-safe checksummed
    JSON (``resilience.load_store``: a truncated or corrupt file is
    quarantined to ``<path>.corrupt`` with a warning and the DB
    rebuilds fresh), lock-protected read-modify-write on put, and the
    DB only ever accelerates re-exploration -- it is never a
    correctness dependency.  ``device`` is the device whose timings the
    DB reads and writes (the card unless the caller names another).
    """

    def __init__(self, path: Optional[str] = None, device=None):
        self.path = path or default_db_path()
        self.device = device
        self._data: Optional[Dict[str, Dict]] = None

    @staticmethod
    def full_key(key: str, *, device=None,
                 interpret: Optional[bool] = None) -> str:
        """``key`` under a device (None: the card when there is one,
        else the CPU) and whether plain versions ran there."""
        interp = interpret_mode(device) if interpret is None else interpret
        return f"{device_kind(device)}|interp={int(interp)}|{key}"

    def _key(self, key: str) -> str:
        return self.full_key(key, device=self.device)

    def _load(self) -> Dict[str, Dict]:
        if self._data is None:
            self._data = resilience.load_store(self.path,
                                               label="timing DB")
        return self._data

    def get(self, key: str) -> Optional[Measurement]:
        d = self._load().get(self._key(key))
        if d is None:
            return None
        try:
            return Measurement.from_json(d)
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, key: str, m: Measurement) -> None:
        mine = self._load()
        mine[self._key(key)] = m.to_json()

        def merge(data: Dict) -> None:
            data[self._key(key)] = m.to_json()

        # locked read-modify-write: a concurrent process's entries
        # survive this put (and land in our in-memory view)
        self._data = resilience.locked_update(
            self.path, merge, label="timing DB", prefix=".timing_db.")
        self._data.update(mine)

    def clear(self) -> None:
        self._data = {}
        try:
            os.unlink(self.path)
        except OSError:
            pass


def resolve_db(db, device=None) -> Optional[TimingDB]:
    """Resolve the ``timing_db`` option (the convention ``dse.Options``
    carries): ``None`` -> default on-disk DB, path/TimingDB -> that DB,
    ``False`` -> no persistence.  A DB made here reads and writes the
    timings of ``device``."""
    if db is False:
        return None
    if db is None:
        return TimingDB(device=device)
    if isinstance(db, str):
        return TimingDB(db, device=device)
    return db



def timed(key: str, make_fn: Callable[[], Callable[[], object]], *,
          db=None, warmup: int = 1, repeat: int = 5,
          device=None) -> Measurement:
    """Measure ``make_fn()()`` on ``device`` under ``key``, memoized in
    the DB.

    ``make_fn`` is a *thunk returning the callable*: on a DB hit
    nothing is lowered, so a cache-warm exploration does zero lowering
    and zero execution.
    """
    tdb = resolve_db(db, device)
    if tdb is not None:
        hit = tdb.get(key)
        if hit is not None:
            telemetry.count("measure.db_hits")
            return hit
    with telemetry.span("measure.timed", key=key[-32:]) as sp:
        m = measure(make_fn(), warmup=warmup, repeat=repeat,
                    device=device)
        sp.set(median_s=m.median_s)
    if tdb is not None:
        tdb.put(key, m)
    return m


# --------------------------------------------------------------------------
# Input synthesis
# --------------------------------------------------------------------------


def synth_inputs(tensors: Sequence[ir.Tensor], *, seed: int = 0,
                 device=None) -> Dict[str, "object"]:
    """Deterministic concrete tensors for symbolic pattern inputs, on
    ``device`` (the card unless the caller names another).

    Drawn exactly as the reference draws them: one numpy
    ``default_rng(seed)``, floats standard normal, ints in [0, 8)
    (safe for key tensors), bools in {0, 1}, in input order.  Same seed
    -> bit-identical inputs, equal to the reference's on the CPU.
    """
    import torch

    from ..device import resolve

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    out = {}
    for t in tensors:
        dt = np.dtype(t.dtype)
        shape = tuple(t.shape)
        if np.issubdtype(dt, np.integer):
            val = rng.integers(0, 8, size=shape).astype(dt)
        elif np.issubdtype(dt, np.bool_):
            val = rng.integers(0, 2, size=shape).astype(dt)
        else:
            val = rng.standard_normal(shape).astype(dt)
        out[t.name] = torch.from_numpy(np.ascontiguousarray(val)).to(dev)
    return out


def _rank(xs: Sequence[float]) -> Tuple[float, ...]:
    """Average ranks (ties averaged), 1-based."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return tuple(ranks)


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (ties averaged).

    How well the (calibrated or uncalibrated) analytic candidate
    ranking matches the measured one, per workload.  Degenerate inputs (constant
    vectors, < 2 points) return 1.0 when the rankings trivially agree
    and 0.0 otherwise.
    """
    if len(xs) != len(ys):
        raise ValueError(f"length mismatch: {len(xs)} vs {len(ys)}")
    n = len(xs)
    if n < 2:
        return 1.0
    rx, ry = _rank(xs), _rank(ys)
    mx = sum(rx) / n
    my = sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0 and vy == 0:
        return 1.0
    if vx == 0 or vy == 0:
        return 0.0
    return cov / (vx * vy) ** 0.5
