"""One tuning-option surface for the DSE stack (``dse.Options``).

``explore`` / ``explore_pipeline`` take a dozen options (budget,
alignment, cache, shortlist size, the measured mode's knobs, the
resilience policy, tracing), and every kernel's ``auto_tile`` path
threads them through.  This module holds them in one place:

  * ``Options`` -- one frozen dataclass holding every exploration
    option.  Unset fields carry the ``UNSET`` sentinel so layers can be
    merged without "was this explicitly passed?" ambiguity.
  * ``Options.from_env()`` -- the single place the tuning ``REPRO_*``
    env vars are read (see its docstring for the table).
  * precedence -- explicit kwarg > ``options=Options(...)`` > env >
    built-in default, resolved by ``Options.merged`` + ``resolved()``.

The numeric defaults (``MXU``, ``MAX_POINTS``, ``DEPTHS``, ...) live
here so this module stays a leaf import; ``dse`` re-exports them.  The
on-chip budget has no fixed default: ``vmem_budget=None`` means the
on-chip bytes of the tier a DSE call plans for (``cost.Tier``).

``bucketing=True`` turns on shape-bucketed warm starts
(``core.buckets``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

from . import resilience

MXU = 128     # lane-count floor of a tile (the reference's MXU edge)
SUBLANE = 8   # fp32 row multiple of a minimum tile

# cap on priced candidates per exploration; axes are thinned (keeping
# their endpoints) until the cross product fits.  Recorded on the
# returned TilePlan as ``thinned=True``.
MAX_POINTS = 4096

# metapipeline buffer depths enumerated per candidate (2 = the classic
# double buffer); deeper rotating buffers hide more load latency but
# charge ``depth x`` on-chip bytes, so they compete with bigger tiles
# under the budget
DEPTHS = (2, 3, 4)

# measured-mode defaults: how many analytically shortlisted candidates
# are lowered and timed, and the measurement shape
TOP_K = 3
MEASURE_WARMUP = 1
MEASURE_REPEAT = 3


class _Unset:
    """Singleton sentinel distinguishing "not passed" from ``None`` /
    ``False`` (both of which are meaningful option values)."""

    _instance: Optional["_Unset"] = None

    def __new__(cls) -> "_Unset":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNSET"

    def __bool__(self) -> bool:
        return False

    def __reduce__(self):
        return (_Unset, ())


UNSET = _Unset()

_DEFAULTS: dict = {
    "vmem_budget": None,    # None -> the tier's on-chip bytes
    "align": MXU,
    "cache": None,          # None -> default on-disk TuningCache
    "max_points": MAX_POINTS,
    "measure": None,        # None -> purely analytic; "top_k" -> measured
    "top_k": TOP_K,
    "timing_db": None,      # None -> default on-disk TimingDB
    "profile": None,        # None -> persisted calibration profile
    "warmup": MEASURE_WARMUP,
    "repeat": MEASURE_REPEAT,
    "depths": DEPTHS,
    "policy": None,         # None -> resilience.default_policy()
    "bucketing": False,     # shape-bucketed warm starts (core.buckets)
    "trace": False,         # telemetry tracing spans (telemetry.py)
}

_POLICY_VARS = ("REPRO_TIMEOUT_S", "REPRO_RETRIES", "REPRO_BACKOFF_S",
                "REPRO_CERTIFY")

_TRUTHY = ("1", "true", "on", "yes")


@dataclasses.dataclass(frozen=True)
class Options:
    """Every ``explore`` / ``explore_pipeline`` option in one frozen
    value.  Fields default to ``UNSET``; ``resolved()`` fills the
    built-in defaults.  Precedence when combined with the keyword
    arguments (see ``dse._resolve_options``): explicit kwarg beats
    ``Options`` beats env beats default.

    Fields mirror the keyword arguments: ``vmem_budget`` (bytes; None
    is the tier's), ``align`` (lane multiple), ``cache`` (None default
    / False off / path / TuningCache), ``max_points``, ``measure``
    (None or ``"top_k"``), ``top_k``, ``timing_db`` (None / False /
    path / TimingDB), ``profile`` (None persisted / False uncalibrated
    / object), ``warmup``, ``repeat``, ``depths``, ``policy``
    (resilience.Policy), ``bucketing`` (``core.buckets``) and ``trace``
    (telemetry spans, ``core.telemetry``).
    """

    vmem_budget: Any = UNSET
    align: Any = UNSET
    cache: Any = UNSET
    max_points: Any = UNSET
    measure: Any = UNSET
    top_k: Any = UNSET
    timing_db: Any = UNSET
    profile: Any = UNSET
    warmup: Any = UNSET
    repeat: Any = UNSET
    depths: Any = UNSET
    policy: Any = UNSET
    bucketing: Any = UNSET
    trace: Any = UNSET

    @classmethod
    def from_env(cls) -> "Options":
        """The single place the tuning ``REPRO_*`` env vars are read.

        ===================  ============================================
        ``REPRO_MEASURE``    ``measure`` (``top_k`` -> measured DSE)
        ``REPRO_DSE_CACHE``  ``cache`` (tuning-cache path)
        ``REPRO_TIMING_DB``  ``timing_db`` (timing-DB path)
        ``REPRO_TIMEOUT_S``  \\
        ``REPRO_RETRIES``     } ``policy`` (built via
        ``REPRO_BACKOFF_S``   } ``resilience.default_policy`` when any
        ``REPRO_CERTIFY``    /  of the four is set)
        ``REPRO_BUCKETING``  ``bucketing`` (1/true/on/yes)
        ``REPRO_TRACE``      ``trace`` (1/true/on/yes enables spans)
        ===================  ============================================

        ``REPRO_CALIB_PROFILE`` names the calibration file that a
        ``profile=None`` resolution loads (``calibrate.load_profile``),
        and ``REPRO_FAULTS`` / ``REPRO_FAULTS_SEED`` drive fault
        injection (``resilience.inject``), which is not an exploration
        option.  The names are the reference's; the port's entries never
        hit as the reference's (their device kinds differ, see
        ``measure.device_kind``).
        """
        kw: dict = {}
        m = os.environ.get("REPRO_MEASURE")
        if m is not None:
            kw["measure"] = m or None
        c = os.environ.get("REPRO_DSE_CACHE")
        if c:
            kw["cache"] = c
        t = os.environ.get("REPRO_TIMING_DB")
        if t:
            kw["timing_db"] = t
        if any(os.environ.get(v) is not None for v in _POLICY_VARS):
            kw["policy"] = resilience.default_policy()
        b = os.environ.get("REPRO_BUCKETING")
        if b is not None:
            kw["bucketing"] = b.strip().lower() in _TRUTHY
        tr = os.environ.get("REPRO_TRACE")
        if tr is not None:
            kw["trace"] = tr.strip().lower() in _TRUTHY
        return cls(**kw)

    @staticmethod
    def merged(*layers: "Options") -> "Options":
        """Per-field first-non-``UNSET`` merge, highest priority first."""
        kw: dict = {}
        for f in dataclasses.fields(Options):
            for layer in layers:
                v = getattr(layer, f.name)
                if v is not UNSET:
                    kw[f.name] = v
                    break
        return Options(**kw)

    def resolved(self) -> "Options":
        """``UNSET`` fields replaced by the built-in defaults, with the
        value-level normalization of the keyword arguments: ``measure``
        in (None, False, "") -> None (else must be ``"top_k"``),
        ``depths`` coerced to a tuple of ints."""
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if v is UNSET:
                kw[k] = _DEFAULTS[k]
        if kw["measure"] in (None, False, ""):
            kw["measure"] = None
        elif kw["measure"] != "top_k":
            raise ValueError(f"measure={kw['measure']!r}; "
                             f"supported: None, 'top_k'")
        kw["depths"] = tuple(int(d) for d in kw["depths"])
        kw["bucketing"] = bool(kw["bucketing"])
        kw["trace"] = bool(kw["trace"])
        return Options(**kw)
