"""Cost-model calibration: fit analytic coefficients to measured runs.

The analytic model (``core.cost``) prices a candidate as overlapped
main-memory stream time at the tier's datasheet bandwidth.  Real
kernels also pay a fixed per-grid-step cost (launch, pipeline fill, the
plain versions' dispatch on the CPU) and rarely reach datasheet
bandwidth, so measured runs are regressed onto a two-term model

    measured_s  ~=  s_per_byte * stream_bytes  +  overhead_s[kind] * steps

where ``stream_bytes`` is the candidate's overlap-adjusted analytic
byte count, ``steps`` its grid-step count, and ``kind`` the root
pattern type (per-template fixed cost).  ``1 / s_per_byte`` is the
*effective* bandwidth the device sustains.

The least-squares fit (``fit``) is the reference's, deterministic --
same samples, same coefficients bit-for-bit -- and guarded: when the
affine model ranks the in-sample candidates *worse* than a pure
bandwidth rescale (which preserves the analytic ranking exactly), the
profile falls back to scale-only.  The prior bandwidth (the uncalibrated
price and the scale fallback's floor) is the tier of the device being
measured (``cost.device_tier``: 3.35 TB/s on an H100 SXM), not the
reference's TPU figure; handed ``cost.TPU`` it is the reference's.

Profiles persist per (device kind, ``dse.MODEL_VERSION``) next to the
DSE tuning cache; ``active_profile_hash`` folds the on-disk profile
into every DSE cache key so tuned plans invalidate on recalibration.
A profile file holds the port's profile and sample ledger under the
device kind's own section, so a file the reference also writes (one
``REPRO_CALIB_PROFILE`` for both packages) never mixes their samples.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost import Tier, device_tier
from .measure import _device, device_kind, spearman

UNCALIBRATED = "uncalibrated"


def _model_version() -> int:
    from .dse import MODEL_VERSION  # lazy: dse imports this module
    return MODEL_VERSION


# --------------------------------------------------------------------------
# Samples and profiles
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sample:
    """One measured candidate: analytic features + measured seconds."""

    workload: str       # groups candidates for rank comparisons
    kind: str           # root pattern type -> overhead coefficient
    stream_bytes: float  # overlap-adjusted analytic HBM bytes
    steps: int          # kernel grid steps (fixed-cost trips)
    measured_s: float
    key: str = ""       # dedup identity (the timing-DB key)

    def to_json(self) -> Dict:
        return {"workload": self.workload, "kind": self.kind,
                "stream_bytes": float(self.stream_bytes),
                "steps": int(self.steps),
                "measured_s": float(self.measured_s), "key": self.key}

    @classmethod
    def from_json(cls, d: Dict) -> "Sample":
        return cls(workload=str(d["workload"]), kind=str(d["kind"]),
                   stream_bytes=float(d["stream_bytes"]),
                   steps=int(d["steps"]),
                   measured_s=float(d["measured_s"]),
                   key=str(d.get("key", "")))

    @property
    def identity(self) -> str:
        return self.key or f"{self.workload}|{self.stream_bytes}|{self.steps}"


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Fitted coefficients for one device at one cost-model revision."""

    device: str
    model_version: int
    s_per_byte: float                 # 1 / effective tier bandwidth
    overhead_s: Dict[str, float]      # per pattern kind, per grid step
    n_samples: int = 0
    mean_abs_err_s: float = 0.0       # in-sample fit residual
    mode: str = "affine"              # "affine" | "scale"

    @property
    def bandwidth_bytes_per_s(self) -> float:
        return 1.0 / max(self.s_per_byte, 1e-30)

    def seconds(self, kind: str, stream_bytes: float,
                steps: int = 1) -> float:
        """Calibrated prediction for one candidate."""
        return (stream_bytes * self.s_per_byte
                + steps * self.overhead_s.get(kind, 0.0))

    def to_json(self) -> Dict:
        return {"device": self.device,
                "model_version": int(self.model_version),
                "s_per_byte": float(self.s_per_byte),
                "overhead_s": {k: float(v)
                               for k, v in sorted(self.overhead_s.items())},
                "n_samples": int(self.n_samples),
                "mean_abs_err_s": float(self.mean_abs_err_s),
                "mode": self.mode}

    @classmethod
    def from_json(cls, d: Dict) -> "CalibrationProfile":
        return cls(device=str(d["device"]),
                   model_version=int(d["model_version"]),
                   s_per_byte=float(d["s_per_byte"]),
                   overhead_s={k: float(v)
                               for k, v in d.get("overhead_s", {}).items()},
                   n_samples=int(d.get("n_samples", 0)),
                   mean_abs_err_s=float(d.get("mean_abs_err_s", 0.0)),
                   mode=str(d.get("mode", "affine")))

    @property
    def hash(self) -> str:
        raw = json.dumps(self.to_json(), sort_keys=True)
        return hashlib.sha256(raw.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------


def _rank_quality(samples: Sequence[Sample],
                  predict) -> float:
    """Mean per-workload Spearman rho of ``predict(sample)`` vs the
    measured seconds (workloads with < 2 candidates contribute 1.0)."""
    by_wl: Dict[str, List[Sample]] = {}
    for s in samples:
        by_wl.setdefault(s.workload, []).append(s)
    rhos = [spearman([predict(s) for s in group],
                     [s.measured_s for s in group])
            for group in by_wl.values()]
    return sum(rhos) / len(rhos)


def _weights(samples: Sequence[Sample]) -> "np.ndarray":
    """Relative (1/measured) weighting: a 90 ms GEMM sample must not
    drown out a 500 us pipeline's coefficients -- every sample counts
    by its *relative* fit error, which is also what rank fidelity
    cares about."""
    return 1.0 / np.maximum(
        np.array([s.measured_s for s in samples], dtype=np.float64),
        1e-12)


def prior_tier(tier: Optional[Tier] = None) -> Tier:
    """``tier``, else the tier of the device measured (the card when
    there is one; ``cost.DEFAULT_TIER`` on the CPU)."""
    return tier if tier is not None else device_tier(_device(None))


def _scale_only(samples: Sequence[Sample], tier: Tier) -> float:
    """Weighted least-squares bandwidth rescale through the origin
    (preserves the analytic candidate ranking exactly)."""
    w = _weights(samples)
    b = np.array([s.stream_bytes for s in samples], dtype=np.float64)
    y = np.array([s.measured_s for s in samples], dtype=np.float64)
    num = float(np.sum(w * w * y * b))
    den = float(np.sum(w * w * b * b))
    scale = num / den if den > 0 else 0.0
    return scale if scale > 0 else 1.0 / tier.hbm_bytes_per_s


def fit(samples: Sequence[Sample], *, device: Optional[str] = None,
        model_version: Optional[int] = None,
        tier: Optional[Tier] = None) -> CalibrationProfile:
    """Deterministic least-squares calibration fit.

    Solves ``measured ~= s_per_byte * bytes + overhead[kind] * steps``
    over all samples jointly (one bandwidth column, one overhead column
    per pattern kind), in float64 via the normal equations with a tiny
    ridge (well-posed even when a kind has a single sample), weighted
    by 1/measured so every workload counts by *relative* error.
    Negative coefficients are clamped to the physical floor (a kernel
    cannot stream faster than free or launch in negative time), and
    the rank-quality guard above picks scale-only when the affine
    model orders the fitted candidates worse.  ``tier`` is the prior
    (``prior_tier``); ``device`` a device kind (``measure.device_kind``).
    """
    from . import telemetry

    # canonical sample order: the fit is bit-for-bit reproducible for
    # the same sample *set*, whatever order callers accumulated it in
    samples = sorted(samples,
                     key=lambda s: (s.workload, s.kind, s.key,
                                    s.stream_bytes, s.steps,
                                    s.measured_s))
    if not samples:
        raise ValueError("calibrate.fit: no samples")
    device = device or device_kind()
    version = _model_version() if model_version is None else model_version
    with telemetry.span("calibrate.fit", n_samples=len(samples),
                        device=device) as sp:
        prof = _fit_body(samples, device, version, prior_tier(tier))
        sp.set(mode=prof.mode, mean_abs_err_s=prof.mean_abs_err_s)
    telemetry.gauge("calibrate.n_samples", len(samples))
    telemetry.gauge("calibrate.mean_abs_err_s", prof.mean_abs_err_s)
    return prof


def _fit_body(samples: Sequence[Sample], device: str,
              version: int, tier: Tier) -> CalibrationProfile:

    kinds = sorted({s.kind for s in samples})
    col = {k: 1 + i for i, k in enumerate(kinds)}
    a = np.zeros((len(samples), 1 + len(kinds)), dtype=np.float64)
    y = np.array([s.measured_s for s in samples], dtype=np.float64)
    for i, s in enumerate(samples):
        a[i, 0] = s.stream_bytes
        a[i, col[s.kind]] = s.steps
    w = _weights(samples)
    aw = a * w[:, None]
    yw = y * w
    # column equilibration + normal equations + tiny ridge:
    # deterministic, well-posed when columns are collinear (e.g. one
    # candidate per kind), and the ridge cannot distort coefficients
    # whose natural scales differ by orders of magnitude
    norms = np.sqrt((aw * aw).sum(axis=0))
    norms = np.where(norms > 0, norms, 1.0)
    an = aw / norms
    ata = an.T @ an
    x = np.linalg.solve(ata + 1e-12 * np.eye(ata.shape[0]),
                        an.T @ yw) / norms

    s_per_byte = float(x[0])
    overhead = {k: max(float(x[col[k]]), 0.0) for k in kinds}

    scale = _scale_only(samples, tier)
    use_scale = s_per_byte <= 0
    if not use_scale:
        affine_q = _rank_quality(
            samples, lambda s: s.stream_bytes * s_per_byte
            + s.steps * overhead.get(s.kind, 0.0))
        scale_q = _rank_quality(samples, lambda s: s.stream_bytes * scale)
        use_scale = affine_q < scale_q

    if use_scale:
        s_per_byte, overhead, mode = scale, {k: 0.0 for k in kinds}, "scale"
    else:
        mode = "affine"

    err = sum(abs(s.stream_bytes * s_per_byte
                  + s.steps * overhead.get(s.kind, 0.0) - s.measured_s)
              for s in samples) / len(samples)
    return CalibrationProfile(device=device, model_version=version,
                              s_per_byte=s_per_byte, overhead_s=overhead,
                              n_samples=len(samples),
                              mean_abs_err_s=float(err), mode=mode)


def predicted_seconds(kind: str, stream_bytes: float, steps: int = 1, *,
                      profile: Optional[CalibrationProfile] = None,
                      tier: Optional[Tier] = None) -> float:
    """Price ``stream_bytes`` of overlapped main-memory traffic: the
    tier's datasheet bandwidth when uncalibrated, the fitted profile
    otherwise.  The single seam through which calibration feeds
    ``cost.traffic``-based pricing (``dse.price`` /
    ``dse.explore_pipeline``)."""
    if profile is None:
        return stream_bytes / prior_tier(tier).hbm_bytes_per_s
    return profile.seconds(kind, stream_bytes, steps)


# --------------------------------------------------------------------------
# Persistence (profile + sample ledger in one device-keyed file)
# --------------------------------------------------------------------------


def profile_path(device: Optional[str] = None,
                 model_version: Optional[int] = None) -> str:
    """``REPRO_CALIB_PROFILE`` if set; else a per-(device, model
    version) file next to the DSE tuning cache / in the XDG cache."""
    from .measure import cache_sibling_path

    device = device or device_kind()
    version = _model_version() if model_version is None else model_version
    return cache_sibling_path(f"calibration_{device}_v{version}.json",
                              "REPRO_CALIB_PROFILE")


def _section(device: str) -> str:
    return f"repro_torch:{device}"


def _read_doc(path: str, device: str) -> Dict:
    """Crash-safe profile/ledger read of one device kind's section: a
    truncated or corrupt file is quarantined to ``<path>.corrupt``
    (warning names it) and the calibration starts fresh instead of
    silently dropping data."""
    from . import resilience
    doc = resilience.load_store(path, label="calibration profile")
    sec = doc.get(_section(device))
    return sec if isinstance(sec, dict) else {}


def load_profile(device: Optional[str] = None, *,
                 path: Optional[str] = None
                 ) -> Optional[CalibrationProfile]:
    """The persisted profile for this device at the current model
    version, or None (uncalibrated).  A profile written for another
    device or an older cost-model revision is ignored, never reused."""
    device = device or device_kind()
    path = path or profile_path(device)
    doc = _read_doc(path, device).get("profile")
    if not doc:
        return None
    try:
        prof = CalibrationProfile.from_json(doc)
    except (KeyError, TypeError, ValueError):
        return None
    if prof.device != device or prof.model_version != _model_version():
        return None
    return prof


def load_samples(device: Optional[str] = None, *,
                 path: Optional[str] = None) -> List[Sample]:
    device = device or device_kind()
    path = path or profile_path(device)
    out = []
    for d in _read_doc(path, device).get("samples", []):
        try:
            out.append(Sample.from_json(d))
        except (KeyError, TypeError, ValueError):
            continue
    return out


_hash_cache: Dict[Tuple[str, str], Tuple[float, str]] = {}


def active_profile_hash(device: Optional[str] = None, *,
                        path: Optional[str] = None) -> str:
    """Short hash of the on-disk profile (``"uncalibrated"`` when there
    is none) -- a component of every DSE tuning-cache key, so plans
    priced under a stale calibration are never replayed."""
    device = device or device_kind()
    path = path or profile_path(device)
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return UNCALIBRATED
    hit = _hash_cache.get((path, device))
    if hit is not None and hit[0] == mtime:
        return hit[1]
    prof = load_profile(device, path=path)
    h = prof.hash if prof is not None else UNCALIBRATED
    _hash_cache[(path, device)] = (mtime, h)
    return h


def observe(new_samples: Sequence[Sample], *,
            device: Optional[str] = None,
            path: Optional[str] = None,
            tier: Optional[Tier] = None) -> CalibrationProfile:
    """Merge measured samples into the device ledger, refit, persist.

    Dedup is by sample identity (the timing-DB key), so re-exploring a
    cached candidate does not double-weight it.  Returns the refreshed
    profile (also the new ``active_profile_hash`` source).
    """
    from . import resilience

    device = device or device_kind()
    path = path or profile_path(device)
    fitted: List[CalibrationProfile] = []

    def merge(data: Dict) -> None:
        # re-reads the ledger *inside* the store lock: samples another
        # process observed between our load and our write survive
        sec = data.get(_section(device))
        sec = sec if isinstance(sec, dict) else {}
        merged: Dict[str, Sample] = {}
        for d in sec.get("samples", []):
            try:
                s = Sample.from_json(d)
            except (KeyError, TypeError, ValueError):
                continue
            merged[s.identity] = s
        for s in new_samples:
            merged[s.identity] = s
        samples = [merged[k] for k in sorted(merged)]
        prof = fit(samples, device=device, tier=tier)
        data[_section(device)] = {
            "profile": prof.to_json(),
            "samples": [s.to_json() for s in samples]}
        fitted.append(prof)

    resilience.locked_update(path, merge, label="calibration profile",
                             prefix=".calibration.", indent=1)
    _hash_cache.pop((path, device), None)
    return fitted[-1]
