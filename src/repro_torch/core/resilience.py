"""Fault tolerance for the tuning runtime (quarantine, deadlines,
certification, crash-safe stores, fault injection).

The measured loop (``dse.explore(measure="top_k")`` ->
``codegen_cuda.lower_for_timing`` -> ``measure.measure`` ->
``calibrate.observe``) builds and runs candidate kernels on the card;
any step can raise, hang, or -- worst -- silently produce wrong numbers
that would then be cached and served.  A failing candidate must cost
one candidate, not the exploration.  This module enforces that, as the
reference's does:

  * **Failure taxonomy + structured events** -- every fallback,
    quarantine, retry and store rebuild is a ``FailureEvent`` recorded
    in the process-wide ``LOG`` (and mirrored to ``logging``).  The
    taxonomy splits *expected* candidate failures (``EXPECTED_ERRORS``:
    lowering/type errors, a launch configuration the card refuses, an
    nvcc failure, deadlines, injected faults, out of memory) from real
    bugs (``AttributeError``, ``NameError``, assertion failures), which
    always propagate.
  * **Sticky CUDA errors propagate.**  An illegal address, a launch
    failure, a trap or device assert, or any ``torch.AcceleratorError``
    poisons the CUDA context: every later candidate would fail on it.
    ``kernels.build.check`` raises ``StickyCudaError`` for them, and
    ``call_guarded`` turns a sticky error raised through ``torch`` into
    one; it is not in ``EXPECTED_ERRORS`` and is never quarantined.
  * **Candidate quarantine** -- a candidate whose lowering, timing or
    certification fails is recorded in the DSE tuning cache (keyed per
    device + plain/kernel mode) and never re-attempted.
  * **Deadlines + retry/backoff** (``call_guarded`` /
    ``run_with_deadline``) -- per-candidate work runs under a wall-clock
    deadline in a worker thread; transient failures (``OSError``,
    ``MemoryError``, ``torch.OutOfMemoryError`` after emptying the
    allocator's cache) are retried with exponential backoff.  The
    measured DSE builds every candidate's kernels with nvcc *before*
    the guarded timing (``dse._build_candidates``), so a build never
    counts against a deadline.
  * **Plan certification** (``certify_tile_plan`` /
    ``certify_pipeline_plan``) -- before a measured winner is promoted
    into the tuning cache, its kernel's output is checked against the
    port's eager oracle (``codegen_torch`` for a pattern,
    ``pipeline.run_unfused`` for a pipeline) on the inputs' device with
    dtype-aware tolerances.  The oracle only decides the certificate;
    it is never what a call returns.
  * **Crash-safe stores** (``load_store`` / ``save_store`` /
    ``locked_update``) -- checksummed, versioned, lock-protected atomic
    JSON shared by the tuning cache, the timing DB and the calibration
    profile.  A corrupt file is moved to ``<path>.corrupt`` and the
    store rebuilds fresh; a version-skewed store is ignored.
  * **Deterministic fault injection** (``REPRO_FAULTS=lower:0.5,
    time:0.3``) -- ``inject(site)`` raises ``InjectedFault`` on a
    counter-hashed schedule (``sha256(seed|site|n)``, the reference's),
    so the same env and call sequence inject the same faults.

Env knobs (read per ``default_policy()`` call): ``REPRO_FAULTS``,
``REPRO_TIMEOUT_S`` (per-candidate deadline, default 120; ``0``
disables), ``REPRO_RETRIES`` (default 1), ``REPRO_BACKOFF_S`` (default
0.05), ``REPRO_CERTIFY`` (``0`` skips winner certification).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import os
import queue
import tempfile
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from . import telemetry
from ..device import StickyCudaError

logger = logging.getLogger("repro_torch.resilience")

# Persistent-store format revision.  Bumped when the on-disk envelope
# (not the payload semantics -- those carry their own versions, e.g.
# dse.MODEL_VERSION inside every cache key) changes incompatibly.
STORE_VERSION = 1

# --------------------------------------------------------------------------
# Failure taxonomy
# --------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """A deliberate failure raised by the fault-injection harness."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


class DeadlineExceeded(TimeoutError):
    """A guarded call outlived its per-candidate deadline."""


class CandidateFailure(Exception):
    """A classified, *expected* candidate failure: the candidate is
    quarantined and exploration continues.  ``kind`` is the taxonomy
    bucket, ``detail`` the human-readable reason."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"{kind}: {detail}")
        self.kind = kind
        self.detail = detail


# Exceptions a lowering/compile/timing boundary is *allowed* to throw:
# template mismatches and unsupported shapes (ValueError/TypeError/
# KeyError/IndexError/NotImplementedError), a refused launch
# configuration or an nvcc failure (RuntimeError), numeric traps, I/O
# and memory exhaustion, deadlines and injected faults.  Everything
# else -- Attribute/Name/ImportError, assertion failures, and a sticky
# CUDA error (``StickyCudaError``, not a RuntimeError) -- propagates
# instead of being quarantined.
EXPECTED_ERRORS: Tuple[type, ...] = (
    ValueError, TypeError, KeyError, IndexError, NotImplementedError,
    ArithmeticError, RuntimeError, OSError, MemoryError,
    DeadlineExceeded,
)

# Failure kinds a retry can plausibly fix (resource blips).  A
# deadline is NOT retryable: the work already burned a full timeout,
# and a deterministic hang would just burn another.
RETRYABLE_KINDS = frozenset({"transient"})

# what torch says for the context-poisoning errors it raises as a
# plain RuntimeError (builds without ``torch.AcceleratorError``)
_STICKY_TEXT = ("illegal memory access", "unspecified launch failure",
                "device-side assert", "misaligned address",
                "illegal instruction", "an illegal address",
                "hardware stack error", "uncorrectable ECC")


def _out_of_memory(exc: BaseException) -> bool:
    import torch
    return isinstance(exc, torch.OutOfMemoryError)


def is_sticky(exc: BaseException) -> bool:
    """Does ``exc`` mean the CUDA context is poisoned?  A
    ``StickyCudaError`` (``kernels.build.check``), any
    ``torch.AcceleratorError``, or torch's RuntimeError for one of the
    sticky errors."""
    if isinstance(exc, StickyCudaError):
        return True
    import torch
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return (isinstance(exc, RuntimeError) and not _out_of_memory(exc)
            and "CUDA" in str(exc)
            and any(t in str(exc) for t in _STICKY_TEXT))


def classify(exc: BaseException) -> str:
    """Map an exception from a guarded boundary onto the taxonomy
    (the reference's, plus ``cuda-sticky`` and out of memory as
    ``transient``)."""
    if isinstance(exc, InjectedFault):
        return f"injected:{exc.site}"
    if isinstance(exc, DeadlineExceeded):
        return "timeout"
    if is_sticky(exc):
        return "cuda-sticky"
    if isinstance(exc, NotImplementedError):
        return "lower-unsupported"
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError)):
        return "lower-error"
    if isinstance(exc, ArithmeticError):
        return "numeric-error"
    if isinstance(exc, (OSError, MemoryError)) or _out_of_memory(exc):
        return "transient"
    if isinstance(exc, RuntimeError):
        return "compile-error"
    return f"unexpected:{type(exc).__name__}"


# --------------------------------------------------------------------------
# Structured events
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One structured degradation event.

    ``stage``: where in the runtime ("lower", "time", "certify",
    "store", "tile"); ``kind``: taxonomy bucket from ``classify``;
    ``key``: the candidate / file identity; ``action``: what the
    runtime did about it ("quarantined", "skipped", "retried",
    "fallback", "rebuilt"); ``detail``: human-readable reason.
    """

    stage: str
    kind: str
    key: str
    action: str
    detail: str = ""

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class EventLog:
    """Process-wide append-only log of degradation events.

    ``counts()`` aggregates by action.  Thread-safe (the deadline
    worker threads record through it).

    Storage-wise this is a facade over the single structured event
    stream in ``core.telemetry`` (each ``EventLog`` instance owns a
    stream name; the process-wide ``LOG`` uses ``"resilience"``), so
    degradation events land in the same export as spans.
    """

    _ids = itertools.count()

    def __init__(self):
        i = next(EventLog._ids)
        self.stream = "resilience" if i == 0 else f"resilience.{i}"
        self._once: set = set()
        self._lock = threading.Lock()

    def record(self, event: FailureEvent) -> None:
        telemetry.emit(self.stream, event.kind, stage=event.stage,
                       key=event.key, action=event.action,
                       detail=event.detail)
        logger.warning("resilience[%s/%s] %s: %s (%s)", event.stage,
                       event.kind, event.action, event.key, event.detail)

    def record_once(self, event: FailureEvent) -> bool:
        """Record unless an identical (stage, kind, key, action) event
        was already logged -- for per-candidate hot paths where one
        systematic fallback would otherwise flood the log."""
        sig = (event.stage, event.kind, event.key, event.action)
        with self._lock:
            if sig in self._once:
                return False
            self._once.add(sig)
        self.record(event)
        return True

    def events(self, *, stage: Optional[str] = None,
               action: Optional[str] = None) -> List[FailureEvent]:
        evs = [FailureEvent(stage=e.get("stage", ""), kind=e["kind"],
                            key=e.get("key", ""),
                            action=e.get("action", ""),
                            detail=e.get("detail", ""))
               for e in telemetry.events(self.stream)]
        if stage is not None:
            evs = [e for e in evs if e.stage == stage]
        if action is not None:
            evs = [e for e in evs if e.action == action]
        return evs

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events():
            out[e.action] = out.get(e.action, 0) + 1
        return out

    def reset(self) -> None:
        telemetry.clear_events(self.stream)
        with self._lock:
            self._once.clear()


LOG = EventLog()


def record(stage: str, kind: str, key: str, action: str,
           detail: str = "") -> FailureEvent:
    """Record one degradation event in the process-wide ``LOG``."""
    ev = FailureEvent(stage=stage, kind=kind, key=key, action=action,
                      detail=detail)
    LOG.record(ev)
    return ev


def record_once(stage: str, kind: str, key: str, action: str,
                detail: str = "") -> FailureEvent:
    """``record`` deduplicated on (stage, kind, key, action)."""
    ev = FailureEvent(stage=stage, kind=kind, key=key, action=action,
                      detail=detail)
    LOG.record_once(ev)
    return ev


# --------------------------------------------------------------------------
# Deterministic fault injection
# --------------------------------------------------------------------------


class FaultInjector:
    """Deterministic per-site fault schedule.

    ``specs`` maps a site name ("lower", "time", "certify",
    "store-load", ...) to a failure probability in [0, 1].  The n-th
    call at a site fails iff ``sha256(seed|site|n)`` maps below the
    probability -- no global RNG state, so the same env + the same
    call sequence produces the same faults in every process.
    """

    def __init__(self, specs: Optional[Dict[str, float]] = None,
                 seed: int = 0):
        self.specs = dict(specs or {})
        self.seed = seed
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultInjector":
        """Parse ``"lower:0.5,time:1,certify:0.25"`` (an entry without
        a probability means 1.0).  Malformed entries raise ValueError
        -- a typo'd chaos config must not silently inject nothing."""
        specs: Dict[str, float] = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            site, _, prob = part.partition(":")
            site = site.strip()
            if not site:
                raise ValueError(f"REPRO_FAULTS: empty site in {text!r}")
            p = float(prob) if prob.strip() else 1.0
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"REPRO_FAULTS: probability {p} for site "
                    f"{site!r} outside [0, 1]")
            specs[site] = p
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> "FaultInjector":
        text = os.environ.get("REPRO_FAULTS", "")
        seed = int(os.environ.get("REPRO_FAULTS_SEED", "0") or 0)
        return cls.parse(text, seed=seed) if text else cls()

    def maybe_fail(self, site: str, detail: str = "") -> None:
        p = self.specs.get(site, 0.0)
        if p <= 0.0:
            return
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
        raw = f"{self.seed}|{site}|{n}".encode()
        u = int.from_bytes(hashlib.sha256(raw).digest()[:8],
                           "big") / 2.0 ** 64
        if u < p:
            raise InjectedFault(site, detail or f"call #{n}")


# ambient injector parsed lazily from REPRO_FAULTS; cached on the env
# string so the counter sequence survives across calls within one
# process but a monkeypatched env takes effect immediately
_ambient: Tuple[str, Optional[FaultInjector]] = ("", None)
_ambient_lock = threading.Lock()


def ambient_injector() -> FaultInjector:
    global _ambient
    text = os.environ.get("REPRO_FAULTS", "")
    with _ambient_lock:
        if _ambient[1] is None or _ambient[0] != text:
            seed = int(os.environ.get("REPRO_FAULTS_SEED", "0") or 0)
            _ambient = (text, FaultInjector.parse(text, seed=seed)
                        if text else FaultInjector())
        return _ambient[1]


def inject(site: str, detail: str = "") -> None:
    """Fault hook: raise ``InjectedFault`` when the ambient
    ``REPRO_FAULTS`` schedule says this call at this site fails.
    A no-op (one dict lookup) when no faults are configured."""
    ambient_injector().maybe_fail(site, detail)


# --------------------------------------------------------------------------
# Policy: deadlines, retries, certification
# --------------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using "
                      f"default {default}", stacklevel=2)
        return default


@dataclasses.dataclass(frozen=True)
class Policy:
    """Fault-tolerance policy threaded through the tuning entry points.

    ``timeout_s``: wall-clock deadline per guarded candidate step
    (lower+compile+time); ``<= 0`` disables the deadline.
    ``retries``: extra attempts for *transient* failures only.
    ``backoff_s``: base sleep before retry ``i`` (``backoff_s * 2**i``).
    ``certify``: numerically validate measured winners against the
    eager oracle before they are promoted into the DSE cache.
    """

    timeout_s: float = 120.0
    retries: int = 1
    backoff_s: float = 0.05
    certify: bool = True


def default_policy() -> Policy:
    """Policy from the environment (``REPRO_TIMEOUT_S`` /
    ``REPRO_RETRIES`` / ``REPRO_BACKOFF_S`` / ``REPRO_CERTIFY``)."""
    return Policy(
        timeout_s=_env_float("REPRO_TIMEOUT_S", 120.0),
        retries=int(_env_float("REPRO_RETRIES", 1)),
        backoff_s=_env_float("REPRO_BACKOFF_S", 0.05),
        certify=os.environ.get("REPRO_CERTIFY", "1").strip()
        not in ("0", "false", "no"),
    )


def resolve_policy(policy: Optional[Policy]) -> Policy:
    """``None`` -> the env-derived default, else the given policy."""
    return default_policy() if policy is None else policy


def run_with_deadline(fn: Callable[[], object], timeout_s: float,
                      *, label: str = "") -> object:
    """``fn()`` bounded by a wall-clock deadline.

    The work runs in a daemon worker thread; when it misses the
    deadline, ``DeadlineExceeded`` is raised and the worker is
    *abandoned* (Python cannot kill a thread wedged inside a C
    extension -- the hung compile keeps its thread, but the explorer
    moves on, which is the degradation the tuning loop needs).
    ``timeout_s <= 0`` runs inline with no deadline.
    """
    if timeout_s is None or timeout_s <= 0:
        return fn()
    out: "queue.Queue" = queue.Queue(maxsize=1)

    def work():
        try:
            out.put((True, fn()))
        except BaseException as exc:  # propagated to the caller below
            out.put((False, exc))

    t = threading.Thread(target=work, daemon=True,
                         name=f"deadline:{label or 'candidate'}")
    t.start()
    try:
        ok, val = out.get(timeout=timeout_s)
    except queue.Empty:
        raise DeadlineExceeded(
            f"{label or 'candidate'} exceeded {timeout_s:g}s deadline"
        ) from None
    if ok:
        return val
    raise val


def call_guarded(fn: Callable[[], object], *, stage: str, key: str,
                 policy: Optional[Policy] = None) -> object:
    """Run one candidate step under the policy's deadline + retry.

    Expected failures (``EXPECTED_ERRORS`` + injected faults) are
    classified and re-raised as ``CandidateFailure`` -- the caller
    quarantines and continues.  Transient kinds are retried
    ``policy.retries`` times with exponential backoff first (each
    retry recorded as an event).  Unexpected exceptions propagate
    unchanged: a real bug must surface, not be quarantined.
    """
    pol = resolve_policy(policy)
    attempts = max(int(pol.retries), 0) + 1
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return run_with_deadline(fn, pol.timeout_s, label=key)
        except StickyCudaError:
            raise
        except (InjectedFault,) + EXPECTED_ERRORS as exc:
            if is_sticky(exc):
                # the context is gone: exploring on would time every
                # later candidate on a dead card
                raise StickyCudaError(f"{stage} {key}: {exc}") from exc
            kind = classify(exc)
            last = exc
            if kind in RETRYABLE_KINDS and attempt + 1 < attempts:
                record(stage, kind, key, "retried",
                       f"attempt {attempt + 1}/{attempts}: {exc}")
                if _out_of_memory(exc):
                    import torch
                    torch.cuda.empty_cache()
                time.sleep(pol.backoff_s * (2 ** attempt))
                continue
            raise CandidateFailure(kind, str(exc)) from exc
        except BaseException as exc:
            if is_sticky(exc) and not isinstance(exc, StickyCudaError):
                raise StickyCudaError(f"{stage} {key}: {exc}") from exc
            raise
    raise CandidateFailure(classify(last), str(last)) from last


# --------------------------------------------------------------------------
# Crash-safe persistent stores (checksummed + locked + quarantining)
# --------------------------------------------------------------------------


def _payload_checksum(data: Dict) -> str:
    raw = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


class _FileLock:
    """Best-effort advisory lock on ``<path>.lock`` (fcntl where
    available).  Lock failures degrade to unlocked operation -- the
    stores are accelerators; losing an update race is acceptable,
    corrupting a reader is not (atomic replace prevents that)."""

    def __init__(self, path: str):
        self.path = path + ".lock"
        self._fd: Optional[int] = None

    def __enter__(self) -> "_FileLock":
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            import fcntl
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except (OSError, ImportError):
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            try:
                import fcntl
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            except (OSError, ImportError):
                pass
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


def atomic_write_json(path: str, doc, *, prefix: str = ".tmp.",
                      indent: int = 0) -> None:
    """mkstemp + rename JSON write shared by the persistent stores.
    An ``OSError`` (read-only FS etc.) is swallowed: every store is an
    accelerator whose callers keep their in-memory copy, never a
    correctness dependency."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=prefix)
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=indent, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def quarantine_file(path: str, *, label: str = "store",
                    reason: str = "corrupt") -> Optional[str]:
    """Move a damaged store to ``<path>.corrupt`` (never deleted: the
    evidence survives for forensics) and warn, naming the file.
    Returns the quarantine path, or None when the move failed."""
    dst = path + ".corrupt"
    try:
        os.replace(path, dst)
    except OSError:
        dst = None
    warnings.warn(
        f"{label} at {path} is {reason}; "
        + (f"quarantined to {dst}" if dst else "quarantine move failed")
        + " -- rebuilding fresh", stacklevel=3)
    record("store", f"store-{reason}", path, "rebuilt",
           f"{label} quarantined to {dst or '<unmoved>'}")
    return dst


def load_store(path: str, *, label: str = "store",
               version: int = STORE_VERSION) -> Dict:
    """Load a persistent JSON store, surviving every corruption mode.

    Accepts both the checksummed envelope (``{"__meta__": {...},
    "data": {...}}``) and the legacy flat-dict format (pre-envelope
    files carry no checksum to verify).  Truncated / garbage JSON, a
    non-dict document, or a checksum mismatch quarantines the file to
    ``<path>.corrupt`` (with a warning naming it) and returns an empty
    store.  A version-skewed envelope is ignored -- fresh store, no
    quarantine: the file is healthy, just written by a different
    revision.  Missing file -> empty store, silently.
    """
    inject("store-load", path)
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return {}
    try:
        doc = json.loads(text)
    except ValueError:
        quarantine_file(path, label=label, reason="invalid JSON")
        return {}
    if not isinstance(doc, dict):
        quarantine_file(path, label=label,
                        reason=f"a {type(doc).__name__}, not an object")
        return {}
    meta = doc.get("__meta__")
    if meta is None:
        return doc  # legacy flat format: no checksum to verify
    data = doc.get("data")
    if not isinstance(meta, dict) or not isinstance(data, dict):
        quarantine_file(path, label=label, reason="malformed envelope")
        return {}
    if int(meta.get("version", -1)) != int(version):
        record("store", "store-version-skew", path, "skipped",
               f"{label}: on-disk v{meta.get('version')} != "
               f"expected v{version}")
        return {}
    want = meta.get("checksum")
    if want is not None and want != _payload_checksum(data):
        quarantine_file(path, label=label, reason="checksum mismatch")
        return {}
    return data


def save_store(path: str, data: Dict, *, prefix: str = ".tmp.",
               version: int = STORE_VERSION, indent: int = 0) -> None:
    """Atomically persist ``data`` in the checksummed envelope."""
    doc = {"__meta__": {"version": int(version),
                        "checksum": _payload_checksum(data)},
           "data": data}
    atomic_write_json(path, doc, prefix=prefix, indent=indent)


def locked_update(path: str, mutate: Callable[[Dict], None], *,
                  label: str = "store", prefix: str = ".tmp.",
                  version: int = STORE_VERSION, indent: int = 0) -> Dict:
    """Read-modify-write one store under its file lock.

    Re-reads the on-disk state inside the lock (so two processes
    updating different keys both land, instead of the last writer
    clobbering the first), applies ``mutate(data)`` in place, writes
    atomically, and returns the merged payload.
    """
    with _FileLock(path):
        data = load_store(path, label=label, version=version)
        mutate(data)
        save_store(path, data, prefix=prefix, version=version,
                   indent=indent)
    return data


# --------------------------------------------------------------------------
# Plan certification: measured winners vs the port's eager oracle
# --------------------------------------------------------------------------


# dtype-aware comparison tolerances: fp32 matches the repo-wide 2e-3
# test tolerance; half precisions accumulate ~10x looser; integer and
# boolean outputs must be exact (a fold over int data has one answer).
_TOLERANCES = {
    "float32": (2e-3, 2e-3), "float64": (1e-6, 1e-6),
    "bfloat16": (2e-2, 2e-2), "float16": (2e-2, 2e-2),
}


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``; numpy dtypes and names pass."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def tolerances(dtype) -> Tuple[float, float]:
    """(rtol, atol) for certifying outputs of the given dtype (a torch
    or numpy dtype, or its name); (0, 0) -- exact -- for integer/bool
    dtypes."""
    name = _dtype_name(dtype)
    if name in _TOLERANCES:
        return _TOLERANCES[name]
    import numpy as np
    try:
        if np.issubdtype(np.dtype(name), np.floating):
            return (2e-3, 2e-3)
    except TypeError:
        pass
    return (0.0, 0.0)


def _outputs_match(got, want) -> Tuple[bool, str]:
    """``got`` against ``want`` (tensors on one device, or arrays) at
    ``tolerances`` of ``want``'s type."""
    import torch

    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device)
    if tuple(got.shape) != tuple(want.shape):
        return False, f"shape {tuple(got.shape)} != {tuple(want.shape)}"
    rtol, atol = tolerances(want.dtype)
    g, w = got.double(), want.double()
    if bool(torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)):
        return True, "ok"
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return False, (f"max_abs_err={err:.3e} beyond rtol={rtol} "
                   f"atol={atol} for dtype {_dtype_name(want.dtype)}")


def _first(v):
    return v[0] if isinstance(v, tuple) else v


def certify_tile_plan(p, sizes: Dict[str, Tuple[int, ...]], *,
                      vmem_budget: Optional[int] = None,
                      seed: int = 0, device=None,
                      depth: int = 2) -> Tuple[bool, str]:
    """Numerically validate one tile-size candidate of pattern ``p``
    against the ``codegen_torch`` oracle of the *untiled* program, on
    ``device`` (the card unless the caller names another); the oracle
    takes a root fold's domain at once (``batched_folds``).

    The candidate lowers exactly as the timing path does
    (``codegen_cuda.lower_for_timing``); an ``"oracle"`` lowering (CPU
    only) is certified by construction.  Returns ``(ok, reason)``;
    exceptions during certification count as failure (a kernel that
    cannot run its validation input must not be promoted).
    """
    from . import ir
    from .codegen_cuda import lower_for_timing
    from .codegen_torch import execute
    from .measure import synth_inputs
    from ..device import resolve

    dev = resolve(device)
    with telemetry.span("resilience.certify", kind="tile",
                        key=p.name) as sp:
        inject("certify", type(p).__name__)
        fn, how = lower_for_timing(p, sizes, vmem_budget=vmem_budget,
                                   seed=seed, device=dev, depth=depth)
        if how == "oracle":
            sp.set(ok=True, how="oracle")
            return True, "oracle lowering is the reference"
        inputs = synth_inputs(ir.inputs_of(p), seed=seed, device=dev)
        got = _first(fn())
        want = _first(execute(p, inputs, device=dev, batched_folds=True))
        ok, why = _outputs_match(got, want)
        sp.set(ok=ok, how=how)
        return ok, f"{how}-vs-oracle: {why}"


def certify_pipeline_plan(pipe, plan, *,
                          vmem_budget: Optional[int] = None,
                          seed: int = 0, device=None) -> Tuple[bool, str]:
    """Validate one fused-pipeline plan candidate against the unfused
    per-stage oracle (``pipeline.run_unfused``, folds batched) on
    ``device``, output by output with dtype-aware tolerances."""
    from . import pipeline as plmod
    from .codegen_cuda import lower_pipeline_for_timing
    from .measure import synth_inputs
    from ..device import resolve

    dev = resolve(device)
    with telemetry.span("resilience.certify", kind="pipeline",
                        key=pipe.name) as sp:
        inject("certify", pipe.name)
        inputs = synth_inputs(plmod.external_inputs(pipe), seed=seed,
                              device=dev)
        got = lower_pipeline_for_timing(pipe, plan,
                                        vmem_budget=vmem_budget,
                                        seed=seed, device=dev)()
        want = plmod.run_unfused(pipe, dict(inputs), device=dev,
                                 batched_folds=True)
        outs = plmod.output_names(pipe)
        if not isinstance(want, dict):
            want = {outs[0]: want}
        if not isinstance(got, dict):
            got = {outs[0]: got}
        for name, ref in want.items():
            if name not in got:
                sp.set(ok=False)
                return False, f"output {name!r} missing from fused result"
            ok, why = _outputs_match(got[name], ref)
            if not ok:
                sp.set(ok=False)
                return False, f"output {name!r}: {why}"
        sp.set(ok=True)
        return True, "fused-vs-unfused: ok"


def certify_guarded(certify_fn: Callable[[], Tuple[bool, str]], *,
                    key: str, policy: Optional[Policy] = None
                    ) -> Tuple[bool, str]:
    """Run a certification under the policy deadline; any expected
    failure (including a certification hang) reads as *not certified*
    -- an unverifiable winner is treated exactly like a wrong one.  A
    sticky CUDA error propagates."""
    try:
        return call_guarded(certify_fn, stage="certify", key=key,
                            policy=policy)
    except CandidateFailure as e:
        return False, f"certification failed ({e.kind}): {e.detail}"
