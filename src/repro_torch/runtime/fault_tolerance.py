"""Fault tolerance: failure detection, elastic rescale, stragglers (the
reference's ``runtime/fault_tolerance.py``, pure Python, a copy the port
owns; its events go to the port's ``core.telemetry``).

On a real multi-node deployment these hooks sit on the coordinator
(torch.distributed + the cluster scheduler).  The *policies* are what we
implement and test here, against a simulated cluster -- the decisions
(when to declare a node dead, how to rebuild the mesh, when a straggler
triggers action) are hardware-independent.

Recovery path (``tests/test_torch_train.py`` exercises each step):
  1. heartbeat monitor declares node dead after ``timeout_s``;
  2. ``plan_rescale`` builds the largest usable (data, model) mesh from
     survivors (model-parallel degree preserved if possible -- param
     shards must still fit);
  3. training state restores from the last checkpoint via
     ``checkpoint.restore`` and the data pipeline
     rewinds to the checkpoint step (deterministic stream => no drift);
  4. straggler policy: per-step durations feed an EWMA; a rank slower
     than ``threshold x`` median for ``patience`` steps is flagged for
     eviction (treated as a failure) -- at 1000+ nodes, evict-and-
     rescale beats waiting on a sick host.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence

from ..core import telemetry


@dataclasses.dataclass
class NodeState:
    last_heartbeat: float
    step_ewma: float = 0.0
    slow_count: int = 0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, nodes: Sequence[str], timeout_s: float = 60.0):
        now = time.monotonic()
        self.timeout_s = timeout_s
        self.nodes: Dict[str, NodeState] = {
            n: NodeState(last_heartbeat=now) for n in nodes}

    def heartbeat(self, node: str, now: Optional[float] = None) -> None:
        self.nodes[node].last_heartbeat = (
            time.monotonic() if now is None else now)

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Returns newly-dead nodes."""
        now = time.monotonic() if now is None else now
        dead = []
        for name, st in self.nodes.items():
            if st.alive and now - st.last_heartbeat > self.timeout_s:
                st.alive = False
                dead.append(name)
        return dead

    def alive(self) -> List[str]:
        return [n for n, s in self.nodes.items() if s.alive]


@dataclasses.dataclass
class RescalePlan:
    data: int
    model: int
    dropped: int        # healthy devices left idle by shape constraints

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_rescale(n_devices: int, model_parallel: int = 16,
                 min_model: int = 1) -> RescalePlan:
    """Largest (data x model) grid from ``n_devices`` survivors.

    Preserves the model-parallel degree when possible (param shards keep
    fitting); halves it only when the survivor count cannot fill even
    one model group."""
    mp = model_parallel
    while mp > min_model and n_devices < mp:
        mp //= 2
    data = n_devices // mp
    return RescalePlan(data=data, model=mp,
                       dropped=n_devices - data * mp)


class StragglerPolicy:
    """EWMA step-time tracking; flags ranks persistently slower than
    ``threshold`` x the median."""

    def __init__(self, threshold: float = 1.5, patience: int = 3,
                 alpha: float = 0.3):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.slow: Dict[str, int] = {}

    def record_step(self, durations: Dict[str, float]) -> List[str]:
        """Feed one step's per-rank durations; returns ranks to evict.
        Evictions are emitted on the unified telemetry event stream."""
        for rank, d in durations.items():
            prev = self.ewma.get(rank, d)
            self.ewma[rank] = (1 - self.alpha) * prev + self.alpha * d
        med = sorted(self.ewma.values())[len(self.ewma) // 2]
        evict = []
        for rank, v in self.ewma.items():
            if v > self.threshold * med:
                self.slow[rank] = self.slow.get(rank, 0) + 1
                if self.slow[rank] >= self.patience:
                    evict.append(rank)
            else:
                self.slow[rank] = 0
        for rank in evict:
            telemetry.emit("recovery", "straggler-evict", rank=rank,
                           ewma_s=self.ewma[rank], median_s=med)
        return evict


class RecoveryLog:
    """Audit trail of fault events (what a coordinator would emit).

    A facade over the single structured event stream in
    ``core.telemetry`` (stream ``"recovery"``): ``record`` emits there
    and ``events`` reads back, so recovery events, resilience
    degradation events and tracing spans all land in one export.  The
    ``record(kind, **info)`` / ``events`` surface is unchanged.
    """

    _ids = itertools.count()

    def __init__(self):
        self._id = next(RecoveryLog._ids)

    def record(self, kind: str, **info):
        telemetry.emit("recovery", kind, log_id=self._id, **info)

    @property
    def events(self) -> List[Dict]:
        return [{k: v for k, v in e.items()
                 if k not in ("stream", "ts", "log_id")}
                for e in telemetry.events("recovery", log_id=self._id)]
