"""Heartbeat/lease failure detection for the multi-process launch path.

The simulated chaos layer (``runtime/chaos.py``) injects failures by
fiat; a REAL worker process dies without telling anyone.  This module is
the coordinator-side machinery that turns real process behavior into the
exact event vocabulary the recovery stack already speaks:

  * Workers **lease** their shards from the coordinator and renew the
    lease by heartbeating over a lightweight file channel (one atomic
    JSON per worker, written with the same tmp+rename discipline as
    checkpoint manifests — a reader never sees a torn heartbeat).
  * :class:`HealthMonitor` polls the channel at every punctuation
    barrier.  A worker whose lease deadline passes — or whose process is
    observably gone, the fast local path — is declared dead, and every
    shard it leased becomes a ``FaultEvent(kind="fail")``: the SAME
    event an injected :class:`~repro_torch.runtime.recovery.FaultSchedule`
    failure produces, so the resilient driver's queue-driven recovery
    handles real process loss verbatim.
  * A worker that is late but inside its lease (a real SIGSTOP, GC
    pause, or network wobble) is a **straggle signal**: the monitor
    reports the shard + measured age so the driver feeds it to the
    ``SpeculationPolicy`` exactly as a slow stratum would.

All channel I/O goes through the existing ``runtime/retry.py``
``RetryPolicy`` machinery (a heartbeat read can race its writer's
rename on some filesystems), and every state transition is mirrored to
the tracer (per-worker timeline rows: ``lease_expired`` /
``heartbeat_late`` instants) and the metrics registry (``health.*``).

Timestamps are ``time.monotonic()``: on one host it is comparable
across processes (CLOCK_MONOTONIC is system-wide), which is all the
single-box multi-process regime needs; a true multi-NIC deployment
would swap in coordinator-stamped receive times — the monitor only ever
compares against its own clock reads.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

# The channel layout + atomic I/O live in the import-light
# ``launch/channel.py`` (a worker imports the stdlib and that module
# only); re-exported here for the coordinator-side API.
from repro_torch.launch.channel import (ack_path,  # noqa: F401
                                        heartbeat_path, lease_path,
                                        read_json, stratum_path,
                                        worker_dir, write_heartbeat,
                                        write_json)
from repro_torch.runtime.recovery import FaultEvent
from repro_torch.runtime.retry import IO_RETRYABLE, Retrier


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Lease/heartbeat tuning knobs (seconds).

    ``lease_ttl`` is the missed-lease deadline: a worker silent longer
    than this has lost every shard it leased.  ``straggle_after`` is the
    late-but-alive threshold feeding speculation.  Keep
    ``heartbeat_interval << straggle_after < lease_ttl`` — the defaults
    give a worker ~15 missed beats before it is declared dead.
    """

    lease_ttl: float = 1.5
    straggle_after: float = 0.4
    heartbeat_interval: float = 0.1
    ack_timeout: float = 1.0      # per-stratum work-ack deadline
    ready_timeout: float = 60.0   # worker bring-up deadline
    poll_interval: float = 0.005  # coordinator file-poll cadence

    def __post_init__(self):
        if not (0 < self.heartbeat_interval < self.straggle_after
                < self.lease_ttl):
            raise ValueError(
                "HealthConfig needs 0 < heartbeat_interval < "
                f"straggle_after < lease_ttl, got "
                f"{self.heartbeat_interval}/{self.straggle_after}/"
                f"{self.lease_ttl}")


# ---------------------------------------------------------------------------
# Coordinator-side monitor.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerStatus:
    worker_id: int
    shards: Tuple[int, ...]
    state: str                 # "ok" | "late" | "dead"
    age: float                 # seconds since last renewal (inf: never)
    seq: int = -1
    pid: Optional[int] = None


@dataclasses.dataclass
class HealthReport:
    """One barrier's health observation.

    ``fail_events`` carry one :class:`FaultEvent` per shard whose lease
    just died — ready to hand to the resilient driver's recovery queue.
    ``straggles`` are ``(shard, age_seconds)`` late-but-alive signals.
    """

    statuses: List[WorkerStatus]
    fail_events: List[FaultEvent]
    dead_workers: List[int]
    straggles: List[Tuple[int, float]]

    @property
    def alive(self) -> int:
        return sum(1 for s in self.statuses if s.state != "dead")


class HealthMonitor:
    """Coordinator-side lease table over the heartbeat channel.

    ``ownership`` maps worker id → the shards it leases; a worker's
    missed deadline emits a fail event per leased shard, stamped with
    the stratum the caller passes to :meth:`observe` (so the event is
    indistinguishable from an injected one at the same barrier).  A
    worker is reported dead exactly once; :meth:`reinstate` re-arms it
    after a replacement process takes over its lease.

    ``proc_alive(worker_id) -> bool | None`` is the optional fast local
    path (``Popen.poll``): an observably-dead process fails its lease
    immediately instead of waiting out the TTL — the file channel alone
    remains sufficient (and is all a multi-box deployment would have).
    """

    def __init__(self, root: str, ownership: Dict[int, List[int]],
                 config: Optional[HealthConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 retrier: Optional[Retrier] = None,
                 proc_alive: Optional[Callable[[int], Optional[bool]]]
                 = None,
                 tracer=None, metrics=None):
        self.root = root
        self.ownership = {int(w): list(s) for w, s in ownership.items()}
        self.config = config or HealthConfig()
        self.clock = clock
        self.retrier = retrier or Retrier()
        self.proc_alive = proc_alive
        self.tracer = tracer
        self.metrics = metrics
        self._dead: set = set()
        # Leases granted at construction: write the grant per worker so
        # the channel itself documents who leases what (observability +
        # the worker echoes it back in heartbeats).
        for w, shards in self.ownership.items():
            self._grant(w, shards)

    # ---- lease table ----------------------------------------------------
    def _grant(self, worker_id: int, shards: List[int]) -> None:
        write_json(lease_path(self.root, worker_id), {
            "worker_id": worker_id, "shards": list(shards),
            "ttl_s": self.config.lease_ttl, "granted_t": self.clock()})

    def set_ownership(self, ownership: Dict[int, List[int]]) -> None:
        """Re-grant every lease (elastic rescale / worker replacement)."""
        self.ownership = {int(w): list(s) for w, s in ownership.items()}
        for w, shards in self.ownership.items():
            self._grant(w, shards)

    def reinstate(self, worker_id: int) -> None:
        """A replacement process holds the lease again: future missed
        deadlines are reportable anew."""
        self._dead.discard(worker_id)
        self._grant(worker_id, self.ownership.get(worker_id, []))

    # ---- observation ----------------------------------------------------
    def _read_heartbeat(self, worker_id: int) -> Optional[dict]:
        return self.retrier.call(
            read_json, heartbeat_path(self.root, worker_id),
            op=f"heartbeat:{worker_id}", retryable=IO_RETRYABLE)

    def observe(self, stratum: int = 0) -> HealthReport:
        """Classify every leased worker at this barrier."""
        now = self.clock()
        statuses, fail_events, dead_workers, straggles = [], [], [], []
        for w in sorted(self.ownership):
            shards = tuple(self.ownership[w])
            if w in self._dead:
                statuses.append(WorkerStatus(w, shards, "dead",
                                             float("inf")))
                continue
            hb = self._read_heartbeat(w)
            age = (now - hb["t"]) if hb else float("inf")
            proc_dead = (self.proc_alive is not None
                         and self.proc_alive(w) is False)
            if proc_dead or age > self.config.lease_ttl:
                state = "dead"
                self._dead.add(w)
                dead_workers.append(w)
                for s in shards:
                    fail_events.append(FaultEvent(kind="fail",
                                                  at=max(stratum, 0),
                                                  shard=s))
                if self.tracer is not None:
                    self.tracer.instant(
                        "lease_expired", tid=f"worker{w}",
                        worker=w, stratum=stratum, age_s=age,
                        proc_dead=proc_dead, shards=list(shards))
                if self.metrics is not None:
                    self.metrics.counter("health.lease_expiries").inc()
            elif age > self.config.straggle_after:
                state = "late"
                straggles.extend((s, age) for s in shards)
                if self.tracer is not None:
                    self.tracer.instant("heartbeat_late",
                                        tid=f"worker{w}", worker=w,
                                        stratum=stratum, age_s=age)
                if self.metrics is not None:
                    self.metrics.counter("health.straggle_signals").inc()
            else:
                state = "ok"
            if self.metrics is not None and hb:
                self.metrics.counter("health.heartbeats_seen").inc()
                self.metrics.gauge(
                    f"health.heartbeat_age_s.worker{w}").set(
                        age if age != float("inf") else -1.0)
            statuses.append(WorkerStatus(
                w, shards, state, age,
                seq=hb.get("seq", -1) if hb else -1,
                pid=hb.get("pid") if hb else None))
        report = HealthReport(statuses=statuses, fail_events=fail_events,
                              dead_workers=dead_workers,
                              straggles=straggles)
        if self.metrics is not None:
            self.metrics.gauge("health.workers_alive").set(report.alive)
        return report

    # ---- bring-up -------------------------------------------------------
    def wait_ready(self, worker_ids: Optional[List[int]] = None,
                   timeout: Optional[float] = None,
                   sleep: Callable[[float], None] = time.sleep) -> None:
        """Block until every worker has heartbeat at least once (lease
        taken up).  Raises TimeoutError naming the silent workers."""
        ids = sorted(self.ownership) if worker_ids is None \
            else list(worker_ids)
        deadline = self.clock() + (timeout if timeout is not None
                                   else self.config.ready_timeout)
        pending = set(ids)
        while pending:
            for w in sorted(pending):
                if self._read_heartbeat(w) is not None:
                    pending.discard(w)
            if not pending:
                return
            if self.clock() > deadline:
                raise TimeoutError(
                    f"workers {sorted(pending)} never heartbeat within "
                    f"{timeout if timeout is not None else self.config.ready_timeout}s "
                    f"(channel root {self.root})")
            sleep(self.config.poll_interval)
