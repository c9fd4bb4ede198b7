"""Span-based tracer: host spans, and one span per fixpoint stratum.

Two recording surfaces share one event buffer:

  * **Host spans**: ``with tracer.span("replicate", stratum=k):`` around
    driver-side code (the resilient driver's replica writes, recovery).
    Durations are ``perf_counter`` intervals.
  * **Stratum spans**: the engine calls :meth:`Tracer.stratum_begin` when a
    stratum starts and :meth:`Tracer.stratum_probe` with its outcome when
    it ends; the span is closed by :meth:`Tracer.resolve`, which the
    fixpoint loop (and the resilient driver) call right after their host
    read of the stratum's live count.  The span runs from the previous
    boundary (the last stratum's close, or :meth:`mark_shards`) to that
    read, and carries the outcome (emitted, tier, route, rehash_bytes,
    used_dense, live_after).  On CUDA tensors it also carries
    ``device_s``: the time between two ``torch.cuda.Event``s recorded on
    the stream at the stratum's start and end, read only after the host
    read, so tracing adds no synchronisation.  ``tracer=None`` (the
    engine's default) records nothing and leaves every stratum as it is.

Timestamps are ``perf_counter`` seconds relative to the tracer's epoch;
``obs/export.py`` converts to the Chrome-trace µs timeline.  All shards
share one device, so stratum spans go on the ``"shards"`` row (shard -1),
and per-shard latencies fall back to the stratum's wall.

:class:`MeasuredLatencies` is the per-shard timing feed the resilient
driver hands to ``SpeculationPolicy`` when no synthetic ``latency_model``
is given, and ``obs/calibrate.py`` turns route timings into the
``route_strategy="measured"`` table.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry


class Tracer:
    """Append-only event recorder (host spans + stratum spans).

    Events are dicts with ``name``, ``ph`` ("X" span / "i" instant),
    ``ts`` (start, seconds since epoch), ``dur`` (spans), ``tid`` (host
    thread or ``shards``), and free-form ``args``.  Thread-safe.
    """

    def __init__(self, name: str = "rex",
                 metrics: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter):
        self.name = name
        self.metrics = metrics
        self._clock = clock
        self.epoch = clock()
        self._events: List[dict] = []
        self._lock = threading.RLock()
        # Last stratum boundary per tid, the start of the next span.
        self._last_ts: Dict[str, float] = {}
        # (stratum, shard) -> (start, dur) of the most recent span.
        self._stratum_times: Dict[tuple, tuple] = {}
        # Start event of the stratum in flight (CUDA), and strata probed
        # but not yet closed: (stratum, shard, outcome, start, end events).
        self._open: Optional[torch.cuda.Event] = None
        self._pending: list = []

    @property
    def events(self) -> List[dict]:
        """Every recorded event, pending strata closed first."""
        self.resolve()
        return self._events

    # ------------------------------------------------------------------
    # Host-side recording.
    # ------------------------------------------------------------------
    def _now(self) -> float:
        return self._clock() - self.epoch

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, tid: str = "host", **attrs):
        """Record a complete (ph "X") event around a host-side block.
        Yields the args dict: mutate it to attach results measured
        inside the span."""
        t0 = self._now()
        args = dict(attrs)
        try:
            yield args
        finally:
            self._append({"name": name, "ph": "X", "ts": t0,
                          "dur": self._now() - t0, "tid": tid,
                          "args": args})

    def instant(self, name: str, tid: str = "host", **attrs) -> None:
        """Record a point event (recovery, rescale, speculation verdict)."""
        self._append({"name": name, "ph": "i", "ts": self._now(),
                      "tid": tid, "args": dict(attrs)})

    def mark(self, tid: str = "host") -> None:
        """Reset the duration anchor for ``tid``."""
        with self._lock:
            self._last_ts[tid] = self._now()

    def mark_shards(self, num_shards: int) -> None:
        """Anchor every shard timeline (and the aggregate "shards" row)
        at now: the stratum-dispatch boundary, so the next span measures
        the stratum only, not host time before it."""
        now = self._now()
        with self._lock:
            self._last_ts["shards"] = now
            for s in range(num_shards):
                self._last_ts[f"shard{s}"] = now

    # ------------------------------------------------------------------
    # Stratum spans.
    # ------------------------------------------------------------------
    def stratum_begin(self, device: Optional[torch.device] = None) -> None:
        """A stratum starts: on a CUDA ``device`` record its start event on
        the current stream."""
        self._open = None
        if device is not None and device.type == "cuda":
            self._open = torch.cuda.Event(enable_timing=True)
            self._open.record()

    def stratum_probe(self, stratum_idx, outcome, shard_id=None) -> None:
        """The stratum ``stratum_idx`` ended with ``outcome`` (its values
        may still be on the device): record its end event and keep it
        until :meth:`resolve`."""
        end = None
        if self._open is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        with self._lock:
            self._pending.append((int(stratum_idx),
                                  -1 if shard_id is None else int(shard_id),
                                  outcome, self._open, end))
        self._open = None

    def resolve(self) -> None:
        """Close every probed stratum at now.  Call after the host read of
        its live count: the outcome's values and the events are ready
        then, so nothing here waits for the device."""
        with self._lock:
            pending, self._pending = self._pending, []
        for stratum, shard, outcome, start, end in pending:
            device_s = (start.elapsed_time(end) / 1e3
                        if start is not None else None)
            vals = [v.item() if torch.is_tensor(v) else v for v in
                    (outcome.emitted, outcome.tier, outcome.route,
                     outcome.rehash_bytes, outcome.used_dense,
                     outcome.live_count)]
            self._on_stratum(stratum, *vals, shard, device_s)

    def _on_stratum(self, stratum, emitted, tier, route, rehash_bytes,
                    used_dense, live, shard, device_s=None) -> None:
        now = self._now()
        tid = "shards" if shard < 0 else f"shard{shard}"
        with self._lock:
            start = self._last_ts.get(tid, 0.0)
            self._last_ts[tid] = now
        dur = max(now - start, 0.0)
        self._stratum_times[(stratum, shard)] = (start, dur)
        args = {"stratum": stratum, "emitted": int(emitted),
                "tier": int(tier), "route": int(route),
                "rehash_bytes": float(rehash_bytes),
                "used_dense": bool(used_dense), "live_after": int(live)}
        if device_s is not None:
            args["device_s"] = device_s
        self._append({"name": f"stratum{stratum}", "ph": "X", "ts": start,
                      "dur": dur, "tid": tid, "args": args})
        if self.metrics is not None:
            m = self.metrics
            m.counter("engine.strata").inc()
            m.counter("engine.deltas_emitted").inc(int(emitted))
            m.counter("engine.rehash_bytes").inc(float(rehash_bytes))
            if bool(used_dense):
                m.counter("engine.dense_fallbacks").inc()
            m.histogram("engine.stratum_seconds").observe(dur)
            if device_s is not None:
                m.histogram("engine.stratum_device_seconds").observe(
                    device_s)
            m.gauge("engine.live_deltas").set(int(live))

    def fixpoint_probe(self, iterations, max_iters: int) -> None:
        """Fixpoint-complete marker (once per ``run``)."""
        self.resolve()
        self.instant("fixpoint_done", iterations=int(iterations),
                     max_iters=int(max_iters))
        if self.metrics is not None:
            self.metrics.counter("engine.fixpoints").inc()
            self.metrics.gauge("engine.last_fixpoint_strata").set(
                int(iterations))

    # ------------------------------------------------------------------
    # Measured-timing queries.
    # ------------------------------------------------------------------
    def stratum_seconds(self, stratum: int, shard: int = -1
                        ) -> Optional[float]:
        """Measured wall time of a recorded stratum (None if that
        (stratum, shard) never ran under this tracer)."""
        self.resolve()
        hit = self._stratum_times.get((int(stratum), int(shard)))
        return None if hit is None else hit[1]

    def per_shard_latencies(self, stratum: int, num_shards: int,
                            default: Optional[float] = None
                            ) -> Optional[List[float]]:
        """Per-shard measured latencies for one stratum: the feed for
        ``SpeculationPolicy``.  Shards share one device here, so only the
        aggregate span exists and every shard gets its wall (``default``,
        the driver's host-side stratum wall, when the stratum was not
        traced).  None when nothing was measured and no default given."""
        out = []
        for s in range(num_shards):
            t = self.stratum_seconds(stratum, s)
            if t is None:
                t = self.stratum_seconds(stratum, -1)
            if t is None:
                t = default
            if t is None:
                return None
            out.append(float(t))
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._last_ts.clear()
            self._stratum_times.clear()
            self._pending.clear()


class MeasuredLatencies:
    """Recorded per-shard stratum timings, callable like a synthetic
    ``latency_model(stratum) -> [seconds per shard]``.

    The driver appends one list per executed stratum (tracer spans when
    available, host stratum wall otherwise)."""

    def __init__(self):
        self.latencies: List[List[float]] = []

    def observe(self, per_shard: List[float]) -> None:
        self.latencies.append([float(x) for x in per_shard])

    def __len__(self) -> int:
        return len(self.latencies)

    def __call__(self, stratum: int) -> List[float]:
        if not self.latencies:
            raise ValueError("no measured latencies recorded yet")
        # Strata are appended in execution order; a restart re-executes
        # early strata, so index from the END (most recent measurement).
        idx = min(int(stratum), len(self.latencies) - 1)
        return list(self.latencies[idx])
