"""Exporters: Chrome-trace/Perfetto JSON timelines + flat metrics dumps.

``to_chrome_trace`` converts a :class:`~repro_torch.obs.trace.Tracer`'s event
buffer into the Trace Event Format JSON that both ``chrome://tracing``
and https://ui.perfetto.dev load directly: one process, one timeline row
per recorded ``tid`` (host, per-shard rows, views), complete ("X") events
for spans/strata, instant ("i") events for recoveries and verdicts, and
``thread_name`` metadata rows so the UI labels tracks.  Events are ordered
by start time.

``metrics_to_json`` flattens a registry snapshot into one JSON object,
written next to the trace.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

_US = 1e6  # trace-event timestamps are microseconds


def to_chrome_trace(tracer: Tracer, pid: int = 1) -> dict:
    """Trace Event Format dict (Perfetto/chrome://tracing loadable)."""
    tids: dict[str, int] = {}
    events = []

    def tid_of(name: str) -> int:
        if name not in tids:
            # Stable, readable ordering: host first, then shards in
            # registration order.
            tids[name] = len(tids) + 1
        return tids[name]

    tracer.resolve()
    with tracer._lock:
        recorded = list(tracer._events)
    # Stable ordering for the viewer: by start time.
    recorded.sort(key=lambda e: (e.get("ts", 0.0), e.get("tid", "")))
    for ev in recorded:
        out = {
            "name": ev["name"],
            "ph": ev["ph"],
            "ts": round(ev["ts"] * _US, 3),
            "pid": pid,
            "tid": tid_of(ev.get("tid", "host")),
            "args": ev.get("args", {}),
        }
        if ev["ph"] == "X":
            out["dur"] = round(ev.get("dur", 0.0) * _US, 3)
        elif ev["ph"] == "i":
            out["s"] = "t"          # thread-scoped instant marker
        events.append(out)

    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"rex:{tracer.name}"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
              "args": {"name": name}} for name, t in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"tracer": tracer.name,
                          "events": len(events)}}


def write_chrome_trace(tracer: Tracer, path: str, pid: int = 1) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, pid=pid), f, indent=1)
        f.write("\n")
    return path


def metrics_to_json(registry: MetricsRegistry,
                    extra: Optional[dict] = None) -> dict:
    """Flat metrics dump: {"metrics": snapshot, **extra}."""
    out = {"metrics": registry.snapshot()}
    if extra:
        out.update(extra)
    return out


def write_metrics(registry: MetricsRegistry, path: str,
                  extra: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(metrics_to_json(registry, extra), f, indent=1,
                  sort_keys=True)
        f.write("\n")
    return path
