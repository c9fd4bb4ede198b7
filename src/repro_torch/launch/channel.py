"""Import-light file channel shared by coordinator and workers.

The multi-process launch path talks over one directory per worker:
atomic JSON heartbeats, leases, stratum tasks and work acks.  This
module holds the channel LAYOUT and the atomic read/write primitives,
and imports the standard library only: no torch, no numpy, nothing else
of ``repro_torch``.  A worker process imports this module and nothing
more until its mode asks for torch (``launch/_worker.py``), so a
protocol-only worker starts in a fraction of a second and a worker that
joins a process group imports torch only when it needs it;
``runtime/health.py`` re-exports these helpers for the coordinator side.

Writes follow the same tmp + fsync + replace + dir-fsync discipline as
checkpoint manifests (``runtime/checkpoint.atomic_write_json``): a
reader never sees a torn heartbeat.  Timestamps are
``time.monotonic()``: comparable across processes on one host
(CLOCK_MONOTONIC is system-wide), which is all the single-box
multi-process regime needs.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional, Tuple


# ---------------------------------------------------------------------------
# Channel layout (one directory per worker under the channel root).
# ---------------------------------------------------------------------------

def worker_dir(root: str, worker_id: int) -> str:
    return os.path.join(root, f"worker{worker_id}")


def heartbeat_path(root: str, worker_id: int) -> str:
    return os.path.join(worker_dir(root, worker_id), "heartbeat.json")


def lease_path(root: str, worker_id: int) -> str:
    return os.path.join(worker_dir(root, worker_id), "lease.json")


def stratum_path(root: str) -> str:
    return os.path.join(root, "stratum.json")


def ack_path(root: str, worker_id: int, stratum: int) -> str:
    return os.path.join(worker_dir(root, worker_id), f"ack{stratum}.json")


# ---------------------------------------------------------------------------
# Atomic channel I/O.
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json(path: str, payload: dict) -> None:
    """Atomic channel write: a heartbeat/ack is never readable torn."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_json(path: str) -> Optional[dict]:
    """One channel read attempt; ``None`` when not written yet."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Worker-side lease renewal (called from the worker loop).
# ---------------------------------------------------------------------------

def write_heartbeat(root: str, worker_id: int, seq: int,
                    shards: Tuple[int, ...] = (),
                    clock: Callable[[], float] = time.monotonic,
                    **extra) -> None:
    write_json(heartbeat_path(root, worker_id), {
        "worker_id": worker_id, "seq": seq, "t": clock(),
        "pid": os.getpid(), "shards": list(shards), **extra})
