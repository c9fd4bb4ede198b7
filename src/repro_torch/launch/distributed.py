"""Multi-process launch + distributed resilient driver (real failures).

The chaos layer (``runtime/chaos.py``) injects failures by fiat, and
recovery in one process is validated against simulated fault events.
Real process loss, real timeouts and real latency variance must drive
the machinery too.  This module supplies that, in three layers:

**Launch.**  :class:`Cluster` brings up N worker processes on one host
(``python -m repro_torch.launch._worker``, spawned with
``subprocess.Popen``: a fresh interpreter, never a fork of a process that
holds a CUDA context), each optionally running torch:

  * ``torch_mode="off"``: the health/lease/ack protocol only (fast
    spawn: the worker imports the standard library alone);
  * ``torch_mode="local"``: each worker initialises its own device
    (``device``, CUDA by default) and every stratum ack carries a real
    computation on it;
  * ``torch_mode="distributed"``: workers join one ``torch.distributed``
    process group (``launch/mesh.py`` ``init_shard_group`` over a TCP
    store that rank 0 hosts), build the flat mesh, all-gather their
    process ids and report the shards each rank owns.  The
    ``--selftest`` CLI drives exactly this bring-up.  Long-lived workers
    keep no group: a collective has no elastic membership, so killing
    one member poisons the whole communicator, which is why the chaos
    path keeps the data plane on the coordinator and gives workers
    isolated runtimes (and why :class:`DistributedResilientDriver`
    refuses an executor of ``backend="shard_map"``).

**Failure detection.**  Workers lease their shards and renew by
heartbeating over the ``runtime/health.py`` file channel; the
coordinator's :class:`~repro_torch.runtime.health.HealthMonitor` turns a
missed lease deadline into ``FaultEvent(kind="fail")`` and a
late-but-alive worker into a straggle signal.

**Recovery.**  :class:`DistributedResilientDriver` subclasses
:class:`~repro_torch.runtime.recovery.ResilientDriver` and reuses its
queue-driven re-entrant recovery verbatim: a real SIGKILL lands in
``_recovery_queue`` as the same event an injected failure produces,
worker replacement re-runs ``ReplicaChain.reseed()``, and a worker that
never comes back triggers the elastic rescale path.  Real per-stratum ack
arrival times feed ``MeasuredLatencies`` (and so the
``SpeculationPolicy``) in place of the coordinator's own walls.

Multi-host entry point::

    REPRO_COORDINATOR=host0:1234 REPRO_NUM_PROCESSES=4 \\
        REPRO_PROCESS_ID=k python your_driver.py
    # then: mesh, my_shards = initialize_from_env(num_shards)

Bring-up selftest (NCCL, one rank a GPU; on the CPU name gloo and the
CPU)::

    python -m repro_torch.launch.distributed --selftest --workers 1
    python -m repro_torch.launch.distributed --selftest --workers 2 \\
        --backend gloo --device cpu
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.runtime.health import (HealthConfig, HealthMonitor, ack_path,
                                        heartbeat_path, read_json,
                                        stratum_path, worker_dir, write_json)
from repro_torch.runtime.recovery import (FaultEvent, FaultSchedule,
                                          ResilientDriver, pack_state,
                                          unpack_state)
from repro_torch.runtime.retry import IO_RETRYABLE, Retrier
from repro_torch.runtime.straggler import StragglerMitigator

_TORCH_MODES = ("off", "local", "distributed")
_WORKER_MODULE = "repro_torch.launch._worker"


def _src_root() -> str:
    """Directory that makes ``import repro_torch`` work in a child
    process."""
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def _child_env() -> dict:
    """This process's environment with ``repro_torch`` importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_root() + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize_from_env(num_shards: int, env=None, *, backend=None,
                        device=None):
    """Multi-host bring-up: the default process group from
    ``REPRO_COORDINATOR`` (``host:port`` of rank 0's TCP store) /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` (a world of one on a
    free local port when unset), then the flat mesh of ``num_shards``
    shards over it.  ``backend`` None = NCCL and ``device`` None =
    ``cuda:{rank % device_count}``: both raise without CUDA.  Returns
    ``(mesh, my_shard_ids)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (flat_mesh, init_shard_group,
                                         local_shards)
    env = os.environ if env is None else env
    n = int(env.get("REPRO_NUM_PROCESSES", "1") or 1)
    coord = env.get("REPRO_COORDINATOR")
    if not coord:
        if n > 1:
            raise ValueError(
                f"REPRO_NUM_PROCESSES={n} needs REPRO_COORDINATOR=host:port")
        coord = f"127.0.0.1:{free_port()}"
    init_shard_group(backend, f"tcp://{coord}", world_size=n,
                     rank=int(env.get("REPRO_PROCESS_ID", "0") or 0))
    try:
        mesh = flat_mesh(num_shards, device=device)
    except Exception:
        dist.destroy_process_group()
        raise
    return mesh, list(local_shards(mesh))


# ---------------------------------------------------------------------------
# Coordinator-side cluster handle.  The worker process entry lives in
# the import-light ``launch/_worker.py``; this module is coordinator-only
# and free to import the full runtime stack.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerProc:
    worker_id: int
    popen: subprocess.Popen
    log_path: str

    def alive(self) -> bool:
        return self.popen.poll() is None


class Cluster:
    """Spawn/replace/signal a set of worker subprocesses on one host.

    ``ownership`` maps worker id → leased shard ids (round-robin over
    ``num_shards`` by default).  ``detect`` picks the death-detection
    path the monitor may use: ``"lease"`` (missed heartbeat deadline
    only: the path a real multi-box deployment has) or ``"poll"`` (also
    consult ``Popen.poll``: the fast local path).  ``device`` is the
    device of ``torch_mode="local"`` workers (None = CUDA; a worker
    raises without it).
    """

    def __init__(self, root: str, num_workers: int, *,
                 num_shards: Optional[int] = None,
                 config: Optional[HealthConfig] = None,
                 torch_mode: str = "off", device: Optional[str] = None,
                 detect: str = "lease",
                 retrier: Optional[Retrier] = None, tracer=None,
                 metrics=None):
        if torch_mode not in _TORCH_MODES:
            raise ValueError(f"torch_mode must be one of {_TORCH_MODES}, "
                             f"got {torch_mode!r}")
        if detect not in ("lease", "poll"):
            raise ValueError(f"detect must be 'lease' or 'poll', "
                             f"got {detect!r}")
        self.root = root
        self.num_workers = int(num_workers)
        self.num_shards = int(num_shards or num_workers)
        self.config = config or HealthConfig()
        self.torch_mode = torch_mode
        self.device = device
        self.detect = detect
        self.retrier = retrier or Retrier()
        self.tracer = tracer
        self.metrics = metrics
        self.procs: Dict[int, WorkerProc] = {}
        self.ownership: Dict[int, List[int]] = {
            w: [s for s in range(self.num_shards)
                if s % self.num_workers == w]
            for w in range(self.num_workers)}
        self.retired: Dict[int, Optional[int]] = {}
        self.kill_times: Dict[int, float] = {}
        self._cmd_seq = 0
        self._bseq = 0
        self._timers: List[threading.Timer] = []
        os.makedirs(root, exist_ok=True)

    # ---- spawn / lifecycle ----------------------------------------------
    def _spawn(self, wid: int) -> WorkerProc:
        wdir = worker_dir(self.root, wid)
        os.makedirs(wdir, exist_ok=True)
        log_path = os.path.join(wdir, "log.txt")
        cmd = [sys.executable, "-m", _WORKER_MODULE,
               "--id", str(wid), "--root", self.root,
               "--hb-interval", str(self.config.heartbeat_interval),
               "--torch", self.torch_mode]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        with open(log_path, "ab") as log:
            popen = subprocess.Popen(cmd, env=_child_env(),
                                     stdout=log, stderr=subprocess.STDOUT)
        proc = WorkerProc(wid, popen, log_path)
        self.procs[wid] = proc
        if self.tracer is not None:
            self.tracer.instant("worker_spawned", tid=f"worker{wid}",
                                worker=wid, pid=popen.pid)
        if self.metrics is not None:
            self.metrics.counter("health.workers_spawned").inc()
        return proc

    def start(self) -> None:
        for w in range(self.num_workers):
            self._spawn(w)
        self.wait_ready(list(range(self.num_workers)))
        self._push_assignments()

    def wait_ready(self, worker_ids: List[int],
                   timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.config.ready_timeout)
        pending = set(worker_ids)
        while pending:
            for w in sorted(pending):
                hb = self.retrier.call(
                    read_json, heartbeat_path(self.root, w),
                    op=f"ready:{w}", retryable=IO_RETRYABLE)
                if hb is not None:
                    pending.discard(w)
                    continue
                proc = self.procs.get(w)
                if proc is not None and not proc.alive():
                    raise RuntimeError(
                        f"worker {w} exited rc={proc.popen.returncode} "
                        f"before its first heartbeat; log tail:\n"
                        f"{self.log_tail(w)}")
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"workers {sorted(pending)} not ready; log tails:\n"
                    + "\n".join(self.log_tail(w) for w in sorted(pending)))
            time.sleep(self.config.poll_interval)

    def log_tail(self, wid: int, n: int = 1500) -> str:
        proc = self.procs.get(wid)
        if proc is None or not os.path.exists(proc.log_path):
            return f"[worker {wid}: no log]"
        with open(proc.log_path, "rb") as f:
            data = f.read()[-n:]
        return f"[worker {wid}] " + data.decode(errors="replace")

    def shutdown(self) -> None:
        for t in self._timers:
            t.cancel()
        for wid, proc in self.procs.items():
            if not proc.alive():
                continue
            try:                       # a paused worker can't read cmds
                os.kill(proc.popen.pid, signal.SIGCONT)
            except OSError:
                pass
            self._cmd(wid, {"kind": "shutdown"})
        deadline = time.monotonic() + 2.0
        for proc in self.procs.values():
            try:
                proc.popen.wait(timeout=max(deadline - time.monotonic(),
                                            0.05))
            except subprocess.TimeoutExpired:
                proc.popen.kill()
                proc.popen.wait(timeout=10)

    # ---- channel writes --------------------------------------------------
    def _cmd(self, wid: int, payload: dict) -> None:
        self._cmd_seq += 1
        write_json(os.path.join(worker_dir(self.root, wid), "cmd.json"),
                   {**payload, "seq": self._cmd_seq})

    def _push_assignments(self) -> None:
        for wid, shards in self.ownership.items():
            self._cmd(wid, {"kind": "assign", "shards": list(shards)})

    def broadcast_stratum(self, stratum: int) -> tuple[int, float]:
        """Publish the stratum task; returns ``(broadcast_seq, t0)``: ack
        walls are measured against ``t0``."""
        self._bseq += 1
        t0 = time.monotonic()
        write_json(stratum_path(self.root),
                   {"seq": self._bseq, "stratum": int(stratum), "t": t0})
        return self._bseq, t0

    def collect_acks(self, bseq: int, t0: float,
                     timeout: Optional[float] = None
                     ) -> Dict[int, Optional[float]]:
        """Wait (bounded) for each live worker's ack to broadcast
        ``bseq``; returns worker → measured ack wall seconds (``None`` =
        missed the deadline: dead, paused, or straggling past it)."""
        # The deadline counts from the BROADCAST; the stratum compute
        # between broadcast and collection may exceed it, so always run
        # at least one read pass: acks already on disk must never be
        # misread as timeouts.
        deadline = t0 + (timeout if timeout is not None
                         else self.config.ack_timeout)
        waiting = {w for w in self.ownership
                   if w not in self.retired and self.ownership.get(w)}
        walls: Dict[int, Optional[float]] = {}
        while True:
            for w in sorted(waiting):
                ack = self.retrier.call(
                    read_json, ack_path(self.root, w, bseq),
                    op=f"ack:{w}", shard=(self.ownership[w] or [0])[0],
                    retryable=IO_RETRYABLE)
                if ack is not None:
                    walls[w] = max(ack["t"] - t0, 0.0)
                elif self.detect == "poll" and w in self.procs \
                        and not self.procs[w].alive():
                    walls[w] = None       # observably dead: stop waiting
            waiting -= set(walls)
            if not waiting or time.monotonic() >= deadline:
                break
            time.sleep(self.config.poll_interval)
        for w in waiting:
            walls[w] = None
        return walls

    # ---- ownership / signals --------------------------------------------
    def worker_of(self, shard: int) -> int:
        for w, shards in self.ownership.items():
            if shard in shards:
                return w
        raise KeyError(f"shard {shard} is leased by no worker "
                       f"(ownership: {self.ownership})")

    def proc_alive(self, wid: int) -> Optional[bool]:
        """Fast-path liveness for the HealthMonitor; ``None`` in lease
        mode (deadline-only detection, the multi-box-faithful path)."""
        if self.detect != "poll":
            return None
        proc = self.procs.get(wid)
        return proc.alive() if proc is not None else False

    def kill(self, wid: int) -> None:
        """REAL failure: SIGKILL the worker and wait for the process to
        be gone (the kill is then strictly before the next barrier)."""
        proc = self.procs[wid]
        self.kill_times[wid] = time.monotonic()
        if proc.alive():
            proc.popen.kill()
        try:
            proc.popen.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        if self.tracer is not None:
            self.tracer.instant("worker_killed", tid=f"worker{wid}",
                                worker=wid)

    def pause(self, wid: int, duration: float) -> None:
        """REAL straggler: SIGSTOP now, SIGCONT after ``duration``: the
        worker misses heartbeats/acks but its lease survives."""
        proc = self.procs[wid]
        if not proc.alive():
            return
        os.kill(proc.popen.pid, signal.SIGSTOP)
        if self.tracer is not None:
            self.tracer.instant("worker_paused", tid=f"worker{wid}",
                                worker=wid, duration_s=duration)

        def _resume(pid=proc.popen.pid):
            try:
                os.kill(pid, signal.SIGCONT)
            except OSError:
                pass
        t = threading.Timer(duration, _resume)
        t.daemon = True
        t.start()
        self._timers.append(t)

    def retire(self, wid: int,
               new_num_shards: Optional[int] = None) -> None:
        """REAL permanent loss: kill with replacement disabled; the
        driver's elastic rescale absorbs the missing worker."""
        self.retired[wid] = new_num_shards
        self.kill(wid)

    def replace(self, wid: int) -> float:
        """Replacement node: fresh process under the same worker id,
        taking over the dead worker's lease (its channel dir is wiped: a
        stale heartbeat must not revive the old lease).  Returns the
        seconds from the spawn to the replacement's first heartbeat (its
        imports and device set-up included)."""
        old = self.procs.get(wid)
        if old is not None and old.alive():
            old.popen.kill()
            old.popen.wait(timeout=10)
        wdir = worker_dir(self.root, wid)
        for name in ("heartbeat.json", "ready.json", "cmd.json"):
            try:
                os.unlink(os.path.join(wdir, name))
            except OSError:
                pass
        t0 = time.monotonic()
        self._spawn(wid)
        self.wait_ready([wid])
        respawn_s = time.monotonic() - t0
        self._cmd(wid, {"kind": "assign",
                        "shards": list(self.ownership.get(wid, []))})
        self.kill_times.pop(wid, None)
        return respawn_s

    def reassign(self, num_shards: int) -> Dict[int, List[int]]:
        """Round-robin ``num_shards`` shards over the surviving workers
        (elastic rescale): retired/dead workers lease nothing."""
        alive = [w for w in sorted(self.ownership)
                 if w not in self.retired
                 and (w in self.procs and self.procs[w].alive())]
        if not alive:
            raise RuntimeError("no live workers left to lease shards")
        self.num_shards = int(num_shards)
        new = {w: [] for w in self.ownership}
        for s in range(num_shards):
            new[alive[s % len(alive)]].append(s)
        self.ownership = new
        self._push_assignments()
        return new


# ---------------------------------------------------------------------------
# The distributed resilient driver.
# ---------------------------------------------------------------------------

class DistributedResilientDriver(ResilientDriver):
    """ResilientDriver whose failure signals are REAL.

    The data plane (stratum compute, replica chain, recovery) is the
    parent class verbatim, on the coordinator; this subclass adds the
    control plane:

      * every punctuation barrier broadcasts a stratum task to the
        workers and measures real per-worker ack arrival walls, which
        REPLACE the coordinator's per-shard latencies in
        ``MeasuredLatencies`` (the SpeculationPolicy feed);
      * the :class:`HealthMonitor` is polled at every barrier; a missed
        lease deadline wipes the dead node's replica-chain disk and
        pushes its shards through ``_recover``, the SAME queue-driven
        path an injected ``FaultSchedule`` failure takes; then a
        replacement worker is spawned and ``ReplicaChain.reseed`` heals
        the ring;
      * a worker marked ``retired`` (it never comes back) triggers the
        elastic rescale path instead, with leases re-granted round-robin
        over the survivors;
      * ``chaos_hook(driver)`` (optional) runs first at each barrier:
        the real chaos executor uses it to deliver SIGKILL/SIGSTOP on
        schedule.

    The executor must not be of ``backend="shard_map"``: its collectives
    span processes, and killing one member poisons the communicator, so
    the data plane stays on the coordinator (module docstring).
    """

    def __init__(self, executor, algo, state0, live0, immutable,
                 max_iters: int, mode: str = "delta",
                 explicit_cond: Optional[Callable] = None, *,
                 ckpt_root: str, cluster: Cluster,
                 strategy: str = "incremental",
                 chaos_hook: Optional[Callable] = None,
                 policy=None, latency_model=None, remake=None,
                 pack: Callable = pack_state,
                 unpack: Callable = unpack_state,
                 retry=None, budget=None, tracer=None, metrics=None):
        if getattr(executor, "backend", None) == "shard_map":
            raise ValueError(
                "DistributedResilientDriver keeps the data plane on the "
                "coordinator: a shard_map executor's collectives span the "
                "processes, and killing one member poisons the whole "
                "communicator; use run_resilient on backend='shard_map'")
        super().__init__(
            executor, algo, state0, live0, immutable, max_iters,
            mode=mode, explicit_cond=explicit_cond, ckpt_root=ckpt_root,
            fault_plan=FaultSchedule(strategy=strategy), policy=policy,
            latency_model=latency_model, remake=remake, pack=pack,
            unpack=unpack, retry=retry, budget=budget, tracer=tracer,
            metrics=metrics)
        self.cluster = cluster
        self.chaos_hook = chaos_hook
        # Real runs always carry a mitigator: stragglers are not
        # scheduled, they happen.
        if self.mitigator is None:
            self.mitigator = StragglerMitigator(
                self.snapshot.num_shards, self.policy,
                replicas_of=self.snapshot.replicas_of)
        self.monitor = HealthMonitor(
            cluster.root, cluster.ownership, cluster.config,
            retrier=self.retrier, proc_alive=cluster.proc_alive,
            tracer=self.tracer, metrics=self.metrics)
        self.detections: List[dict] = []
        self.ack_timeouts = 0
        self.acks_collected = 0

    # ---- real failure signals -------------------------------------------
    def _external_events(self) -> bool:
        if self.chaos_hook is not None:
            self.chaos_hook(self)
        report = self.monitor.observe(stratum=self.stratum)
        for shard, age in report.straggles:
            self.mitigator.note_timeout(shard)
            self._event({"event": "worker_straggle",
                         "stratum": self.stratum, "shard": shard,
                         "age_s": age})
        if not report.dead_workers:
            return False
        now = time.monotonic()
        for w in report.dead_workers:
            kt = self.cluster.kill_times.get(w)
            det = (now - kt) if kt is not None else None
            self.detections.append({"worker": w, "stratum": self.stratum,
                                    "detection_s": det})
            self._event({"event": "worker_dead", "worker": w,
                         "stratum": self.stratum, "detection_s": det,
                         "shards": list(
                             self.cluster.ownership.get(w, []))})
        replaceable = [w for w in report.dead_workers
                       if w not in self.cluster.retired]
        gone = [w for w in report.dead_workers if w not in replaceable]
        restarted = False
        if replaceable:
            restarted = self._handle_replaceable(replaceable)
        if gone:
            self._handle_gone(gone)
        return restarted

    def _handle_replaceable(self, workers: List[int]) -> bool:
        """Real process loss → the injected-failure path verbatim: wipe
        the dead nodes' disks, respawn replacements, drain the recovery
        queue (which reseeds the replica ring), or restart under the
        restart strategy."""
        dead_shards = sorted({s for w in workers
                              for s in self.cluster.ownership.get(w, [])})
        for s in dead_shards:
            self.chain.wipe(s)
        self._event({"event": "failure", "stratum": self.stratum,
                     "shard": dead_shards[0] if dead_shards else -1,
                     "correlated": len(workers) > 1, "during": "real",
                     "strategy": self.schedule.strategy,
                     "shards": dead_shards, "workers": list(workers)})
        for w in workers:
            respawn_s = self.cluster.replace(w)
            self.monitor.reinstate(w)
            self._event({"event": "worker_replaced", "worker": w,
                         "stratum": self.stratum, "respawn_s": respawn_s})
        if not dead_shards:
            return False
        if self.schedule.strategy == "restart":
            self._restart()
            return True
        return self._recover(dead_shards)

    def _handle_gone(self, workers: List[int]) -> None:
        """A worker that never comes back → elastic rescale: its disk is
        gone, its lease is not re-granted, and the key space is
        re-partitioned over the survivors."""
        if self.remake is None:
            raise ValueError(
                "a permanently-lost worker needs remake(new_snapshot) "
                "-> (executor, algo, immutable) to rescale around it")
        lost = sorted({s for w in workers
                       for s in self.cluster.ownership.get(w, [])})
        for s in lost:
            self.chain.wipe(s)
        targets = [self.cluster.retired.get(w) for w in workers
                   if self.cluster.retired.get(w)]
        new_k = targets[0] if targets else max(
            self.snapshot.num_shards - len(lost), 1)
        self._event({"event": "worker_gone", "stratum": self.stratum,
                     "workers": list(workers), "shards": lost,
                     "to_shards": new_k})
        for w in workers:
            self.cluster.ownership[w] = []
            self.cluster.retired.setdefault(w, None)
        self._do_rescale(FaultEvent(kind="rescale", at=self.stratum,
                                    new_num_shards=new_k))

    def _do_rescale(self, ev) -> None:
        super()._do_rescale(ev)
        ownership = self.cluster.reassign(self.snapshot.num_shards)
        self.monitor.set_ownership(ownership)

    # ---- real measured latencies ----------------------------------------
    def step(self):
        stratum = self.stratum
        bseq, t0 = self.cluster.broadcast_stratum(stratum)
        outcome = super().step()
        walls = self.cluster.collect_acks(bseq, t0)
        per_shard = list(self.measured.latencies[-1])
        for w, wall in sorted(walls.items()):
            shards = self.cluster.ownership.get(w, [])
            if wall is None:
                self.ack_timeouts += 1
                for s in shards:
                    self.mitigator.note_timeout(s)
                self._event({"event": "ack_timeout", "stratum": stratum,
                             "worker": w})
                continue
            self.acks_collected += 1
            for s in shards:
                if s < len(per_shard):
                    per_shard[s] = wall
            if self.tracer is not None:
                self.tracer.instant("worker_ack", tid=f"worker{w}",
                                    worker=w, stratum=stratum,
                                    wall_s=wall)
            if self.metrics is not None:
                self.metrics.histogram(
                    "health.ack_wall_seconds").observe(wall)
        # Real arrival walls replace the coordinator-side estimate as
        # the stratum's measured per-shard latency (speculation feed).
        self.measured.latencies[-1] = per_shard
        return outcome

    def run(self):
        out = super().run()
        out.metrics["mode"] = "distributed"
        out.metrics["workers"] = self.cluster.num_workers
        out.metrics["worker_detections"] = self.detections
        out.metrics["acks_collected"] = self.acks_collected
        out.metrics["ack_timeouts"] = self.ack_timeouts
        return out


# ---------------------------------------------------------------------------
# Bring-up selftest.
# ---------------------------------------------------------------------------

def selftest(num_workers: int = 2, shards_per_worker: int = 2, *,
             backend: Optional[str] = None, device: Optional[str] = None,
             timeout: float = 300.0) -> dict:
    """Spawn ``num_workers`` processes that form one ``torch.distributed``
    group (rank 0 hosts the TCP store), collect each process's bring-up
    report, and verify its rank, world, backend and device, the flat-mesh
    shard ownership (each rank a contiguous block; disjoint, exhaustive)
    and one all_gather of the process ids.  ``backend`` None = NCCL, one
    rank a GPU (``cuda:{rank % device_count}``); raises without CUDA
    unless given ``backend="gloo"`` and ``device="cpu"``."""
    import torch
    backend = backend or "nccl"
    if device is None or backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass backend='gloo' and "
                "device='cpu' to run the selftest on the CPU")
    total = num_workers * shards_per_worker
    root = tempfile.mkdtemp(prefix="repro_torch_selftest_")
    try:
        port = free_port()
        env = _child_env()
        procs = []
        for w in range(num_workers):
            wdir = worker_dir(root, w)
            os.makedirs(wdir, exist_ok=True)
            cmd = [sys.executable, "-m", _WORKER_MODULE, "--oneshot",
                   "--id", str(w), "--root", root, "--torch", "distributed",
                   "--backend", backend,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(num_workers),
                   "--process-id", str(w), "--num-shards", str(total)]
            if device is not None:
                cmd += ["--device", device]
            with open(os.path.join(wdir, "log.txt"), "ab") as log:
                procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failures = []
        for w, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = -9
            if rc != 0:
                with open(os.path.join(worker_dir(root, w), "log.txt"),
                          "rb") as f:
                    failures.append(f"worker {w} rc={rc}: " + f.read()[
                        -1500:].decode(errors="replace"))
        if failures:
            raise RuntimeError("distributed bring-up failed:\n"
                               + "\n".join(failures))
        reports = []
        for w in range(num_workers):
            rep = read_json(os.path.join(worker_dir(root, w), "ready.json"))
            if rep is None:
                raise RuntimeError(f"worker {w} exited 0 but wrote no "
                                   "ready report")
            reports.append(rep)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    owned: List[int] = []
    for w, rep in enumerate(reports):
        want_dev = device if device is not None \
            else f"cuda:{w % torch.cuda.device_count()}"
        want = {"process_index": w, "num_processes": num_workers,
                "backend": backend, "device": str(torch.device(want_dev)),
                "num_shards": total,
                "local_shards": list(range(w * shards_per_worker,
                                           (w + 1) * shards_per_worker)),
                "allgather": list(range(num_workers))}
        bad = {k: rep.get(k) for k, v in want.items() if rep.get(k) != v}
        if bad:
            expected = {k: want[k] for k in bad}
            raise RuntimeError(f"worker {w} reported {bad}, expected "
                               f"{expected}")
        owned.extend(rep["local_shards"])
    if sorted(owned) != list(range(total)):
        raise RuntimeError(
            f"shard ownership must partition the flat mesh, got {owned}")
    return {
        "num_workers": num_workers,
        "shards_per_worker": shards_per_worker,
        "num_shards": total,
        "backend": backend,
        "devices": {str(w): rep["device"] for w, rep in enumerate(reports)},
        "ownership": {str(w): rep["local_shards"]
                      for w, rep in enumerate(reports)},
        "collective_ok": True,
    }


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Multi-process torch.distributed bring-up selftest.")
    parser.add_argument("--selftest", action="store_true")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--shards-per-worker", type=int, default=2)
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process group backend (default: nccl, one "
                             "rank a GPU; raises without CUDA)")
    parser.add_argument("--device", default=None,
                        help="every rank's device (default: "
                             "cuda:{rank %% device_count})")
    args = parser.parse_args(argv)
    if args.selftest:
        report = selftest(args.workers, args.shards_per_worker,
                          backend=args.backend, device=args.device)
        print(json.dumps(report, indent=2))
        return 0
    parser.error("pass --selftest (workers run via "
                 f"python -m {_WORKER_MODULE})")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
