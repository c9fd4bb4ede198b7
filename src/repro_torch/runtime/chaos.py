"""Seeded chaos-schedule generation for the resilient fixpoint driver.

Pregelix's robustness argument (PAPERS.md) is that recovery behavior
must be validated under realistic *compounding* failures, not
extrapolated from single-fault runs.  This module is the generator side
of that argument: :func:`generate_schedule` draws a randomized — but
fully seed-deterministic — :class:`FaultSchedule` mixing repeated shard
failures, correlated replica loss, failures injected while an earlier
recovery is still in flight, elastic rescales with mid-rescale
failures, and transient stragglers.  The property the chaos tests hold
over every generated schedule:

    recoverable  ⇒ final state bit-identical to the failure-free run
    unrecoverable⇒ the view layer degrades (staleness-tagged answer),
                   and never serves corrupt data

Determinism matters more than realism here: the same ``(seed, config)``
always yields the same schedule, so a failing chaos run reproduces
exactly from its seed.

Run one seeded schedule end-to-end against the failure-free run (on the
card; ``--device cpu`` for the CPU)::

    python -m repro_torch.runtime.chaos --seed 7 --events 4 --quick

``--real`` executes the SAME seeded schedule against live worker
processes (``launch/distributed.py``): a ``fail`` event SIGKILLs the
worker leasing that shard (correlated: its first ring replica's worker
too), a ``straggle`` SIGSTOPs it past the straggle threshold, a
``rescale`` permanently retires a worker, and the run must STILL
bit-match the failure-free single-process run (chaos parity).  The
engine runs on ``--device`` (CUDA by default); on the CPU:

    python -m repro_torch.runtime.chaos --seed 0 --events 2 --quick \\
        --nodes 1024 --real --device cpu
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.runtime.recovery import FaultEvent, FaultSchedule


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs for one randomized schedule draw.

    ``n_events`` counts *primary* events; compound follow-ons (a
    correlated replica loss rides its fail event, a during-recovery
    failure rides the recovery its predecessor started) do not consume
    a slot, so the realized schedule may carry more FaultEvents than
    ``n_events``.
    """

    seed: int = 0
    num_shards: int = 4           # shard count the run starts with
    max_stratum: int = 8          # events land on strata [1, max_stratum)
    n_events: int = 3
    p_correlated: float = 0.25    # fail also wipes the first ring replica
    p_during_recovery: float = 0.25   # fail strikes mid-recovery
    p_rescale: float = 0.15
    p_straggle: float = 0.15
    p_fail_during_rescale: float = 0.5  # given a rescale, add a mid-
    #                                     migration failure under the
    #                                     new snapshot
    min_shards: int = 2
    max_shards: int = 8
    strategy: str = "incremental"     # "incremental" | "restart"

    def __post_init__(self):
        if self.n_events < 1:
            raise ValueError(
                f"ChaosConfig.n_events must be >= 1, got {self.n_events!r}")
        if self.max_stratum < 2:
            raise ValueError(
                f"ChaosConfig.max_stratum must be >= 2, got "
                f"{self.max_stratum!r}")
        if self.min_shards < 1 or self.max_shards < self.min_shards:
            raise ValueError(
                f"ChaosConfig needs 1 <= min_shards <= max_shards, got "
                f"min_shards={self.min_shards!r}, "
                f"max_shards={self.max_shards!r}")


def generate_schedule(cfg: ChaosConfig) -> FaultSchedule:
    """Draw one deterministic multi-event schedule from ``cfg``.

    The draw tracks the shard count through rescales so every event's
    ``shard`` is valid under the snapshot it will fire under, and emits
    during-recovery / during-rescale follow-ons anchored to the event
    that makes them fireable (same stratum, later in list order — the
    FaultSchedule contract).
    """
    rng = random.Random(cfg.seed)
    ats = sorted(rng.randrange(1, cfg.max_stratum)
                 for _ in range(cfg.n_events))
    events: list[FaultEvent] = []
    shards = cfg.num_shards
    for at in ats:
        r = rng.random()
        if r < cfg.p_rescale:
            choices = [k for k in range(cfg.min_shards, cfg.max_shards + 1)
                       if k != shards]
            if choices:
                shards = rng.choice(choices)
                events.append(FaultEvent(kind="rescale", at=at,
                                         new_num_shards=shards))
                if rng.random() < cfg.p_fail_during_rescale:
                    # Mid-migration failure: fires inside _do_rescale,
                    # under the NEW snapshot, against the barely-landed
                    # migrated chain.
                    events.append(FaultEvent(
                        kind="fail", at=at, shard=rng.randrange(shards),
                        during="rescale"))
                continue
        if r < cfg.p_rescale + cfg.p_straggle:
            events.append(FaultEvent(
                kind="straggle", at=at, shard=rng.randrange(shards),
                slowdown=round(2.0 + 3.0 * rng.random(), 3)))
            continue
        shard = rng.randrange(shards)
        correlated = rng.random() < cfg.p_correlated
        events.append(FaultEvent(kind="fail", at=at, shard=shard,
                                 correlated=correlated))
        if cfg.strategy == "incremental" \
                and rng.random() < cfg.p_during_recovery:
            # Strikes while the recovery the previous event started is
            # in flight — recovery must be re-entrant.
            events.append(FaultEvent(
                kind="fail", at=at, shard=rng.randrange(shards),
                during="recovery"))
    return FaultSchedule(events=tuple(events), strategy=cfg.strategy)


def acceptance_schedule(num_shards: int = 4,
                        strategy: str = "incremental") -> FaultSchedule:
    """The acceptance scenario, pinned: >= 3 faults including
    one correlated replica loss and one failure-during-recovery."""
    return FaultSchedule(events=(
        FaultEvent(kind="fail", at=1, shard=1 % num_shards),
        FaultEvent(kind="fail", at=2, shard=2 % num_shards,
                   correlated=True),
        FaultEvent(kind="fail", at=2, shard=3 % num_shards,
                   during="recovery"),
    ), strategy=strategy)


# ---------------------------------------------------------------------------
# Real-mode executor: the seeded schedule delivered as actual signals.
# ---------------------------------------------------------------------------

class RealChaosInjector:
    """Executes a :class:`FaultSchedule` against live worker processes.

    Installed as the distributed driver's ``chaos_hook``; at every
    punctuation barrier it fires all events whose stratum is due:

      * ``fail``     → SIGKILL the worker leasing the shard (correlated:
        also the worker leasing the shard's first ring replica) — the
        driver must DETECT the loss via the lease table, not be told;
      * ``straggle`` → SIGSTOP the owner past the straggle threshold
        (auto-SIGCONT before its lease expires): late heartbeats, a
        missed ack, a straggle signal — never a death;
      * ``rescale``  → permanently retire one surviving worker with the
        event's target shard count; the driver's elastic rescale
        absorbs it.

    ``during='recovery'/'rescale'`` windows are a simulation-only
    concept (real failures cannot be injected INSIDE the coordinator's
    handler from the outside); those events fire as ordinary barrier
    kills at their stratum — same-barrier multiples still exercise the
    multi-entry recovery queue.  Every event fires at most once;
    ``fired``/``skipped`` keep the accounting for the summary.
    """

    def __init__(self, schedule: FaultSchedule, cluster):
        self.pending = list(schedule.events)
        self.cluster = cluster
        self.fired: list = []
        self.skipped: list = []

    def _owner(self, shard: int):
        try:
            return self.cluster.worker_of(shard)
        except KeyError:
            return None

    def _alive_workers(self) -> list:
        return [w for w, p in self.cluster.procs.items()
                if p.alive() and w not in self.cluster.retired]

    def __call__(self, driver) -> None:
        while self.pending and self.pending[0].at <= driver.stratum:
            ev = self.pending.pop(0)
            record = {"kind": ev.kind, "at": ev.at, "shard": ev.shard,
                      "stratum": driver.stratum}
            if ev.kind == "fail":
                targets = {self._owner(ev.shard)}
                if ev.correlated:
                    reps = driver.snapshot.replicas_of(ev.shard)
                    if reps:
                        targets.add(self._owner(reps[0]))
                targets.discard(None)
                if not targets:
                    self.skipped.append(record)
                    continue
                for w in sorted(targets):
                    self.cluster.kill(w)
                record["workers"] = sorted(targets)
            elif ev.kind == "straggle":
                w = self._owner(ev.shard)
                if w is None:
                    self.skipped.append(record)
                    continue
                cfg = self.cluster.config
                pause_s = cfg.straggle_after + 0.3 * (
                    cfg.lease_ttl - cfg.straggle_after)
                self.cluster.pause(w, pause_s)
                record["workers"] = [w]
                record["pause_s"] = round(pause_s, 3)
            else:                       # rescale → retire one worker
                alive = self._alive_workers()
                if len(alive) < 2:      # never retire the last worker
                    self.skipped.append(record)
                    continue
                w = alive[-1]
                self.cluster.retire(w, new_num_shards=ev.new_num_shards)
                record["workers"] = [w]
                record["to_shards"] = ev.new_num_shards
            self.fired.append(record)


# ---------------------------------------------------------------------------
# CLI: one seeded schedule end-to-end vs the failure-free run.  Engine
# imports are local to main(): repro_torch.runtime.__init__ imports this
# module, a top-level engine import would cycle.
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    import argparse
    import json
    import shutil
    import tempfile
    import time

    parser = argparse.ArgumentParser(
        description="Run one seeded chaos schedule against the engine and "
                    "bit-compare with the failure-free run.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--events", type=int, default=3)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--max-stratum", type=int, default=6)
    parser.add_argument("--strategy", default="incremental",
                        choices=("incremental", "restart"))
    parser.add_argument("--acceptance", action="store_true",
                        help="run the pinned acceptance schedule instead "
                             "of a seeded draw")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--nodes", type=int, default=None,
                        help="override the dataset node count (tiny "
                             "graphs for smoke tests)")
    parser.add_argument("--device", default=None,
                        help="torch device of the engine and of local "
                             "workers (default: cuda)")
    parser.add_argument("--real", action="store_true",
                        help="execute the schedule as REAL signals "
                             "(SIGKILL/SIGSTOP/retire) against live "
                             "worker processes")
    parser.add_argument("--workers", type=int, default=None,
                        help="worker process count in --real mode "
                             "(default: one per shard)")
    parser.add_argument("--worker-torch", default="off",
                        choices=("off", "local"),
                        help="per-worker torch runtime in --real mode "
                             "(local: acks compute on --device)")
    parser.add_argument("--detect", default="lease",
                        choices=("lease", "poll"),
                        help="death detection in --real mode: missed "
                             "lease deadline only, or also Popen.poll")
    parser.add_argument("--lease-ttl", type=float, default=1.2)
    parser.add_argument("--hb-interval", type=float, default=0.05)
    parser.add_argument("--ack-timeout", type=float, default=0.8)
    parser.add_argument("--trace-out", default=None,
                        help="directory for Chrome trace + metrics JSON "
                             "(per-worker timeline rows)")
    args = parser.parse_args(argv)

    import torch

    from repro_torch.algorithms import sssp
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.partition import (PartitionSnapshot,
                                            unshard_dense_state)
    from repro_torch.data.graphs import (DATASETS, make_powerlaw_graph,
                                         shard_csr)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    S = args.shards
    if args.acceptance:
        schedule = acceptance_schedule(num_shards=S,
                                       strategy=args.strategy)
    else:
        schedule = generate_schedule(ChaosConfig(
            seed=args.seed, num_shards=S, n_events=args.events,
            max_stratum=args.max_stratum, strategy=args.strategy,
            min_shards=2, max_shards=max(S, 4)))

    dataset = "dbpedia-small" if args.quick else "dbpedia"
    n, avg, alpha = DATASETS[dataset]
    if args.nodes is not None:
        n = args.nodes
    indptr, indices = make_powerlaw_graph(n, avg, alpha, 0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    cap = max(65536, 4 * n)

    def remake(new_snap):
        a = sssp.make_algorithm(new_snap,
                                src_capacity=new_snap.block_size,
                                edge_capacity=cap)
        e = ShardedExecutor(snapshot=new_snap, seg_capacity=cap,
                            edge_capacity=cap,
                            src_capacity=new_snap.block_size,
                            ladder_tiers=4, route_strategy="auto")
        # The immutable graph is re-sharded for the new snapshot — a
        # rescale changes every leading shard axis, not just the state.
        return e, a, shard_csr(indptr, indices, new_snap.num_shards,
                               device=dev)

    ex, algo, g = remake(snap)
    state0 = sssp.initial_state(snap, 0, dev)
    ref = ex.run(algo, state0, 1, g, 80)

    tmp = tempfile.mkdtemp(prefix="chaos_")
    try:
        tracer = metrics_reg = None
        if args.trace_out:
            from repro_torch.obs.metrics import MetricsRegistry
            from repro_torch.obs.trace import Tracer
            tracer, metrics_reg = Tracer(), MetricsRegistry()
        t0 = time.perf_counter()
        if args.real:
            from repro_torch.launch.distributed import (
                Cluster, DistributedResilientDriver)
            from repro_torch.runtime.health import HealthConfig
            cfg = HealthConfig(lease_ttl=args.lease_ttl,
                               straggle_after=min(0.35, args.lease_ttl / 3),
                               heartbeat_interval=args.hb_interval,
                               ack_timeout=args.ack_timeout)
            cluster = Cluster(f"{tmp}/cluster", args.workers or S,
                              num_shards=S, config=cfg,
                              torch_mode=args.worker_torch,
                              device=str(dev), detect=args.detect,
                              tracer=tracer, metrics=metrics_reg)
            try:
                cluster.start()
                injector = RealChaosInjector(schedule, cluster)
                res = DistributedResilientDriver(
                    ex, algo, state0, 1, g, 80, ckpt_root=f"{tmp}/chaos",
                    cluster=cluster, strategy=schedule.strategy,
                    remake=remake, chaos_hook=injector, tracer=tracer,
                    metrics=metrics_reg).run()
            finally:
                cluster.shutdown()
        else:
            res = ex.run_resilient(algo, state0, 1, g, 80,
                                   ckpt_root=f"{tmp}/chaos",
                                   fault_plan=schedule, remake=remake,
                                   tracer=tracer, metrics=metrics_reg)
        wall = time.perf_counter() - t0
        # Compare in GLOBAL key space: a rescale changes leaf shapes but
        # never values — unshard both sides and demand bit equality.
        ref_flat = unshard_dense_state(snap, torch.stack(ref.state, -1))
        got_flat = unshard_dense_state(
            snap.resnapshot(res.metrics["final_num_shards"]),
            torch.stack(res.result.state, -1))
        identical = bool(torch.equal(ref_flat, got_flat))
        summary = {
            "seed": args.seed,
            "mode": "real" if args.real else "simulated",
            "device": str(dev),
            "strategy": schedule.strategy,
            "events": [dataclasses.asdict(e) for e in schedule.events],
            "faults": schedule.fail_count,
            "recoveries": res.metrics["recoveries"],
            "restarts": res.metrics["restarts"],
            "strata_executed": res.metrics["strata_executed"],
            "total_work_units": res.metrics["total_work_units"],
            "wall_s": round(wall, 3),
            "identical": bool(identical),
        }
        if args.real:
            summary["workers"] = res.metrics["workers"]
            summary["detect"] = args.detect
            summary["signals_fired"] = injector.fired
            summary["signals_skipped"] = injector.skipped
            summary["detections"] = res.metrics["worker_detections"]
            summary["ack_timeouts"] = res.metrics["ack_timeouts"]
        if args.trace_out:
            import os

            from repro_torch.obs.export import (write_chrome_trace,
                                                write_metrics)
            os.makedirs(args.trace_out, exist_ok=True)
            mode = "real" if args.real else "sim"
            write_chrome_trace(
                tracer, os.path.join(args.trace_out,
                                     f"chaos_{mode}_{args.seed}.trace.json"))
            write_metrics(
                metrics_reg, os.path.join(
                    args.trace_out, f"chaos_{mode}_{args.seed}.metrics.json"))
        print(json.dumps(summary, indent=2))
        return 0 if identical else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
