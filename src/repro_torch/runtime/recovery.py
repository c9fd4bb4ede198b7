"""Failure injection + the two recovery strategies of paper §6.6 (Fig 12).

Two layers:

  * The original toy harness — ``StratumRunner`` + ``run_with_failure`` —
    drives any one-stratum function with caller-supplied mutable
    extraction; it remains for the unit tests that pioneered the replay
    semantics.
  * The production integration — :class:`ResilientDriver`, reached
    through ``ShardedExecutor.run_resilient`` — makes the engine
    fault-tolerant and elastic: the executor's own eager stratum function
    (``make_stratum_fn``: density ladder, per-rung rehash strategy,
    kernels and all) runs one stratum per call; a :class:`ReplicaChain`
    persists each shard's changed-entry Δ set per stratum (a DeltaBuffer
    per shard, ring-replicated as in paper §4.1); an injected shard
    failure rebuilds the lost shard from replicas ONLY and resumes warm;
    an elastic rescale takes a fresh ``PartitionSnapshot``, migrates the
    dense state (``elastic.remap_state``) and pushes the chain's in-flight
    route buffers through ``combine_route`` under the new snapshot; and a
    straggler ``SpeculationPolicy`` re-issues slow shards against their
    replica.

Recovery strategies (paper §6.6, Fig 12):

  * ``restart``     — discard everything, start from stratum 0 (the Fig 12
    baseline; needs no mutable-state replication).
  * ``incremental`` — per stratum, every node replicates the *changed*
    entries of its mutable shard (the Δᵢ set — indices + payloads only) to
    its replica chain; on failure the lost shard is rebuilt by replaying
    those deltas onto the baseline, and execution resumes from the
    current stratum.  Monotone delta algorithms (min/sum refinement)
    re-converge from the restored shard — the paper's forward-progress
    guarantee under repeated failures.

The restored shard is reconstructed ONLY from replica checkpoints (never
from driver memory) — the simulation honors real failure semantics.  The
mutable set crosses to the host (numpy) for replication; restored state
goes back onto the device the run's state lives on.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.delta import PAD_KEY, DeltaBuffer
from repro_torch.core.fixpoint import (FixpointResult, StratumOutcome,
                                       stats_from_outcomes)
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.obs.trace import MeasuredLatencies
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            CheckpointManager, _leaf_paths,
                                            _tree_like)
from repro_torch.runtime.elastic import migrate_route_buffers, remap_state
from repro_torch.runtime.retry import (IO_RETRYABLE, RecoveryExhausted,
                                       Retrier, RetryBudget, RetryPolicy)
from repro_torch.runtime.straggler import (SpeculationPolicy,
                                           StragglerMitigator)


@dataclasses.dataclass
class StratumRunner:
    """One-stratum-at-a-time fixpoint execution (same stratum_fn as the
    fused engine loop — functionally identical)."""

    stratum_fn: Callable          # (state, stratum_idx) -> (state, outcome)
    state: object
    live: int
    stratum: int = 0
    work_units: int = 0           # Σ emitted deltas ≈ work performed

    def step(self) -> StratumOutcome:
        new_state, outcome = self.stratum_fn(self.state, self.stratum)
        self.state = new_state
        self.live = int(outcome.live_count)
        self.stratum += 1
        self.work_units += max(int(outcome.emitted), 1)
        return outcome

    def done(self) -> bool:
        return self.live <= 0


def run_with_failure(make_runner: Callable[[], StratumRunner],
                     ckpt: CheckpointManager,
                     mutable_of: Callable[[object], np.ndarray],
                     restore_mutable: Callable[[object, np.ndarray, int],
                                               object],
                     fail_at: Optional[int], failed_node: int,
                     strategy: str = "incremental", max_strata: int = 500
                     ) -> dict:
    """Execute to convergence with one injected failure at ``fail_at``.

    mutable_of(state) -> np [nodes, block, W] — the full replicable
    mutable set (pack value+sent columns); restore_mutable(state, shard,
    node) writes one node's shard back.

    Returns Fig-12 metrics: total work (incl. redone), bytes replicated.
    """
    if strategy not in ("incremental", "restart"):
        raise ValueError(strategy)
    runner = make_runner()
    init_mut = np.asarray(mutable_of(runner.state)).copy()
    prev_mut = init_mut.copy()
    total_work = 0
    strata_executed = 0
    bytes_replicated = 0
    failed = False

    while not runner.done() and strata_executed < max_strata:
        if fail_at is not None and not failed \
                and runner.stratum == fail_at:
            failed = True
            ckpt.wipe_node(failed_node)          # node dies; disk gone
            if strategy == "restart":
                total_work += runner.work_units
                runner = make_runner()
                prev_mut = init_mut.copy()
                continue
            # Incremental: rebuild the lost shard from REPLICA deltas only.
            shard = init_mut[failed_node].copy()
            for _, keys, payload in ckpt.replay_deltas(
                    failed_node, since_step=-1, from_replica=True):
                shard[keys] = payload
            runner.state = restore_mutable(runner.state, shard,
                                           failed_node)
            prev_mut[failed_node] = shard

        runner.step()
        strata_executed += 1
        if strategy == "incremental":
            mut = np.asarray(mutable_of(runner.state))
            for node in range(mut.shape[0]):
                changed = np.any(mut[node] != prev_mut[node], axis=-1)
                keys = np.nonzero(changed)[0].astype(np.int32)
                if len(keys) == 0:
                    continue
                bytes_replicated += ckpt.save_delta(
                    node, runner.stratum, keys, mut[node][keys]
                ) * ckpt.replication
            prev_mut = mut.copy()

    total_work += runner.work_units
    return {
        "strategy": strategy,
        "fail_at": fail_at,
        "strata_executed": strata_executed,
        "total_work_units": total_work,
        "bytes_replicated": bytes_replicated,
        "converged": runner.done(),
        "final_state": runner.state,
    }


# ---------------------------------------------------------------------------
# Production integration: replica chains + the resilient elastic driver.
# ---------------------------------------------------------------------------

def pack_state(state) -> np.ndarray:
    """Default mutable-set packing: stack every state leaf (each
    ``[S, block]`` float32) along a trailing W axis -> ``[S, block, W]``,
    on the host.

    PageRank, SSSP and CC satisfy the leaf contract; other states (e.g.
    adsorption's [S, block, L] vectors) pass explicit ``pack``/``unpack``
    callables to the driver instead."""
    leaves = [leaf for _, leaf in _leaf_paths(state)]
    if not leaves or any(getattr(leaf, "ndim", 0) != 2 for leaf in leaves) \
            or len({tuple(leaf.shape) for leaf in leaves}) != 1 \
            or any(leaf.dtype != torch.float32 for leaf in leaves):
        raise ValueError(
            "default packing needs uniform float32 [S, block] state "
            "leaves (a non-f32 leaf would silently round-trip through "
            "f32 on restore); provide pack/unpack callables for this "
            "state tree")
    return torch.stack(leaves, dim=-1).cpu().numpy()


def unpack_state(template, packed: np.ndarray):
    """Inverse of :func:`pack_state`: ``template`` supplies the tree
    structure and the device (its leaf SHAPES may differ — rescale changes
    them)."""
    paths = [path for path, _ in _leaf_paths(template)]
    return _tree_like(template, {path: np.asarray(packed[..., i],
                                                  np.float32)
                                 for i, path in enumerate(paths)})


class ReplicaChain:
    """Per-shard replica chain of changed-entry DeltaBuffers (paper §4.1).

    Epoch layout under ``root``: each epoch (opened at query start and at
    every restart/rescale — the lifetime of one partition snapshot) holds
    one full *baseline* checkpoint per shard (step 0) plus one
    changed-entry delta checkpoint per (shard, stratum) — global keys +
    full replacement payload rows — all ring-replicated onto the next
    ``snapshot.replication − 1`` nodes by the CheckpointManager.

    ``restore_shard`` rebuilds a shard from replicas only: baseline +
    in-order replay (each entry overwrites its rows — values are full
    replacements, so replay is exact to the last persisted stratum).

    ``migrate`` is the elastic path: chain entries are *in-flight route
    buffers* keyed by GLOBAL key, so a fresh snapshot re-routes them
    through the engine's own ``combine_route`` (``"replace"`` combiner =
    chronological last-writer per key) onto the new owners' chains, and
    the new epoch's baseline is the remapped initial state.

    The chain OWNS ``root``: with the default ``fresh=True`` any existing
    contents are deleted at construction (a replica chain is an
    intra-query structure — stale entries from a previous query would
    poison replay).  Point it at a dedicated directory.
    """

    def __init__(self, root: str, snapshot: PartitionSnapshot,
                 payload_width: int, fresh: bool = True,
                 retrier=None, keep_epochs: int = 2):
        self.root = root
        self.snapshot = snapshot
        self.payload_width = payload_width
        self.epoch = -1
        self.bytes_replicated = 0
        self.bytes_baseline = 0
        # runtime.retry.Retrier shared by every epoch's
        # CheckpointManager: replica reads retry transient errors with
        # seeded backoff; corrupt checkpoints quarantine and fall back.
        self.retrier = retrier
        # Epoch GC (paper: accumulated iteration state is discarded when
        # no longer useful): once a partition snapshot is superseded,
        # only the last ``keep_epochs`` epochs stay on disk — the
        # current one plus the fallback.
        self.keep_epochs = max(int(keep_epochs), 1)
        self.quarantined = 0
        if fresh and os.path.isdir(root):
            shutil.rmtree(root)

    # ---- epoch lifecycle -------------------------------------------------
    def open_epoch(self, snapshot: Optional[PartitionSnapshot] = None
                   ) -> None:
        if snapshot is not None:
            self.snapshot = snapshot
        if hasattr(self, "ckpt"):
            self.quarantined += len(self.ckpt.quarantined)
        self.epoch += 1
        self.ckpt = CheckpointManager(
            os.path.join(self.root, f"epoch{self.epoch}"),
            num_nodes=self.snapshot.num_shards,
            replication=self.snapshot.replication,
            retrier=self.retrier)
        self._step = 0
        self.prev: Optional[np.ndarray] = None
        self._gc_epochs()

    @property
    def total_quarantined(self) -> int:
        """Corrupt checkpoint files quarantined across every epoch."""
        current = len(self.ckpt.quarantined) if hasattr(self, "ckpt") else 0
        return self.quarantined + current

    def _gc_epochs(self) -> None:
        """Delete epoch directories superseded beyond ``keep_epochs``."""
        cutoff = self.epoch - self.keep_epochs
        if cutoff < 0 or not os.path.isdir(self.root):
            return
        for name in os.listdir(self.root):
            if not name.startswith("epoch"):
                continue
            try:
                k = int(name[len("epoch"):])
            except ValueError:
                continue
            if k <= cutoff:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def baseline(self, packed: np.ndarray) -> None:
        """Full per-shard snapshot (step 0) every restore replays from."""
        for s in range(self.snapshot.num_shards):
            self.ckpt.save_full(s, 0, {"mut": packed[s]})
        self.bytes_baseline += packed.nbytes * self.ckpt.replication
        self.prev = np.array(packed)
        self._step = 0

    # ---- per-stratum write side -----------------------------------------
    def append(self, packed: np.ndarray) -> int:
        """Persist each shard's changed-entry DeltaBuffer for the stratum
        just completed; returns bytes written across all replicas."""
        assert self.prev is not None, "baseline() must precede append()"
        self._step += 1
        written = 0
        for s in range(self.snapshot.num_shards):
            changed = np.any(packed[s] != self.prev[s], axis=-1)
            local = np.nonzero(changed)[0].astype(np.int32)
            if local.size == 0:
                continue
            gkeys = np.asarray(self.snapshot.global_keys(s, local),
                               np.int32)
            rows = packed[s][local]
            written += self.ckpt.save_delta(s, self._step, gkeys, rows) \
                * self.ckpt.replication
        self.prev = np.array(packed)
        self.bytes_replicated += written
        return written

    # ---- failure side ----------------------------------------------------
    def wipe(self, shard: int) -> None:
        self.ckpt.wipe_node(shard)

    def reseed(self, packed: np.ndarray) -> None:
        """Full re-replication barrier after a node replacement: every
        shard re-persists its current block at the chain's current step.
        The dead node's disk held replica copies of OTHER shards'
        baselines too — without re-seeding, a later restore (or
        speculation) of those shards would find holes in the ring."""
        for s in range(self.snapshot.num_shards):
            self.ckpt.save_full(s, self._step, {"mut": packed[s]})
        self.bytes_baseline += packed.nbytes * self.ckpt.replication
        self.prev = np.array(packed)

    def restore_shard(self, shard: int,
                      exclude_self: bool = False) -> np.ndarray:
        """Rebuild one shard's mutable block from replica checkpoints ONLY
        (baseline + in-order changed-entry replay)."""
        block = self.prev.shape[1] if self.prev is not None \
            else self.snapshot.block_size
        like = {"mut": np.zeros((block, self.payload_width), np.float32)}
        tree, base_step = self.ckpt.load_full(
            shard, like, from_replica=True, exclude_self=exclude_self)
        out = np.array(tree["mut"], np.float32)
        # merge_sources: after a wipe + partial re-write of the shard's
        # own directory, the complete history is the UNION of its own
        # post-recovery entries and the replicas' older ones.
        for _, keys, payload in self.ckpt.replay_deltas(
                shard, since_step=base_step, from_replica=True,
                exclude_self=exclude_self, merge_sources=True):
            local = self.snapshot.local_index(
                torch.from_numpy(np.asarray(keys, np.int32))).numpy()
            out[local] = payload
        return out

    # ---- elastic side ----------------------------------------------------
    def migrate(self, new_snapshot: PartitionSnapshot,
                new_init_packed: np.ndarray,
                current_packed: np.ndarray) -> DeltaBuffer:
        """Fresh snapshot taken (rescale): open a new epoch whose baseline
        is the REMAPPED initial state, and re-route the old chain's
        in-flight buffers through ``combine_route`` under the new
        snapshot so each new owner's chain starts with exactly the
        changed entries of the keys it now owns."""
        entries = []
        for s in range(self.snapshot.num_shards):
            for step, keys, payload in self.ckpt.replay_deltas(
                    s, since_step=0, from_replica=True,
                    merge_sources=True):
                entries.append((step, keys, payload))
        entries.sort(key=lambda t: t[0])          # chronological per key
        routed = migrate_route_buffers(
            new_snapshot, [(k, p) for _, k, p in entries],
            self.payload_width)
        self.open_epoch(new_snapshot)
        self.baseline(new_init_packed)
        if int(routed.count) > 0:
            self._step = 1
            seg = new_snapshot.block_size
            keys = routed.keys.numpy()
            payload = routed.payload.numpy()
            for s in range(new_snapshot.num_shards):
                k = keys[s * seg:(s + 1) * seg]
                p = payload[s * seg:(s + 1) * seg]
                live = k != int(PAD_KEY)
                if not live.any():
                    continue
                self.bytes_replicated += self.ckpt.save_delta(
                    s, 1, k[live].astype(np.int32), p[live]) \
                    * self.ckpt.replication
        self.prev = np.array(current_packed)
        return routed


@dataclasses.dataclass
class FaultPlan:
    """Deterministic single-fault/elasticity plan for one resilient run.

    ``fail_at``/``rescale_at`` are stratum indices: the event fires at the
    START of that stratum (after stratum ``k−1``'s replica persistence —
    the paper's punctuation barrier includes replication).  Both may be
    set; ``failed_shard`` is interpreted under the snapshot current at
    failure time.  ``strategy`` picks the Fig 12 recovery mode.

    This is the one-fault-per-run legacy interface; compound runs
    (repeated failures, correlated replica loss, failure during
    recovery/rescale, stragglers) use :class:`FaultSchedule` — a
    FaultPlan converts losslessly via :meth:`to_schedule`.
    """

    fail_at: Optional[int] = None
    failed_shard: int = 0
    strategy: str = "incremental"        # "incremental" | "restart"
    rescale_at: Optional[int] = None
    new_num_shards: Optional[int] = None

    def __post_init__(self):
        if self.strategy not in ("incremental", "restart"):
            raise ValueError(
                f"FaultPlan.strategy must be 'incremental' or 'restart', "
                f"got {self.strategy!r}")
        if (self.rescale_at is not None) != (self.new_num_shards
                                             is not None):
            raise ValueError(
                "FaultPlan.rescale_at and FaultPlan.new_num_shards must "
                f"be set together, got rescale_at={self.rescale_at!r}, "
                f"new_num_shards={self.new_num_shards!r}")
        for field in ("fail_at", "rescale_at"):
            v = getattr(self, field)
            if v is not None and v < 0:
                raise ValueError(
                    f"FaultPlan.{field} must be a stratum index >= 0, "
                    f"got {v!r}")
        if self.failed_shard < 0:
            raise ValueError(
                f"FaultPlan.failed_shard must be >= 0, got "
                f"{self.failed_shard!r}")
        if self.new_num_shards is not None and self.new_num_shards < 1:
            raise ValueError(
                f"FaultPlan.new_num_shards must be >= 1, got "
                f"{self.new_num_shards!r}")
        if self.fail_at is not None and self.fail_at == self.rescale_at:
            raise ValueError(
                f"FaultPlan.fail_at and FaultPlan.rescale_at collide on "
                f"stratum {self.fail_at}: the firing order would be "
                "ambiguous — use FaultSchedule, whose event list order "
                "is the firing order, for compound same-stratum events")

    def to_schedule(self) -> "FaultSchedule":
        events = []
        if self.rescale_at is not None:
            events.append(FaultEvent(
                kind="rescale", at=self.rescale_at,
                new_num_shards=self.new_num_shards))
        if self.fail_at is not None:
            events.append(FaultEvent(kind="fail", at=self.fail_at,
                                     shard=self.failed_shard))
        events.sort(key=lambda e: e.at)
        return FaultSchedule(events=tuple(events), strategy=self.strategy)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted chaos event.

    ``at`` is the stratum at whose START the event fires (events sharing
    a stratum fire in schedule order).  Kinds:

      * ``"fail"``     — shard ``shard``'s node dies (disk wiped).  With
        ``correlated=True`` its first ring replica dies too — the
        compound loss that forces recovery to the surviving replica, or
        (when none survives) the restart fallback.  ``during`` places
        the failure relative to ongoing control flow: ``"stratum"``
        (default) at the stratum barrier, ``"recovery"`` while an
        earlier failure's recovery is in flight (recovery must be
        re-entrant), ``"rescale"`` in the middle of an elastic rescale's
        migration (fires under the NEW snapshot).
      * ``"rescale"``  — elastic re-snapshot to ``new_num_shards``.
      * ``"straggle"`` — transient straggler: shard ``shard``'s measured
        latency for that stratum is multiplied by ``slowdown`` (feeds
        the SpeculationPolicy; never changes results).
    """

    kind: str
    at: int
    shard: int = 0
    correlated: bool = False
    during: str = "stratum"       # "stratum" | "recovery" | "rescale"
    new_num_shards: Optional[int] = None
    slowdown: float = 0.0

    def __post_init__(self):
        if self.kind not in ("fail", "rescale", "straggle"):
            raise ValueError(
                f"FaultEvent.kind must be 'fail', 'rescale' or "
                f"'straggle', got {self.kind!r}")
        if self.at < 0:
            raise ValueError(
                f"FaultEvent.at must be a stratum index >= 0, got "
                f"{self.at!r}")
        if self.shard < 0:
            raise ValueError(
                f"FaultEvent.shard must be >= 0, got {self.shard!r}")
        if self.during not in ("stratum", "recovery", "rescale"):
            raise ValueError(
                f"FaultEvent.during must be 'stratum', 'recovery' or "
                f"'rescale', got {self.during!r}")
        if self.kind == "rescale":
            if self.new_num_shards is None or self.new_num_shards < 1:
                raise ValueError(
                    f"FaultEvent(kind='rescale') needs new_num_shards "
                    f">= 1, got {self.new_num_shards!r}")
            if self.during != "stratum":
                raise ValueError(
                    "FaultEvent(kind='rescale') only supports "
                    f"during='stratum', got {self.during!r}")
        if self.kind != "rescale" and self.new_num_shards is not None:
            raise ValueError(
                f"FaultEvent.new_num_shards only applies to "
                f"kind='rescale', got kind={self.kind!r} with "
                f"new_num_shards={self.new_num_shards!r}")
        if self.kind == "straggle":
            if self.slowdown <= 1.0:
                raise ValueError(
                    f"FaultEvent(kind='straggle') needs slowdown > 1.0, "
                    f"got {self.slowdown!r}")
            if self.during != "stratum":
                raise ValueError(
                    "FaultEvent(kind='straggle') only supports "
                    f"during='stratum', got {self.during!r}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Ordered multi-event chaos schedule for one resilient run.

    Events must be ordered by ``at`` (non-decreasing); events sharing a
    stratum fire in list order, which makes compound scenarios explicit
    where FaultPlan would be ambiguous: ``[rescale@k, fail@k]`` is a
    failure immediately after the rescale (under the new snapshot).
    Every event fires at most once — after a restart the run re-passes
    earlier strata without re-firing spent events.
    """

    events: tuple = ()
    strategy: str = "incremental"        # "incremental" | "restart"

    def __post_init__(self):
        if self.strategy not in ("incremental", "restart"):
            raise ValueError(
                f"FaultSchedule.strategy must be 'incremental' or "
                f"'restart', got {self.strategy!r}")
        object.__setattr__(self, "events", tuple(self.events))
        for i, ev in enumerate(self.events):
            if not isinstance(ev, FaultEvent):
                raise ValueError(
                    f"FaultSchedule.events[{i}] must be a FaultEvent, "
                    f"got {ev!r}")
            if i and ev.at < self.events[i - 1].at:
                raise ValueError(
                    f"FaultSchedule.events must be ordered by 'at' "
                    f"(non-decreasing): events[{i}].at={ev.at} < "
                    f"events[{i - 1}].at={self.events[i - 1].at}")
            if ev.during == "recovery" and not any(
                    e.kind == "fail" and e.during != "recovery"
                    and e.at <= ev.at for e in self.events[:i]):
                raise ValueError(
                    f"FaultSchedule.events[{i}] has during='recovery' "
                    f"(at={ev.at}) but no earlier fail event triggers a "
                    "recovery for it to interrupt")
            if ev.during == "rescale" and not any(
                    e.kind == "rescale" and e.at == ev.at
                    for e in self.events[:i]):
                raise ValueError(
                    f"FaultSchedule.events[{i}] has during='rescale' "
                    f"(at={ev.at}) but no rescale event at that stratum "
                    "precedes it")

    @property
    def fail_count(self) -> int:
        return sum(1 for e in self.events if e.kind == "fail")

    @property
    def has_straggles(self) -> bool:
        return any(e.kind == "straggle" for e in self.events)


def as_schedule(plan) -> FaultSchedule:
    """Accept FaultPlan | FaultSchedule | None uniformly."""
    if plan is None:
        return FaultSchedule()
    if isinstance(plan, FaultSchedule):
        return plan
    if isinstance(plan, FaultPlan):
        return plan.to_schedule()
    raise ValueError(
        f"fault_plan must be a FaultPlan or FaultSchedule, got "
        f"{type(plan).__name__}")


@dataclasses.dataclass
class ResilientResult:
    """``result`` matches ``ShardedExecutor.run``'s FixpointResult (state +
    per-stratum stats of the surviving pass); ``metrics`` carries the
    Fig 12 accounting and every recovery/elastic/speculation event."""

    result: FixpointResult
    metrics: dict


class ResilientDriver:
    """Stratum-sliced fault-tolerant elastic fixpoint over the real engine.

    Uses ``executor.make_stratum_fn`` — the SAME laddered,
    route-strategy-dispatching stratum body ``run`` loops over — so a
    failure-free resilient run equals ``executor.run``, stratum for
    stratum (bit for bit where the strata are deterministic: on the CPU,
    and for min/max on the card).

    On an executor of ``backend="shard_map"`` every rank runs this driver
    over the global state that ``make_stratum_fn`` all-gathers, so every
    rank takes the same steps; the one input that differs between ranks,
    the wall clock, reaches the driver's decisions only through
    :meth:`_observe_straggler`, which takes rank 0's latencies and
    timeout flags (``mesh.broadcast_object``; the identity on the
    simulated backend's one-rank mesh).
    """

    def __init__(self, executor, algo, state0, live0, immutable,
                 max_iters: int, mode: str = "delta",
                 explicit_cond: Optional[Callable] = None, *,
                 ckpt_root: str,
                 fault_plan=None,
                 policy: Optional[SpeculationPolicy] = None,
                 latency_model: Optional[Callable] = None,
                 remake: Optional[Callable] = None,
                 pack: Callable = pack_state,
                 unpack: Callable = unpack_state,
                 retry: Optional[RetryPolicy] = None,
                 budget: Optional[RetryBudget] = None,
                 tracer=None, metrics=None):
        self.executor = executor
        self.algo = algo
        self.immutable = immutable
        self.max_iters = int(max_iters)
        self.mode = mode
        self.explicit_cond = explicit_cond
        # ``fault_plan`` accepts the legacy single-fault FaultPlan or a
        # multi-event FaultSchedule; internally everything runs off the
        # schedule (events fire at most once, in order).
        self.schedule = as_schedule(fault_plan)
        self._pending = list(self.schedule.events)
        self.remake = remake
        self.latency_model = latency_model
        # Observability: the driver shares the executor's tracer unless
        # given its own; per-stratum wall clocks are ALWAYS measured
        # (host perf_counter around each stratum slice) — they are the
        # measured latency feed for SpeculationPolicy when no synthetic
        # latency_model is supplied.
        self.tracer = tracer if tracer is not None \
            else getattr(executor, "tracer", None)
        self.metrics = metrics
        self.measured = MeasuredLatencies()
        self.stratum_walls: list[float] = []
        self._pack, self._unpack = pack, unpack
        self.snapshot = executor.snapshot
        self.stratum_fn = executor.make_stratum_fn(
            algo, immutable, mode, explicit_cond=explicit_cond)
        self.mesh = executor._mesh(immutable)
        self.state = state0
        self.live = int(live0)
        self.live0 = int(live0)
        self._init_packed = pack(state0)
        self.replicate = self.schedule.strategy == "incremental"
        self.stratum = 0
        self.outcomes: list[StratumOutcome] = []
        self.work_units = 0
        self.strata_executed = 0
        self.events: list[dict] = []
        # Retry/timeout/backoff for every recovery-path disk touch.  The
        # budget (when given) is the run's hard recovery allowance:
        # exhausting it raises RecoveryExhausted, the signal the view
        # layer converts into a staleness-tagged degraded answer.
        self.budget = budget
        self.retrier = Retrier(policy=retry or RetryPolicy(),
                               budget=budget,
                               on_event=self._on_retry_event)
        self.chain = ReplicaChain(ckpt_root, self.snapshot,
                                  self._init_packed.shape[-1],
                                  retrier=self.retrier)
        self.policy = policy
        # Straggler mitigation activates for an explicit policy, a
        # synthetic latency model, or a schedule injecting stragglers
        # (chaos runs get the default policy so injected stragglers
        # actually exercise speculation).
        want_mitigator = (policy is not None or latency_model is not None
                          or self.schedule.has_straggles)
        self.mitigator = (StragglerMitigator(
            self.snapshot.num_shards, policy,
            replicas_of=self.snapshot.replicas_of)
            if want_mitigator else None)
        # Armed transient-straggler injections: stratum -> [(shard, x)].
        self._straggles: dict[int, list] = {}
        # Re-entrant recovery: failures arriving while recovery is in
        # flight join the queue instead of recursing.
        self._recovery_queue: list[int] = []
        self._recovering = False
        self.recoveries = 0
        self.restarts = 0
        # Wall spent inside _recover (restore + replay + reseed): the
        # "recovery work" a failure costs, comparable across the
        # simulated and distributed drivers (same code path).
        self.recovery_wall_s = 0.0

    # ---- helpers ---------------------------------------------------------
    def _packed(self) -> np.ndarray:
        return self._pack(self.state)

    def done(self) -> bool:
        return self.live <= 0

    def _event(self, ev: dict) -> None:
        """Record a recovery/elastic event everywhere at once: the
        metrics dict the caller gets back, the tracer timeline, and the
        metrics registry counters."""
        self.events.append(ev)
        if self.tracer is not None:
            self.tracer.instant(ev["event"],
                                **{k: v for k, v in ev.items()
                                   if k != "event"})
        if self.metrics is not None:
            self.metrics.counter(f"recovery.{ev['event']}s").inc()

    # ---- retry / timeout observability ----------------------------------
    def _on_retry_event(self, ev: dict) -> None:
        """Every retry/timeout on the checkpoint I/O path lands in the
        run's event stream, and a TIMEOUT on a shard's replica read is a
        straggler signal: it feeds the SpeculationPolicy so the next
        barrier speculates that shard exactly as a slow stratum would."""
        self._event({"event": f"io_{ev['kind']}",
                     **{k: v for k, v in ev.items() if k != "kind"}})
        if ev["kind"] == "timeout" and ev.get("shard") is not None \
                and self.mitigator is not None:
            self.mitigator.note_timeout(ev["shard"])

    # ---- fault handling --------------------------------------------------
    def _fire_events(self) -> bool:
        """Fire every pending start-of-stratum event for the current
        stratum, in schedule order.  Returns True when handling ended in
        a restart (the caller re-enters the loop from stratum 0)."""
        while self._pending and self._pending[0].at == self.stratum:
            if self._pending[0].during != "stratum":
                # A during='recovery' event whose anchoring recovery
                # never reached it (the anchor fell back to restart, or
                # recovered before this stratum): the interrupt window
                # is gone — fire it as an ordinary barrier failure so
                # the schedule still injects every fault exactly once.
                # (during='rescale' events are always consumed by their
                # same-stratum rescale, which precedes them in order.)
                ev = self._pending.pop(0)
                if self._do_fail(ev):
                    return True
                continue
            ev = self._pending.pop(0)
            if ev.kind == "rescale":
                self._do_rescale(ev)
                if self.done():
                    return False
            elif ev.kind == "straggle":
                self._straggles.setdefault(ev.at, []).append(
                    (ev.shard, ev.slowdown))
                self._event({"event": "straggle_injected",
                             "stratum": ev.at, "shard": ev.shard,
                             "slowdown": ev.slowdown})
            else:
                if self._do_fail(ev):
                    return True
        return False

    def _pop_nested(self, during: str) -> list:
        """Pending ``during='recovery'|'rescale'`` events that are due
        (their stratum reached) — fired from inside the handler they
        interrupt."""
        due, rest = [], []
        for ev in self._pending:
            if ev.during == during and ev.at <= self.stratum:
                due.append(ev)
            else:
                rest.append(ev)
        self._pending = rest
        return due

    def _wipe_for(self, ev) -> list[int]:
        """Wipe the event's shard (and, for a correlated failure, its
        first ring replica) — returns the dead shards."""
        dead = [ev.shard]
        if ev.correlated:
            reps = self.snapshot.replicas_of(ev.shard)
            if reps:
                dead.append(reps[0])
        for s in dead:
            self.chain.wipe(s)                   # node dies; disk gone
        self._event({"event": "failure", "stratum": self.stratum,
                     "shard": ev.shard, "correlated": ev.correlated,
                     "during": ev.during,
                     "strategy": self.schedule.strategy})
        return dead

    def _do_fail(self, ev) -> bool:
        """Returns True when the run restarted (skip this stratum's body
        and re-enter the loop from stratum 0)."""
        dead = self._wipe_for(ev)
        if self.schedule.strategy == "restart":
            self._restart()
            return True
        return self._recover(dead)

    def _restart(self) -> None:
        """Fig 12 restart: discard everything, re-enter from stratum 0.
        Also the fallback when replicas are insufficient to rebuild a
        shard (correlated loss beyond the replication factor)."""
        if self.budget is not None:
            self.budget.draw_recovery("restart")
        self.restarts += 1
        self._event({"event": "restart", "stratum": self.stratum})
        self.state = self._unpack(self.state, self._init_packed)
        self.live = int(self.executor.live_count(
            self.algo, self.state, self.immutable)) or self.live0
        self.stratum = 0
        self.outcomes = []           # stats describe the surviving pass
        self._recovery_queue.clear()
        self.chain.open_epoch()
        if self.replicate:
            self.chain.baseline(self._init_packed)

    def _recover(self, shards: list[int]) -> bool:
        """Queue-driven incremental recovery; RE-ENTRANT: failures that
        strike while recovery is in flight (scheduled ``during=
        'recovery'`` events, or real wipe races surfacing as retryable
        I/O errors) join the queue and are drained in turn.  Returns
        True when recovery fell back to a restart."""
        self._recovery_queue.extend(shards)
        if self._recovering:
            return False              # nested call: the outer loop drains
        self._recovering = True
        t_rec = time.perf_counter()
        try:
            first = True
            while self._recovery_queue:
                shard = self._recovery_queue.pop(0)
                if self.budget is not None:
                    self.budget.draw_recovery(f"restore shard {shard}")
                self.recoveries += 1
                try:
                    restored = self.retrier.call(
                        self.chain.restore_shard, shard,
                        op=f"restore:{shard}", shard=shard,
                        retryable=IO_RETRYABLE)
                except RecoveryExhausted as e:
                    if e.kind.startswith("budget:"):
                        raise          # run-wide budget gone: degrade
                    return self._recovery_fallback(shard, e)
                except (FileNotFoundError, CheckpointCorruption) as e:
                    # Replicas insufficient (correlated loss beyond the
                    # replication factor) or every copy corrupt: fall
                    # back — older epoch via restart-from-initial.
                    return self._recovery_fallback(shard, e)
                packed = self._packed()
                packed[shard] = restored
                self.state = self._unpack(self.state, packed)
                self.chain.prev = packed
                self._event({"event": "recovery", "stratum": self.stratum,
                             "shard": shard})
                if first:
                    first = False
                    # Mid-recovery failures scheduled for this stratum
                    # strike NOW — while the recovery that the first
                    # restore started is still in flight.
                    for ev in self._pop_nested("recovery"):
                        self._recovery_queue.extend(self._wipe_for(ev))
            # Replacement nodes are live again: re-seed full replication
            # so the ring has no holes where the dead nodes' disks held
            # OTHER shards' replica copies.
            self.chain.reseed(self._packed())
            # Resume warm: Δ₀ of the restored state re-derived from
            # active_fn, execution continues from the CURRENT stratum.
            self.live = int(self.executor.live_count(
                self.algo, self.state, self.immutable))
            return False
        finally:
            self._recovering = False
            self.recovery_wall_s += time.perf_counter() - t_rec

    def _recovery_fallback(self, shard: int, err: Exception) -> bool:
        """Incremental restore impossible for ``shard`` — restart from
        the initial state (always reachable: the driver re-baselines a
        fresh epoch), keeping the run recoverable at restart cost."""
        self._event({"event": "recovery_fallback", "stratum": self.stratum,
                     "shard": shard, "reason": type(err).__name__,
                     "detail": str(err)[:200]})
        self._restart()
        return True

    def _do_rescale(self, ev) -> None:
        if self.remake is None:
            raise ValueError(
                "rescale requires remake(new_snapshot) -> (executor, "
                "algo, immutable)")
        if ev.new_num_shards % self.mesh.world:
            raise ValueError(
                f"a rescale to {ev.new_num_shards} shards does not split "
                f"over the {self.mesh.world} ranks of the shard_map group")
        new_snap = self.snapshot.resnapshot(ev.new_num_shards)
        new_exec, new_algo, new_imm = self.remake(new_snap)
        if new_exec.snapshot != new_snap:
            raise ValueError("remake returned an executor with a "
                             "mismatched snapshot")
        # Dense state migration — the all_to_all a real cluster would run.
        packed = self._packed()
        new_packed = remap_state(self.snapshot, new_snap,
                                 torch.from_numpy(packed)).numpy()
        new_init = remap_state(self.snapshot, new_snap,
                               torch.from_numpy(self._init_packed)).numpy()
        self.state = self._unpack(self.state, new_packed)
        self._init_packed = new_init
        if self.replicate:
            self.chain.migrate(new_snap, new_init, new_packed)
        self._event({"event": "rescale", "stratum": self.stratum,
                     "from_shards": self.snapshot.num_shards,
                     "to_shards": new_snap.num_shards})
        self.snapshot = new_snap
        self.executor = new_exec
        self.algo = new_algo           # capacities are snapshot-bound
        self.immutable = new_imm
        self.stratum_fn = new_exec.make_stratum_fn(
            self.algo, new_imm, self.mode,
            explicit_cond=self.explicit_cond)
        self.mesh = new_exec._mesh(new_imm)
        if self.mitigator is not None:
            self.mitigator = StragglerMitigator(
                new_snap.num_shards, self.policy,
                replicas_of=new_snap.replicas_of)
        self.live = int(new_exec.live_count(
            self.algo, self.state, self.immutable))
        # Failure-during-rescale: scheduled mid-rescale failures strike
        # under the NEW snapshot, with the migrated chain barely landed —
        # recovery must rebuild from the just-migrated epoch.
        for fev in self._pop_nested("rescale"):
            self._do_fail(fev)

    # ---- straggler speculation ------------------------------------------
    def _observe_straggler(self) -> None:
        # Speculation re-issues work against a shard's REPLICA — without
        # a replica chain (restart strategy, replication < 2, single
        # shard) there is nothing to re-issue against, so no speculation
        # or saved-time credit is recorded at all.
        if not self.replicate or self.snapshot.num_shards < 2 \
                or self.snapshot.replication < 2:
            return
        if self.latency_model is not None:
            latencies = list(self.latency_model(self.stratum - 1))
            if len(latencies) != self.snapshot.num_shards:
                raise ValueError(
                    f"latency_model returned {len(latencies)} latencies "
                    f"for {self.snapshot.num_shards} shards — after a "
                    "rescale it must track the new shard count")
        else:
            # Measured feed: the per-shard wall clocks this driver just
            # recorded for the completed stratum (every shard gets the
            # stratum's wall: the shards share one device).  The newest
            # entry: after a restart the stratum index no longer counts
            # the entries, and an older one may be of another shard count.
            latencies = list(self.measured.latencies[-1])
        # Rank 0's clock decides for every rank: its latencies, and its
        # timeout flags (a slow replica read), so speculation runs alike
        # on every rank of a shard_map group.
        latencies, self.mitigator.timeouts = self.mesh.broadcast_object(
            (latencies, self.mitigator.timeouts))
        # Armed transient-straggler injections (chaos schedule): inflate
        # the affected shard's measured latency for exactly this stratum
        # — the policy sees a real outlier, speculates, verifies; results
        # never change (the paper's straggler story is latency-only).
        for shard, slowdown in self._straggles.pop(self.stratum - 1, []):
            if shard < len(latencies):
                latencies[shard] *= slowdown
        report = self.mitigator.observe_stratum(latencies)
        if not report["speculations"]:
            return
        packed = self._packed()
        for decision in report["speculations"]:
            s = decision["shard"]
            # The replica chain is what makes speculation cheap (§4.1):
            # the replica rebuilds the slow shard's mutable state WITHOUT
            # the slow node's disk and must reach a bit-identical block.
            try:
                rebuilt = self.chain.restore_shard(s, exclude_self=True)
            except (FileNotFoundError, CheckpointCorruption) as e:
                # Replica hole (e.g. chaos wiped the ring neighbors):
                # speculation is impossible for this shard, not fatal —
                # the original (slow) shard's result stands.
                self._event({"event": "speculation_unavailable",
                             "stratum": self.stratum - 1, "shard": s,
                             "reason": type(e).__name__})
                continue
            ok = bool(np.array_equal(rebuilt, packed[s], equal_nan=True))
            self.mitigator.record_verification(s, ok, self.stratum - 1)
            self._event({"event": "speculation", "stratum": self.stratum - 1,
                         "shard": s, "replica": decision["replica"],
                         "verified": ok})

    # ---- external (real) failure signals ---------------------------------
    def _external_events(self) -> bool:
        """Barrier hook for drivers that bridge REAL failure signals —
        process death, missed leases, late heartbeats — into this
        driver's recovery machinery (``launch/distributed.py``
        ``DistributedResilientDriver``).  Called once per punctuation
        barrier, after scheduled injections.
        Returns True when handling ended in a restart (the caller
        re-enters the loop from stratum 0).  The base driver has no
        external signal source."""
        return False

    # ---- main loop -------------------------------------------------------
    def step(self) -> StratumOutcome:
        S = self.snapshot.num_shards
        stratum = self.stratum
        if self.tracer is not None:
            self.tracer.mark_shards(S)
        t0 = time.perf_counter()
        new_state, outcome = self.stratum_fn(self.state, self.stratum)
        # One host read of the outcome (a device sync: the wall is real).
        outcome = StratumOutcome(*(v.item() if torch.is_tensor(v) else v
                                   for v in outcome))
        self.live = int(outcome.live_count)
        wall = time.perf_counter() - t0
        traced = getattr(self.executor, "tracer", None)
        if traced is not None:
            traced.resolve()
        self.state = new_state
        self.stratum += 1
        self.strata_executed += 1
        self.work_units += max(int(outcome.emitted), 1)
        self.outcomes.append(outcome)
        # Measured per-shard latency for this stratum: the tracer's span
        # when the executor's tracer saw it, the host stratum wall
        # otherwise (every shard gets the same: they share one device).
        self.stratum_walls.append(wall)
        if self.tracer is not None:
            per_shard = self.tracer.per_shard_latencies(stratum, S,
                                                        default=wall)
        else:
            per_shard = [wall] * S
        self.measured.observe(per_shard)
        if self.tracer is not None:
            self.tracer.instant("stratum_sliced", tid="driver",
                               stratum=stratum, wall_s=wall,
                               emitted=int(outcome.emitted),
                               tier=int(outcome.tier),
                               route=int(outcome.route),
                               live_after=self.live)
        if self.metrics is not None:
            self.metrics.histogram(
                "recovery.stratum_seconds").observe(wall)
        return outcome

    def run(self) -> ResilientResult:
        self.chain.open_epoch()
        if self.replicate:
            self.chain.baseline(self._packed())
        while not self.done() and self.stratum < self.max_iters:
            if self._fire_events():
                continue                           # restarted from zero
            if self._external_events():
                continue                           # restarted from zero
            if self.done():
                break
            self.step()
            if self.replicate:
                if self.tracer is not None:
                    with self.tracer.span("replicate", tid="driver",
                                          stratum=self.stratum - 1) as a:
                        a["bytes"] = self.chain.append(self._packed())
                else:
                    self.chain.append(self._packed())
            if self.mitigator is not None:
                self._observe_straggler()
        result = FixpointResult(
            state=self.state,
            stats=stats_from_outcomes(self.outcomes, self.max_iters))
        if self.metrics is not None:
            self.metrics.counter("recovery.bytes_replicated").inc(
                self.chain.bytes_replicated)
        metrics = {
            "strategy": self.schedule.strategy,
            "converged": self.done(),
            "strata_executed": self.strata_executed,
            "total_work_units": self.work_units,
            "bytes_replicated": self.chain.bytes_replicated,
            "bytes_baseline": self.chain.bytes_baseline,
            "events": self.events,
            "final_num_shards": self.snapshot.num_shards,
            "stratum_wall_s": list(self.stratum_walls),
            "faults_injected": self.schedule.fail_count,
            "recoveries": self.recoveries,
            "restarts": self.restarts,
            "recovery_wall_s": round(self.recovery_wall_s, 6),
            "io_retries": sum(1 for e in self.retrier.events
                              if e["kind"] == "retry"),
            "io_timeouts": sum(1 for e in self.retrier.events
                               if e["kind"] == "timeout"),
            "checkpoints_quarantined": self.chain.total_quarantined,
        }
        if self.budget is not None:
            metrics["budget"] = self.budget.snapshot()
        if self.mitigator is not None:
            metrics["speculations"] = self.mitigator.speculated
            metrics["speculation_verified"] = self.mitigator.verified
            metrics["speculation_saved_time"] = self.mitigator.saved_time
            metrics["latency_source"] = (
                "model" if self.latency_model is not None else "measured")
        return ResilientResult(result=result, metrics=metrics)
