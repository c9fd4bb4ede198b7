"""Materialized views and the ViewManager session layer.

A :class:`MaterializedView` keeps the converged ``FixpointResult`` state of
one standing query resident, absorbs sealed mutation batches through its
algorithm's repair rule, and re-enters the sharded fixpoint *warm*.  The
repair-vs-recompute decision is the paper's delta/dense duality lifted to
the update-to-update level: when the rule's estimated repair volume
(touched keys) exceeds ``fallback_threshold × key_count``, the view cold
recomputes instead — same answer, different cost model.

:class:`ViewManager` owns N concurrent views, routes mutation batches,
exposes ``refresh()``/``query()`` with result caching keyed by view
version, and (optionally) journals every batch durably through
``runtime/checkpoint.py`` so a restarted process resumes views from the
last base snapshot plus the replayed mutation journal.

Devices are explicit: a view's tensors live on ``device`` (None means
CUDA, and raises without it; the tests pass ``device="cpu"``).  Each
refresh also keeps the host seconds of its parts in ``view.last_split``
(``apply_batch``, ``build_sharded``, ``repair``, ``journal`` where a
manager journals, ``fixpoint``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.fixpoint import FixpointResult, empty_stats
from repro_torch.device import resolve_device
from repro_torch.incremental.mutations import (Mutation, MutationBatch,
                                               MutationLog)
from repro_torch.incremental.rules import get_rule
from repro_torch.incremental.stores import GraphStore, PointStore
from repro_torch.runtime.retry import RecoveryExhausted


@dataclasses.dataclass(frozen=True)
class RefreshReport:
    """What one refresh did: which path ran and what it cost."""

    view: str
    version: int
    mode: str                 # "cold" | "repair" | "noop" | "degraded"
    mutations: int
    touched_keys: int
    strata: int
    rehash_bytes: float
    wall_s: float


@dataclasses.dataclass(frozen=True)
class QueryAnswer:
    """A query result with explicit staleness metadata.

    ``version`` is the converged state actually served; when the view is
    degraded (a refresh exhausted its recovery budget) that lags
    ``latest_version`` — the base data's version including every sealed
    batch the served state does not yet reflect.  ``stale_batches`` is
    the gap in batches; ``reason`` carries the exhaustion kind (e.g.
    ``"budget:recoveries"``).  A fresh answer has ``degraded=False``,
    ``stale_batches=0``, ``reason=None``.
    """

    value: np.ndarray
    view: str
    version: int
    latest_version: int
    degraded: bool = False
    stale_batches: int = 0
    reason: Optional[str] = None


class MaterializedView:
    """One standing query: store + converged state + repair rule."""

    def __init__(self, name: str, algorithm: str,
                 store: GraphStore | PointStore,
                 params: Optional[dict] = None,
                 fallback_threshold: float = 0.15,
                 _restored: Optional[tuple] = None,
                 tracer=None, metrics=None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.store = store
        self.params = dict(params or {})
        self.fallback_threshold = float(fallback_threshold)
        self.rule = get_rule(algorithm)
        self.log = MutationLog()
        self.history: list[RefreshReport] = []
        self.last_batch: Optional[MutationBatch] = None
        self._cache: Optional[tuple[int, np.ndarray]] = None
        # Observability (optional): refresh spans land on the tracer's
        # "views" row, repair/cold latency and mutation counts in the
        # registry.  Both default to None — no overhead.
        self.tracer = tracer
        self.metrics = metrics
        # Executor-fault injection for the next refresh (consumed by the
        # rule's resilient resume when params carry a "resilient_root").
        # ``fault_plan`` accepts a FaultPlan or a FaultSchedule;
        # ``retry_policy``/``retry_budget`` bound the recovery work one
        # refresh may spend before the view DEGRADES: it keeps serving
        # the last converged state (staleness-tagged) instead of raising.
        self.fault_plan = None
        self.retry_policy = None
        self.retry_budget = None
        self.last_recovery: Optional[dict] = None
        # Degradation state: metadata of the refresh that exhausted its
        # budget, count of sealed batches the served state lags behind,
        # and the catch-up flag forcing the next refresh down the cold
        # path (a degraded refresh's repair plan is lost — only a cold
        # recompute from the mutated store is guaranteed correct).
        self.degraded: Optional[dict] = None
        self._stale_batches = 0
        self._needs_cold = False
        self.last_split: dict[str, float] = {}

        self.immutable = store.build_sharded(self.device)
        self.rule.bind(self)
        if _restored is None:
            t0 = time.perf_counter()
            self.version = 0
            self.state, res = self.rule.cold(self)
            self.last_result = res
            iters = int(res.stats.iterations)
            self._record(RefreshReport(
                view=name, version=0, mode="cold", mutations=0,
                touched_keys=self.key_count, strata=iters,
                rehash_bytes=_rehash_bytes(res, iters),
                wall_s=time.perf_counter() - t0))
        else:
            self.state, self.version = _restored
            self.last_result = None

    @property
    def key_count(self) -> int:
        """Size of the view's key space (fallback-policy denominator)."""
        return self.store.n if isinstance(self.store, GraphStore) \
            else self.store.capacity

    def _record(self, report: RefreshReport) -> RefreshReport:
        """Append to history and mirror the report into the tracer
        timeline ("views" row) and the metrics registry."""
        self.history.append(report)
        if self.tracer is not None:
            self.tracer._append({
                "name": f"{report.view}.{report.mode}", "ph": "X",
                "ts": self.tracer._now() - report.wall_s,
                "dur": report.wall_s, "tid": "views",
                "args": {"view": report.view, "mode": report.mode,
                         "version": report.version,
                         "mutations": report.mutations,
                         "touched_keys": report.touched_keys,
                         "strata": report.strata,
                         "rehash_bytes": report.rehash_bytes}})
        if self.metrics is not None:
            m = self.metrics
            m.counter(f"view.{report.mode}s").inc()
            m.counter("view.mutations_applied").inc(report.mutations)
            if report.mode != "noop":
                m.histogram("view.refresh_seconds").observe(report.wall_s)
                m.histogram("view.touched_keys").observe(
                    max(report.touched_keys, 0))
            if report.mode == "repair":
                # The headline number: end-to-end repair-pipeline latency
                # (seal + store apply + plan + warm fixpoint).
                m.histogram("view.repair_seconds").observe(report.wall_s)
        return report

    # ------------------------------------------------------------------
    def apply(self, *mutations: Mutation) -> int:
        """Queue mutations for the next refresh; returns first seq id."""
        return self.log.append(*mutations)

    def refresh(self, force: Optional[str] = None,
                on_sealed: Optional[callable] = None) -> RefreshReport:
        """Seal pending mutations and bring the view up to date.

        ``force``: None (policy decides), "repair", or "cold".
        ``on_sealed(batch, mode)`` fires after the batch is sealed and the
        refresh path is DECIDED but before the fixpoint runs — the
        ViewManager journals the batch there, so a crash (or executor
        failure) mid-repair loses no durably-accepted mutations: restore
        replays the journaled batch through the same decided path.
        """
        if force not in (None, "repair", "cold"):
            raise ValueError(force)
        t0 = time.perf_counter()
        if self.log.pending_count == 0:
            if self._needs_cold:
                # Degraded with no new mutations: a refresh is the
                # operator's catch-up request — cold recompute from the
                # (already-mutated) store restores freshness.
                return self._catch_up(t0)
            return self._record(RefreshReport(
                view=self.name, version=self.version, mode="noop",
                mutations=0, touched_keys=0, strata=0, rehash_bytes=0.0,
                wall_s=time.perf_counter() - t0))

        # Degraded batches were sealed (and applied to the store) past
        # ``version`` without being served — number monotonically after
        # them so journal steps never collide.
        batch = self.log.seal(self.version + 1 + self._stale_batches)
        self.last_batch = batch
        split = self.last_split = {}
        t = time.perf_counter()
        try:
            effect = self.store.apply_batch(batch.mutations)
        except Exception:
            # Stores apply atomically, so nothing took effect: put the
            # batch back so the caller can drop the bad mutation and
            # retry without losing the good ones.
            self.log.unseal(batch)
            self.last_batch = None
            raise
        split["apply_batch"], t = _lap(t)
        old_cap = getattr(self.store, "nnz_capacity", None)
        self.immutable = self.store.build_sharded(self.device)
        if old_cap is not None and self.store.nnz_capacity != old_cap:
            self.rule.rebind(self)      # capacity grew: new shapes
        split["build_sharded"], t = _lap(t)

        plan = None
        # A degraded view's lost repair plans make "cold" the only
        # correct catch-up: the store already holds every sealed batch.
        mode = "cold" if (force == "cold" or self._needs_cold) \
            else "repair"
        if mode == "repair":
            plan = self.rule.repair(self, effect, self.state)
            if (force != "repair"
                    and plan.touched_keys
                    > self.fallback_threshold * self.key_count):
                mode = "cold"
        split["repair"], t = _lap(t)
        if on_sealed is not None:
            on_sealed(batch, mode)
            split["journal"], t = _lap(t)
        try:
            if mode == "cold":
                self.state, res = self.rule.cold(self)
            elif plan.touched_keys == 0:
                # The batch left every derived value intact (e.g. a no-op
                # reweight): skip the fixpoint entirely, zero strata.
                self.state = plan.state
                res = FixpointResult(state=plan.state, stats=empty_stats(1))
            else:
                self.state, res = self.rule.resume(self, plan.state)
        except RecoveryExhausted as e:
            # Graceful degradation: the recovery budget ran out before
            # the refresh could converge.  ``self.state`` is untouched
            # (assignment happens only on success), so the view keeps
            # serving the LAST CONVERGED answer — now stale by this
            # batch — instead of raising to the caller.
            return self._degrade(batch, mode, e, t0)
        split["fixpoint"] = _lap(t)[0]

        self.version = batch.version
        self._cache = None
        self.last_result = res
        self.last_plan = plan
        if self.degraded is not None:
            self._mark_recovered()
        iters = int(res.stats.iterations)
        return self._record(RefreshReport(
            view=self.name, version=self.version, mode=mode,
            mutations=len(batch),
            touched_keys=(plan.touched_keys if plan is not None
                          else self.key_count),
            strata=iters,
            rehash_bytes=_rehash_bytes(res, iters),
            wall_s=time.perf_counter() - t0))

    # ---- degradation -----------------------------------------------------
    def _degrade(self, batch: MutationBatch, mode: str,
                 err: RecoveryExhausted, t0: float) -> RefreshReport:
        self._stale_batches += 1
        self._needs_cold = True
        self.degraded = {
            "reason": err.kind, "detail": str(err),
            "served_version": self.version,
            "missed_version": batch.version,
            "stale_batches": self._stale_batches,
        }
        if self.tracer is not None:
            self.tracer.instant("view_degraded", tid="views",
                                view=self.name, reason=err.kind,
                                served_version=self.version,
                                stale_batches=self._stale_batches)
        if self.metrics is not None:
            self.metrics.counter("view.degradations").inc()
            self.metrics.gauge(f"view.staleness.{self.name}").set(
                self._stale_batches)
        return self._record(RefreshReport(
            view=self.name, version=self.version, mode="degraded",
            mutations=len(batch), touched_keys=0, strata=0,
            rehash_bytes=0.0, wall_s=time.perf_counter() - t0))

    def _mark_recovered(self) -> None:
        """A refresh converged after degradation: freshness restored."""
        self.degraded = None
        self._stale_batches = 0
        self._needs_cold = False
        if self.tracer is not None:
            self.tracer.instant("view_recovered", tid="views",
                                view=self.name, version=self.version)
        if self.metrics is not None:
            self.metrics.gauge(f"view.staleness.{self.name}").set(0)

    def _catch_up(self, t0: float) -> RefreshReport:
        """Cold recompute with no new batch: absorb the degraded-era
        batches already sitting in the store."""
        self.state, res = self.rule.cold(self)
        self.version += self._stale_batches
        self._cache = None
        self.last_result = res
        self._mark_recovered()
        iters = int(res.stats.iterations)
        return self._record(RefreshReport(
            view=self.name, version=self.version, mode="cold",
            mutations=0, touched_keys=self.key_count, strata=iters,
            rehash_bytes=_rehash_bytes(res, iters),
            wall_s=time.perf_counter() - t0))

    def query(self) -> np.ndarray:
        """Current result, cached per view version."""
        if self._cache is None or self._cache[0] != self.version:
            self._cache = (self.version,
                           self.rule.extract(self, self.state))
        return self._cache[1]

    def answer(self) -> QueryAnswer:
        """:meth:`query` plus explicit staleness metadata — the serving
        contract under degradation: never raise, never serve corrupt
        data, always say how stale the answer is."""
        return QueryAnswer(
            value=self.query(), view=self.name, version=self.version,
            latest_version=self.version + self._stale_batches,
            degraded=self.degraded is not None,
            stale_batches=self._stale_batches,
            reason=(self.degraded or {}).get("reason"))


def _lap(t: float) -> tuple[float, float]:
    """(seconds since ``t``, now) on the host clock."""
    now = time.perf_counter()
    return now - t, now


def _rehash_bytes(res: FixpointResult, iters: int) -> float:
    """Bytes the run's rehash moved: its float32 column summed as numpy
    sums it."""
    return float(np.sum(res.stats.rehash_bytes[:iters].numpy()))


class ViewManager:
    """Session layer over N concurrent materialized views."""

    def __init__(self, journal_root: Optional[str] = None,
                 fallback_threshold: float = 0.15,
                 tracer=None, metrics=None):
        self.views: dict[str, MaterializedView] = {}
        self.fallback_threshold = fallback_threshold
        # Shared observability sinks for every view created here; the
        # manager also tracks per-view journal depth (sealed batches
        # since the last base snapshot — the replay a restore would do).
        self.tracer = tracer
        self.metrics = metrics
        self.journal_depth: dict[str, int] = {}
        if journal_root is not None:
            from repro_torch.incremental.journal import ViewJournal
            self.journal = ViewJournal(journal_root)
        else:
            self.journal = None

    def _set_depth(self, name: str, depth: int) -> None:
        self.journal_depth[name] = depth
        if self.metrics is not None:
            self.metrics.gauge(f"view.journal_depth.{name}").set(depth)

    # ---- creation --------------------------------------------------------
    def create_view(self, name: str, algorithm: str,
                    store: GraphStore | PointStore,
                    fallback_threshold: Optional[float] = None,
                    device=None, **params) -> MaterializedView:
        """A view of ``algorithm`` over ``store`` on ``device`` (None means
        CUDA, and raises without it)."""
        if name in self.views:
            raise KeyError(f"view {name!r} already exists")
        view = MaterializedView(
            name, algorithm, store, params=params,
            fallback_threshold=(self.fallback_threshold
                                if fallback_threshold is None
                                else fallback_threshold),
            tracer=self.tracer, metrics=self.metrics, device=device)
        self.views[name] = view
        self._set_depth(name, 0)
        if self.journal is not None:
            self.journal.register_view(view)
            self.journal.save_base(view)
        return view

    def create_graph_view(self, name: str, algorithm: str,
                          indptr: np.ndarray, indices: np.ndarray, n: int,
                          num_shards: int = 4, **kw) -> MaterializedView:
        store = GraphStore(indptr, indices, n, num_shards)
        return self.create_view(name, algorithm, store, **kw)

    def create_kmeans_view(self, name: str, points: np.ndarray, k: int,
                           num_shards: int = 4,
                           capacity: Optional[int] = None,
                           **kw) -> MaterializedView:
        store = PointStore(points, num_shards, capacity)
        return self.create_view(name, algorithm="kmeans", store=store,
                                k=k, **kw)

    # ---- routing ---------------------------------------------------------
    def __getitem__(self, name: str) -> MaterializedView:
        return self.views[name]

    def mutate(self, name: str, *mutations: Mutation) -> int:
        return self.views[name].apply(*mutations)

    def refresh(self, name: Optional[str] = None,
                force: Optional[str] = None) -> dict[str, RefreshReport]:
        """Refresh one view (or all); journals sealed batches durably.

        Batches are journaled BEFORE their fixpoint runs (via the view's
        ``on_sealed`` hook), so a crash or executor failure mid-repair
        never loses an accepted batch — ``restore`` replays it through
        the journaled path."""
        names = [name] if name is not None else list(self.views)
        reports = {}
        for nm in names:
            view = self.views[nm]

            def on_sealed(batch, mode, _view=view, _nm=nm):
                # Every sealed batch deepens the journal replay a restore
                # would perform — tracked whether or not a durable journal
                # is attached (the gauge is the replay-depth signal).
                self._set_depth(_nm, self.journal_depth.get(_nm, 0) + 1)
                if self.journal is not None:
                    self.journal.log_batch(_view, batch, mode=mode)

            reports[nm] = view.refresh(force=force, on_sealed=on_sealed)
        return reports

    def query(self, name: str, detail: bool = False):
        """Serve the view's answer; NEVER raises for a degraded view —
        the last converged snapshot is served instead.  With
        ``detail=True`` returns a :class:`QueryAnswer` carrying the
        staleness metadata (version served vs latest, batches behind,
        degradation reason); the default returns the bare array for
        backward compatibility."""
        view = self.views[name]
        return view.answer() if detail else view.query()

    def drop(self, name: str) -> None:
        del self.views[name]
        if self.journal is not None:
            self.journal.forget(name)    # else restore() resurrects it

    def checkpoint(self, name: Optional[str] = None) -> None:
        """Write fresh base snapshots, truncating each view's replay."""
        if self.journal is None:
            raise RuntimeError("manager has no journal attached")
        for nm in ([name] if name is not None else list(self.views)):
            self.journal.save_base(self.views[nm])
            self._set_depth(nm, 0)     # fresh base truncates the replay

    # ---- recovery --------------------------------------------------------
    @classmethod
    def restore(cls, journal_root: str, device=None) -> "ViewManager":
        """Rebuild every journaled view on ``device``: base snapshot +
        replayed batches."""
        from repro_torch.incremental.journal import ViewJournal
        mgr = cls(journal_root=None)
        journal = ViewJournal(journal_root)
        for name in journal.view_names():
            view, batches = journal.load_view(name, device=device)
            for batch, mode in batches:
                view.apply(*batch.mutations)
                view.refresh(force=mode)   # replay the journaled path
            mgr.views[name] = view
        mgr.journal = journal          # re-attach AFTER replay so the
        return mgr                     # replayed batches aren't re-logged
