"""The port's views under the runtime and observability layers, held
against the reference's: twins of the reference's view-layer tests
(``tests/test_resilient.py`` ``TestResilientViews``, ``tests/test_chaos.py``
``TestGracefulDegradation`` and ``tests/test_obs.py``
``TestViewObservability``), run on the CPU.

Each scenario runs once through ``repro_torch.incremental`` and once
through ``repro.incremental`` (simulated backend), from the same graph,
mutations, ``FaultPlan`` / ``FaultSchedule`` and ``RetryBudget``.  What
each run leaves is gathered into one record, and the two records must
agree: every ``RefreshReport`` but its wall clock, the ``query()`` values
(SSSP bit for bit, PageRank within 1 ulp, ROADMAP's float-add rule), the
``QueryAnswer`` fields, the ``degraded`` dict, ``last_recovery`` (every
event and work unit, not the wall clocks), the metric snapshots
(histograms by count) and the tracer's events (name, phase, row, args).
The reference tests' own assertions are kept on the port's record.
"""
import gc
import types

import numpy as np
import pytest

import jax

from repro.data.graphs import make_powerlaw_graph
from repro.incremental import EdgeInsert as JEdgeInsert
from repro.incremental import ViewManager as JViewManager
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Tracer as JTracer
from repro.runtime import FaultEvent as JFaultEvent
from repro.runtime import FaultPlan as JFaultPlan
from repro.runtime import FaultSchedule as JFaultSchedule
from repro.runtime.retry import RetryBudget as JRetryBudget

from repro_torch.incremental import EdgeInsert, ViewManager
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime import FaultEvent, FaultPlan, FaultSchedule
from repro_torch.runtime.retry import RetryBudget
from torch_threads import one_torch_thread  # noqa: F401

N, S = 256, 4
# Recovery metrics read off the host clock.
WALL_KEYS = {"stratum_wall_s", "recovery_wall_s", "speculation_saved_time"}

PORT = types.SimpleNamespace(
    name="port", ViewManager=ViewManager, EdgeInsert=EdgeInsert,
    FaultPlan=FaultPlan, FaultEvent=FaultEvent, FaultSchedule=FaultSchedule,
    RetryBudget=RetryBudget, Tracer=Tracer, MetricsRegistry=MetricsRegistry,
    view_kw={"device": "cpu"}, restore_kw={"device": "cpu"})
REF = types.SimpleNamespace(
    name="ref", ViewManager=JViewManager, EdgeInsert=JEdgeInsert,
    FaultPlan=JFaultPlan, FaultEvent=JFaultEvent,
    FaultSchedule=JFaultSchedule, RetryBudget=JRetryBudget, Tracer=JTracer,
    MetricsRegistry=JMetricsRegistry, view_kw={}, restore_kw={})


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


def pagerank_view(pkg, mgr, name, **params):
    indptr, indices = make_powerlaw_graph(N, avg_degree=6.0, seed=3)
    return mgr.create_graph_view(name, "pagerank", indptr, indices, N,
                                 num_shards=S, threshold=1e-4,
                                 **pkg.view_kw, **params)


def sssp_view(pkg, mgr):
    indptr, indices = make_powerlaw_graph(N, 4.0, seed=1)
    return mgr.create_graph_view("d", "sssp", indptr, indices, N,
                                 num_shards=S, source=0, **pkg.view_kw)


# ---------------------------------------------------------------------------
# What a run leaves, and the comparison of two such records.
# ---------------------------------------------------------------------------

def reports(view) -> list:
    return [{k: v for k, v in vars(r).items() if k != "wall_s"}
            for r in view.history]


def answer(mgr, name) -> dict:
    return vars(mgr.query(name, detail=True)).copy()


def recovery(view):
    if view.last_recovery is None:
        return None
    return {k: v for k, v in view.last_recovery.items()
            if k not in WALL_KEYS}


def metrics(reg) -> dict:
    """Counters and gauges by value, histograms (of seconds) by count."""
    return {k: (v["type"], v["count"] if v["type"] == "histogram"
                else v["value"])
            for k, v in reg.snapshot().items()}


def events(tracer) -> list:
    return [(e.get("name"), e.get("ph"), e.get("tid"), e.get("args"))
            for e in tracer.events]


def assert_agree(got, want, maxulp: int = 0, path: str = "record"):
    """``got`` (the port's record) equals ``want`` (the reference's):
    arrays bit for bit, or within ``maxulp`` where they are floats."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_agree(got[k], want[k], maxulp, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_agree(g, w, maxulp, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or hasattr(want, "__array__") \
            and not np.isscalar(want):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if maxulp and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_max_ulp(g, w, maxulp=maxulp)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, (path, got, want)


def both(scenario, tmp_path, maxulp: int = 0) -> dict:
    """Run ``scenario(pkg, root)`` through the port and the reference;
    their records must agree.  Returns the port's."""
    got = scenario(PORT, tmp_path / "port")
    want = scenario(REF, tmp_path / "ref")
    assert_agree(got, want, maxulp)
    return got


# ---------------------------------------------------------------------------
# Standing queries survive executor failure mid-repair.
# ---------------------------------------------------------------------------

class TestResilientViews:
    def test_view_survives_executor_failure_midrepair(self, tmp_path):
        def scenario(pkg, root):
            va = pagerank_view(pkg, pkg.ViewManager(), "va",
                               resilient_root=str(root / "chain_a"))
            vb = pagerank_view(pkg, pkg.ViewManager(), "vb",
                               resilient_root=str(root / "chain_b"))
            muts = [pkg.EdgeInsert(3, 9), pkg.EdgeInsert(70, 140),
                    pkg.EdgeInsert(10, 201)]
            va.apply(*muts)
            vb.apply(*muts)
            va.fault_plan = pkg.FaultPlan(fail_at=1, failed_shard=1)
            va.refresh(force="repair")
            vb.refresh(force="repair")
            return dict(reports_a=reports(va), reports_b=reports(vb),
                        plan_left=va.fault_plan,
                        recovery_a=recovery(va), recovery_b=recovery(vb),
                        query_a=va.query(), query_b=vb.query())

        rec = both(scenario, tmp_path, maxulp=1)
        assert rec["reports_a"][-1]["mode"] == "repair"
        assert rec["reports_b"][-1]["mode"] == "repair"
        assert rec["plan_left"] is None                # consumed
        assert any(e["event"] == "failure"
                   for e in rec["recovery_a"]["events"])
        assert not any(e["event"] == "failure"
                       for e in rec["recovery_b"]["events"])
        np.testing.assert_array_equal(rec["query_a"], rec["query_b"])

    def test_batch_journaled_before_fixpoint(self, tmp_path):
        """Crash mid-repair: the sealed batch is already durable, so
        restore() replays it through the decided path."""
        class Boom(RuntimeError):
            pass

        def scenario(pkg, root):
            mgr = pkg.ViewManager(journal_root=str(root / "journal"))
            view = pagerank_view(pkg, mgr, "pv")
            mgr.mutate("pv", pkg.EdgeInsert(5, 9))
            mgr.refresh("pv")
            baseline = mgr.query("pv")
            mgr.mutate("pv", pkg.EdgeInsert(80, 160))
            orig_resume = view.rule.resume
            view.rule.resume = lambda *a, **k: (_ for _ in ()).throw(Boom())
            with pytest.raises(Boom):
                mgr.refresh("pv")
            view.rule.resume = orig_resume

            restored = pkg.ViewManager.restore(str(root / "journal"),
                                               **pkg.restore_kw)
            tv = pagerank_view(pkg, pkg.ViewManager(), "tv")
            tv.apply(pkg.EdgeInsert(5, 9))
            tv.refresh()
            tv.apply(pkg.EdgeInsert(80, 160))
            tv.refresh(force="repair")
            return dict(baseline=baseline, crashed=reports(view),
                        restored=reports(restored.views["pv"]),
                        answer=answer(restored, "pv"),
                        twin=reports(tv), twin_query=tv.query())

        rec = both(scenario, tmp_path, maxulp=1)
        got = rec["answer"]["value"]
        assert got.shape == rec["baseline"].shape
        assert rec["answer"]["version"] == 2       # includes the crashed batch
        np.testing.assert_array_equal(got, rec["twin_query"])
        # the reference's journal restores in the port to the same view
        cross = ViewManager.restore(str(tmp_path / "ref" / "journal"),
                                    device="cpu")
        assert_agree(answer(cross, "pv"), rec["answer"])


# ---------------------------------------------------------------------------
# Unrecoverable schedules degrade: never raise, never corrupt.
# ---------------------------------------------------------------------------

def exhaust(pkg, view):
    """Arm the next refresh with a failure and no recoveries to spend."""
    view.fault_plan = pkg.FaultSchedule(events=(
        pkg.FaultEvent(kind="fail", at=0, shard=1),))
    view.retry_budget = pkg.RetryBudget(max_recoveries=0)


class TestGracefulDegradation:
    def test_budget_exhaustion_serves_stale_tagged_answer(self, tmp_path):
        def scenario(pkg, root):
            mgr = pkg.ViewManager()
            view = sssp_view(pkg, mgr)
            fresh = answer(mgr, "d")
            exhaust(pkg, view)
            mgr.mutate("d", pkg.EdgeInsert(0, 200))
            report = mgr.refresh("d")["d"]           # must NOT raise
            return dict(fresh=fresh, mode=report.mode,
                        plan_left=view.fault_plan, degraded=view.degraded,
                        answer=answer(mgr, "d"),     # must NOT raise
                        bare=mgr.query("d"), reports=reports(view),
                        recovery=recovery(view))

        rec = both(scenario, tmp_path)
        fresh, ans = rec["fresh"], rec["answer"]
        assert not fresh["degraded"] and fresh["stale_batches"] == 0
        assert rec["mode"] == "degraded"
        assert rec["plan_left"] is None              # consumed on failure too
        assert ans["degraded"]
        assert ans["stale_batches"] == 1
        assert ans["reason"] == "budget:recoveries"
        assert ans["version"] == 0 and ans["latest_version"] == 1
        assert rec["degraded"]["reason"] == "budget:recoveries"
        assert rec["degraded"]["missed_version"] == 1
        np.testing.assert_array_equal(ans["value"], fresh["value"])
        np.testing.assert_array_equal(rec["bare"], fresh["value"])

    def test_catchup_restores_freshness_and_correctness(self, tmp_path):
        def scenario(pkg, root):
            mgr = pkg.ViewManager()
            view = sssp_view(pkg, mgr)
            exhaust(pkg, view)
            mgr.mutate("d", pkg.EdgeInsert(0, 200))
            degraded_mode = mgr.refresh("d")["d"].mode
            view.retry_budget = None                 # operator restored it
            report = mgr.refresh("d")["d"]
            mgr2 = pkg.ViewManager()
            view2 = sssp_view(pkg, mgr2)
            view2.apply(pkg.EdgeInsert(0, 200))
            view2.refresh()
            return dict(degraded_mode=degraded_mode, mode=report.mode,
                        degraded=view.degraded, reports=reports(view),
                        answer=answer(mgr, "d"), twin=mgr2.query("d"))

        rec = both(scenario, tmp_path)
        ans = rec["answer"]
        assert rec["degraded_mode"] == "degraded"
        assert rec["mode"] == "cold"                 # lost plan => cold only
        assert rec["degraded"] is None
        assert not ans["degraded"] and ans["stale_batches"] == 0
        assert ans["version"] == 1
        np.testing.assert_array_equal(rec["twin"], ans["value"])

    def test_degradation_emits_observability_events(self, tmp_path):
        def scenario(pkg, root):
            tracer, reg = pkg.Tracer(), pkg.MetricsRegistry()
            mgr = pkg.ViewManager(tracer=tracer, metrics=reg)
            view = sssp_view(pkg, mgr)
            exhaust(pkg, view)
            mgr.mutate("d", pkg.EdgeInsert(0, 200))
            mgr.refresh("d")
            after_degrade = dict(metrics=metrics(reg),
                                 events=events(tracer))
            mgr.refresh("d", force="cold")
            return dict(after_degrade=after_degrade, metrics=metrics(reg),
                        events=events(tracer), answer=answer(mgr, "d"))

        rec = both(scenario, tmp_path)
        first = rec["after_degrade"]
        assert first["metrics"]["view.degradations"] == ("counter", 1)
        assert first["metrics"]["view.staleness.d"] == ("gauge", 1)
        assert "view_degraded" in [e[0] for e in first["events"]]
        assert rec["metrics"]["view.staleness.d"] == ("gauge", 0)
        assert "view_recovered" in [e[0] for e in rec["events"]]


# ---------------------------------------------------------------------------
# View instrumentation.
# ---------------------------------------------------------------------------

class TestViewObservability:
    def test_refresh_metrics_and_journal_depth(self, tmp_path):
        def scenario(pkg, root):
            tr, reg = pkg.Tracer("views"), pkg.MetricsRegistry()
            mgr = pkg.ViewManager(tracer=tr, metrics=reg)
            pagerank_view(pkg, mgr, "pv")
            mgr.mutate("pv", pkg.EdgeInsert(3, 9))
            mode = mgr.refresh("pv")["pv"].mode
            mgr.refresh("pv")                        # noop
            mgr2 = pkg.ViewManager()                 # untraced twin
            pagerank_view(pkg, mgr2, "pv")
            mgr2.mutate("pv", pkg.EdgeInsert(3, 9))
            mgr2.refresh("pv")
            return dict(mode=mode, metrics=metrics(reg), events=events(tr),
                        reports=reports(mgr.views["pv"]),
                        query=mgr.query("pv"), twin=mgr2.query("pv"))

        rec = both(scenario, tmp_path, maxulp=1)
        m, mode = rec["metrics"], rec["mode"]
        assert m["view.colds"] == ("counter", 1)
        assert m["view.noops"] == ("counter", 1)
        assert m["view.mutations_applied"] == ("counter", 1)
        assert m["view.journal_depth.pv"] == ("gauge", 1)
        assert m[f"view.{mode}s"][1] >= 1
        if mode == "repair":
            assert m["view.repair_seconds"] == ("histogram", 1)
        rows = [e for e in rec["events"] if e[2] == "views"]
        assert [e[0] for e in rows[:2]] == ["pv.cold", f"pv.{mode}"]
        assert rows[1][3]["mutations"] == 1
        np.testing.assert_array_equal(rec["query"], rec["twin"])

    def test_checkpoint_resets_journal_depth(self, tmp_path):
        def scenario(pkg, root):
            reg = pkg.MetricsRegistry()
            mgr = pkg.ViewManager(journal_root=str(root), metrics=reg)
            pagerank_view(pkg, mgr, "pv")
            for s, d in ((5, 9), (80, 160)):
                mgr.mutate("pv", pkg.EdgeInsert(s, d))
                mgr.refresh("pv")
            before = metrics(reg)
            mgr.checkpoint("pv")
            return dict(before=before, after=metrics(reg),
                        reports=reports(mgr.views["pv"]),
                        query=mgr.query("pv"))

        rec = both(scenario, tmp_path, maxulp=1)
        assert rec["before"]["view.journal_depth.pv"] == ("gauge", 2)
        assert rec["after"]["view.journal_depth.pv"] == ("gauge", 0)
