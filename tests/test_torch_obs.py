"""The port's observability layer against the reference's.

Metrics registries driven the same way give equal snapshots; a traced run
is bit-identical to its untraced twin and records one stratum span per
stratum with the reference's probe payloads and counts; the measured route
table refuses other backends and a calibrated run equals ``auto``'s; the
resilient driver feeds measured latencies to speculation and mirrors its
events into the tracer and the registry.
"""
import gc
import json

import numpy as np
import pytest

import jax
import torch

from repro.algorithms import pagerank as JP
from repro.core.engine import ShardedExecutor as JEx
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer

from repro_torch import convert
from repro_torch.algorithms import pagerank, sssp
from repro_torch.core.engine import ShardedExecutor
from repro_torch.data.graphs import CSRGraph
from repro_torch.obs import (MeasuredLatencies, MetricsRegistry,
                             RouteCostTable, Tracer,
                             calibrate_executor_table, metrics_to_json,
                             to_chrome_trace, write_chrome_trace,
                             write_metrics)
from repro_torch.obs.calibrate import backend_name
from repro_torch.runtime import FaultPlan, SpeculationPolicy
from torch_threads import one_torch_thread  # noqa: F401

N, S = 512, 4
PR_THRESHOLD = 1e-2   # fewer strata than PageRank's default 1e-3


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def graph():
    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    jsnap = JSnapshot(n_keys=N, num_shards=S)
    jg = j_shard_csr(indptr, indices, S)
    return dict(jsnap=jsnap, jg=jg, snap=convert.snapshot(jsnap),
                g=convert.to_torch(CSRGraph, jg, "cpu"))


def make_executor(snap, **kw):
    kw.setdefault("ladder_tiers", 4)
    kw.setdefault("route_strategy", "auto")
    return ShardedExecutor(snapshot=snap, seg_capacity=8192,
                           edge_capacity=8192,
                           src_capacity=snap.block_size, **kw)


def pr_setup(snap):
    algo = pagerank.make_algorithm(snap, PR_THRESHOLD, snap.block_size, 8192)
    return algo, pagerank.initial_state(snap, "cpu"), snap.padded_keys


def states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def stats_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in a._fields)


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_snapshots_equal_reference(self):
        reg, jreg = MetricsRegistry(), JRegistry()
        for r in (reg, jreg):
            r.counter("c").inc()
            r.counter("c").inc(2.5)
            r.gauge("g").set(7)
            r.gauge("g").inc(3)
            r.gauge("g").dec(1)
            for v in (0.001, 0.01, 0.01, 5.0, 1e4):
                r.histogram("h").observe(v)
            r.histogram("b", buckets=(1.0, 2.0)).observe(1.5)
        snap = reg.snapshot()
        assert snap == jreg.snapshot()
        assert snap["c"]["value"] == 3.5 and snap["g"]["value"] == 9
        assert snap["h"]["count"] == 5 and "+inf" in snap["h"]["buckets"]
        json.dumps(snap)

    def test_kind_mismatch_raises_and_reset(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("x").inc(-1)
        assert reg.names() == ["x"] and len(reg) == 1
        reg.reset()
        assert reg.snapshot() == {}


# ---------------------------------------------------------------------------
# Tracer + exporter.
# ---------------------------------------------------------------------------

class TestTracer:
    def test_span_and_instant_structure(self, tmp_path):
        tr = Tracer("t")
        with tr.span("work", tid="host", k=1) as args:
            args["result"] = 42
        tr.instant("ping", shard=2)
        spans = [e for e in tr.events if e["ph"] == "X"]
        assert spans[0]["name"] == "work"
        assert spans[0]["args"] == {"k": 1, "result": 42}
        assert spans[0]["dur"] >= 0
        ct = to_chrome_trace(tr)
        json.dumps(ct)
        assert {e["ph"] for e in ct["traceEvents"]} == {"M", "X", "i"}
        rows = [e["args"]["name"] for e in ct["traceEvents"]
                if e["name"] == "thread_name"]
        assert "host" in rows
        path = write_chrome_trace(tr, str(tmp_path / "t.json"))
        with open(path) as f:
            assert json.load(f)["otherData"]["events"] == 2

    @pytest.mark.parametrize("mode", ["delta", "nodelta"])
    def test_traced_run_bit_identical_and_probes_match_reference(
            self, graph, mode):
        snap, g = graph["snap"], graph["g"]
        algo, state0, live0 = pr_setup(snap)
        plain = make_executor(snap).run(algo, state0, live0, g, 60,
                                        mode=mode)
        tr = Tracer("pr", metrics=MetricsRegistry())
        res = make_executor(snap, tracer=tr).run(algo, state0, live0, g, 60,
                                                 mode=mode)
        assert states_equal(plain.state, res.state)
        assert stats_equal(plain.stats, res.stats)

        jsnap = graph["jsnap"]
        jtr = JTracer("pr", metrics=JRegistry())
        jalgo = JP.make_algorithm(jsnap, PR_THRESHOLD, jsnap.block_size,
                                  8192)
        JEx(snapshot=jsnap, seg_capacity=8192, edge_capacity=8192,
            src_capacity=jsnap.block_size, ladder_tiers=4,
            route_strategy="auto", tracer=jtr).run(
            jalgo, JP.initial_state(jsnap), jsnap.padded_keys, graph["jg"],
            60, mode=mode)

        def probes(events):
            return sorted(
                ({k: v for k, v in e["args"].items() if k != "device_s"}
                 for e in events if e["name"].startswith("stratum")),
                key=lambda a: a["stratum"])

        got, want = probes(tr.events), probes(jtr.events)
        assert len(got) == int(res.stats.iterations) == len(want)
        assert got == want
        assert [e["args"] for e in tr.events
                if e["name"] == "fixpoint_done"] == [
            e["args"] for e in jtr.events if e["name"] == "fixpoint_done"]
        m, jm = tr.metrics.snapshot(), jtr.metrics.snapshot()
        for k in ("engine.strata", "engine.deltas_emitted",
                  "engine.rehash_bytes", "engine.fixpoints",
                  "engine.live_deltas", "engine.last_fixpoint_strata"):
            assert m[k] == jm[k], k
        assert m["engine.stratum_seconds"]["count"] == jm[
            "engine.stratum_seconds"]["count"]
        assert ("engine.dense_fallbacks" in m) == (
            "engine.dense_fallbacks" in jm)
        # On the CPU no device time is recorded.
        assert "engine.stratum_device_seconds" not in m

    def test_stratum_fn_spans_close_lazily(self, graph):
        snap, g = graph["snap"], graph["g"]
        algo, state0, _ = pr_setup(snap)
        tr = Tracer()
        step = make_executor(snap, tracer=tr).make_stratum_fn(algo, g)
        state, outcome = step(state0, 0)
        assert tr.stratum_seconds(0) is not None
        assert tr.per_shard_latencies(0, S) == [tr.stratum_seconds(0)] * S
        assert tr.per_shard_latencies(5, S) is None
        assert tr.per_shard_latencies(5, S, default=0.5) == [0.5] * S
        (ev,) = [e for e in tr.events if e["name"] == "stratum0"]
        assert ev["args"]["emitted"] == int(outcome.emitted)
        tr.clear()
        assert tr.events == []

    def test_measured_latencies_indexing(self):
        ml = MeasuredLatencies()
        with pytest.raises(ValueError):
            ml(0)
        ml.observe([1.0, 2.0])
        ml.observe([3.0, 4.0])
        assert ml(0) == [1.0, 2.0]
        assert ml(1) == [3.0, 4.0]
        assert ml(99) == [3.0, 4.0]
        assert len(ml) == 2


# ---------------------------------------------------------------------------
# Measured route calibration (route_strategy="measured").
# ---------------------------------------------------------------------------

class TestMeasuredRoute:
    def test_measured_mode_requires_table(self, graph):
        snap, g = graph["snap"], graph["g"]
        algo, state0, live0 = pr_setup(snap)
        ex = make_executor(snap, route_strategy="measured")
        with pytest.raises(ValueError, match="route_table"):
            ex.run(algo, state0, live0, g, 60)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_calibrated_run_matches_auto_results(self, graph, use_kernels):
        snap, g = graph["snap"], graph["g"]
        algo, state0, live0 = pr_setup(snap)
        ex_auto = make_executor(snap, use_kernels=use_kernels)
        table = calibrate_executor_table(ex_auto, algo, reps=1, warmup=0,
                                         device="cpu")
        assert table.backend == "cpu" == backend_name("cpu")
        assert set(table.entries) == {t.edge for t in
                                      ex_auto.capacity_tiers(algo)}
        ex = make_executor(snap, route_strategy="measured",
                           route_table=table, use_kernels=use_kernels)
        ref = ex_auto.run(algo, state0, live0, g, 60)
        res = ex.run(algo, state0, live0, g, 60)
        assert states_equal(ref.state, res.state)
        assert torch.equal(ref.stats.delta_counts, res.stats.delta_counts)
        assert torch.equal(ref.stats.rehash_bytes, res.stats.rehash_bytes)
        iters = int(res.stats.iterations)
        assert bool((res.stats.routes[:iters] >= 0).all())

    def test_table_from_another_backend_is_refused(self, graph):
        table = RouteCostTable(backend="tpu", combiner="add",
                               entries={64: (1.0, 3.0), 256: (3.0, 1.0)})
        assert table.pick(64, strict=False) == "sort"
        assert table.pick(256, strict=False) == "scatter"
        assert table.pick(1024, strict=False) == "scatter"
        np.testing.assert_allclose(table.costs(128), [2.0, 2.0])
        assert table.per_tuple_cost(256) == 1.0 / 256
        with pytest.raises(ValueError, match="tpu"):
            table.pick(64, device="cpu")
        snap, g = graph["snap"], graph["g"]
        algo, state0, live0 = pr_setup(snap)
        ex = make_executor(snap, route_strategy="measured",
                           route_table=table)
        with pytest.raises(ValueError, match="recalibrate"):
            ex.run(algo, state0, live0, g, 60)

    def test_from_bench_records_needs_a_backend(self):
        records = [
            {"value": 0.02, "unit": "s", "C": 1024, "S": 4,
             "combiner": "add", "strategy": "sort"},
            {"value": 0.01, "unit": "s", "C": 1024, "S": 4,
             "combiner": "add", "strategy": "scatter"},
            {"value": 0.5, "unit": "s", "C": 4096, "S": 8,
             "combiner": "add", "strategy": "sort"},
            {"value": 7, "unit": "count", "C": 1024, "S": 4,
             "combiner": "add", "strategy": "sort"},
        ]
        with pytest.raises(TypeError, match="backend"):
            RouteCostTable.from_bench_records(records, shards=4)
        table = RouteCostTable.from_bench_records(records, shards=4,
                                                  backend="cpu")
        assert table.entries == {1024: (0.02, 0.01)}
        assert table.pick(1024, device="cpu") == "scatter"
        with pytest.raises(ValueError):
            RouteCostTable.from_bench_records(records, shards=16,
                                              backend="cpu")


# ---------------------------------------------------------------------------
# Resilient driver: measured-latency speculation + event mirroring.
# ---------------------------------------------------------------------------

class TestResilientObservability:
    def test_policy_without_model_uses_measured(self, graph, tmp_path):
        snap, g = graph["snap"], graph["g"]
        algo = sssp.make_algorithm(snap, src_capacity=snap.block_size,
                                   edge_capacity=8192)
        state0 = sssp.initial_state(snap, 0, "cpu")
        ex = make_executor(snap)
        ref = ex.run(algo, state0, 1, g, 80)
        rr = ex.run_resilient(
            algo, state0, 1, g, 80, ckpt_root=str(tmp_path),
            policy=SpeculationPolicy(threshold=2.0, min_history=1))
        assert rr.metrics["converged"]
        assert states_equal(ref.state, rr.result.state)
        assert rr.metrics["latency_source"] == "measured"
        walls = rr.metrics["stratum_wall_s"]
        assert len(walls) == rr.metrics["strata_executed"]
        assert all(w > 0 for w in walls)

    def test_recovery_events_reach_tracer_and_registry(self, graph,
                                                       tmp_path):
        snap, g = graph["snap"], graph["g"]
        algo, state0, live0 = pr_setup(snap)
        tr, reg = Tracer("resil"), MetricsRegistry()
        ex = make_executor(snap, tracer=tr)
        ref = make_executor(snap).run(algo, state0, live0, g, 80)
        rr = ex.run_resilient(
            algo, state0, live0, g, 80, ckpt_root=str(tmp_path / "c"),
            fault_plan=FaultPlan(fail_at=3, failed_shard=1), metrics=reg)
        assert rr.metrics["converged"]
        assert states_equal(ref.state, rr.result.state)
        names = [e["name"] for e in tr.events]
        assert "failure" in names and "recovery" in names
        n = rr.metrics["strata_executed"]
        assert names.count("stratum_sliced") == n
        assert names.count("replicate") == n
        assert sum(x.startswith("stratum") and x != "stratum_sliced"
                   for x in names) == n
        snap_m = reg.snapshot()
        assert snap_m["recovery.failures"]["value"] == 1
        assert snap_m["recovery.recoverys"]["value"] == 1
        assert snap_m["recovery.stratum_seconds"]["count"] == n
        assert snap_m["recovery.bytes_replicated"]["value"] == rr.metrics[
            "bytes_replicated"]
        json.dumps(to_chrome_trace(tr))
        out = metrics_to_json(reg, extra={"x": 1})
        assert out["x"] == 1 and "recovery.failures" in out["metrics"]
        path = write_metrics(reg, str(tmp_path / "m.json"))
        with open(path) as f:
            assert json.load(f)["metrics"] == reg.snapshot()
