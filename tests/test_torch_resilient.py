"""The port's fault-tolerant fixpoint against the reference's simulated
driver (``ShardedExecutor.run_resilient``).

Same graph, snapshot and settings (512 vertices, 4 shards, ladder of 4
rungs) on both sides; each scenario runs through both drivers and must
land on bit-identical final states (in global key space where a rescale
changed the shard count), equal per-stratum stats, and equal ``metrics``
(Fig 12's work and byte accounting, every recovery event) except the
wall-clock readings.  A failure-free resilient run also equals the port's
own ``run``.
"""
import gc
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.algorithms import pagerank as JP
from repro.algorithms import sssp as JS
from repro.core.engine import ShardedExecutor as JEx
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.core.partition import unshard_dense_state as j_unshard
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr
from repro.runtime import chaos as jchaos
from repro.runtime import recovery as jrec

from repro_torch import convert
from repro_torch.algorithms import pagerank as TP
from repro_torch.algorithms import sssp as TS
from repro_torch.core.engine import ShardedExecutor
from repro_torch.core.partition import unshard_dense_state
from repro_torch.data.graphs import CSRGraph, shard_csr
from repro_torch.runtime import chaos
from repro_torch.runtime.recovery import (FaultEvent, FaultPlan,
                                          FaultSchedule, StratumRunner,
                                          run_with_failure)
from repro_torch.runtime.straggler import SpeculationPolicy
from torch_threads import one_torch_thread  # noqa: F401

N, S, CAP = 512, 4, 8192
PR_THRESHOLD = 1e-2   # PageRank converges in fewer strata than at 1e-3
# Metrics read off the host clock, and the speculation records built from
# them when latencies are measured.
WALL_KEYS = {"stratum_wall_s", "recovery_wall_s", "speculation_saved_time"}


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
    return dict(indptr=indptr, indices=indices, jsnap=jsnap, jg=jg,
                snap=convert.snapshot(jsnap),
                tg=convert.to_torch(CSRGraph, jg, "cpu"))


def port(snap, name, indptr=None, indices=None, **kw):
    """(executor, algo, state0, live0) of the port; with ``indptr`` also
    the sharded graph (for a rescale's remake)."""
    kw.setdefault("ladder_tiers", 4)
    kw.setdefault("route_strategy", "auto")
    ex = ShardedExecutor(snapshot=snap, seg_capacity=CAP, edge_capacity=CAP,
                         src_capacity=snap.block_size, **kw)
    if name == "sssp":
        algo = TS.make_algorithm(snap, src_capacity=snap.block_size,
                                 edge_capacity=CAP)
    else:
        algo = TP.make_algorithm(snap, PR_THRESHOLD, snap.block_size, CAP)
    if name == "sssp":
        out = (ex, algo, TS.initial_state(snap, 0, "cpu"), 1)
    else:
        out = (ex, algo, TP.initial_state(snap, "cpu"), snap.padded_keys)
    if indptr is not None:
        out += (shard_csr(indptr, indices, snap.num_shards, device="cpu"),)
    return out


def ref(jsnap, name, indptr=None, indices=None, **kw):
    """The reference's counterpart of :func:`port`."""
    kw.setdefault("ladder_tiers", 4)
    kw.setdefault("route_strategy", "auto")
    ex = JEx(snapshot=jsnap, seg_capacity=CAP, edge_capacity=CAP,
             src_capacity=jsnap.block_size, **kw)
    if name == "sssp":
        algo = JS.make_algorithm(jsnap, src_capacity=jsnap.block_size,
                                 edge_capacity=CAP)
    else:
        algo = JP.make_algorithm(jsnap, PR_THRESHOLD, jsnap.block_size, CAP)
    if name == "sssp":
        out = (ex, algo, JS.initial_state(jsnap, 0), 1)
    else:
        out = (ex, algo, JP.initial_state(jsnap), jsnap.padded_keys)
    if indptr is not None:
        out += (j_shard_csr(indptr, indices, jsnap.num_shards),)
    return out


def remakes(g):
    """remake(new_snapshot) for each driver: (port's, reference's)."""
    def t(new):
        ex, algo, _, _, graph = port(new, "sssp", g["indptr"], g["indices"])
        return ex, algo, graph

    def j(new):
        ex, algo, _, _, graph = ref(new, "sssp", g["indptr"], g["indices"])
        return ex, algo, graph

    return t, j


def flat(snap, state, num_shards):
    """Global-key view [n, W] of a port state."""
    return unshard_dense_state(snap.resnapshot(num_shards),
                               torch.stack(tuple(state), -1)).numpy()


def jflat(jsnap, state, num_shards):
    return np.asarray(j_unshard(jsnap.resnapshot(num_shards),
                                jnp.stack(tuple(state), -1)))


def assert_same_run(got, want, snap, jsnap):
    """Port ResilientResult ``got`` against the reference's ``want``."""
    gm, wm = got.metrics, want.metrics
    assert set(gm) == set(wm)
    for k in set(gm) - WALL_KEYS - {"speculations"}:
        assert gm[k] == wm[k], k
    if "speculations" in gm:
        strip = [{"shard": d["shard"], "replica": d["replica"]}
                 for d in gm["speculations"]]
        assert strip == [{"shard": d["shard"], "replica": d["replica"]}
                         for d in wm["speculations"]]
    shards = gm["final_num_shards"]
    np.testing.assert_array_equal(jflat(jsnap, want.result.state, shards),
                                  flat(snap, got.result.state, shards))
    it = int(got.result.stats.iterations)
    assert it == int(want.result.stats.iterations)
    for f in ("delta_counts", "used_dense", "rehash_bytes", "tiers",
              "routes"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want.result.stats, f)),
            getattr(got.result.stats, f).numpy(), err_msg=f)


def both(g, name, tmp_path, tag, port_kw=None, ref_kw=None, exec_kw=None,
         **resilient_kw):
    """Run one scenario through both drivers: (port result, reference
    result)."""
    exec_kw = exec_kw or {}
    ex, algo, st0, live0 = port(g["snap"], name, **exec_kw)
    jex, jalgo, jst0, jlive0 = ref(g["jsnap"], name, **exec_kw)
    got = ex.run_resilient(algo, st0, live0, g["tg"], 80,
                           ckpt_root=str(tmp_path / f"t-{tag}"),
                           **resilient_kw, **(port_kw or {}))
    want = jex.run_resilient(jalgo, jst0, jlive0, g["jg"], 80,
                             ckpt_root=str(tmp_path / f"j-{tag}"),
                             **resilient_kw, **(ref_kw or {}))
    return got, want


# ---------------------------------------------------------------------------
# Failure-free.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pr", "sssp"])
def test_nofail_matches_run_and_reference(graph, name, tmp_path):
    ex, algo, st0, live0 = port(graph["snap"], name)
    run = ex.run(algo, st0, live0, graph["tg"], 80)
    got, want = both(graph, name, tmp_path, "nf")
    assert_same_run(got, want, graph["snap"], graph["jsnap"])
    for a, b in zip(run.state, got.result.state):
        assert torch.equal(a, b)
    for f in run.stats._fields:
        assert torch.equal(getattr(run.stats, f),
                           getattr(got.result.stats, f)), f
    assert got.metrics["converged"] and got.metrics["restarts"] == 0
    # The ladder really dispatched under the driver.
    tiers = got.result.stats.tiers[:int(run.stats.iterations)]
    assert int(tiers.min()) >= 0 and len(set(tiers.tolist())) > 1


def test_resume_resilient(graph, tmp_path):
    ex, algo, st0, live0 = port(graph["snap"], "sssp")
    full = ex.run(algo, st0, live0, graph["tg"], 80)
    again = ex.resume_resilient(algo, full.state, graph["tg"], 80,
                                ckpt_root=str(tmp_path / "warm"))
    assert int(again.result.stats.iterations) == 0
    assert again.metrics["strata_executed"] == 0
    # Re-entry from a state three strata in equals the uninterrupted run.
    step = ex.make_stratum_fn(algo, graph["tg"])
    state = st0
    for i in range(3):
        state, _ = step(state, i)
    warm = ex.resume_resilient(algo, state, graph["tg"], 80,
                               ckpt_root=str(tmp_path / "mid"))
    for a, b in zip(full.state, warm.result.state):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Failures, restarts, rescales, stragglers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,route,strategies", [
    ("sssp", "sort", ("incremental", "restart")),
    ("sssp", "scatter", ("incremental", "restart")),
    ("pr", "auto", ("incremental",))])
def test_failure_midfixpoint(graph, name, route, strategies, tmp_path):
    """One shard lost at half the failure-free strata: incremental and
    restart recovery each equal the reference's, and incremental does
    less work."""
    ex, algo, st0, live0 = port(graph["snap"], name, route_strategy=route)
    half = max(int(ex.run(algo, st0, live0, graph["tg"], 80)
                   .stats.iterations) // 2, 1)
    work = {"restart": float("inf")}
    for strategy in strategies:
        got, want = both(graph, name, tmp_path, strategy,
                         exec_kw=dict(route_strategy=route),
                         port_kw=dict(fault_plan=FaultPlan(
                             fail_at=half, failed_shard=1,
                             strategy=strategy)),
                         ref_kw=dict(fault_plan=jrec.FaultPlan(
                             fail_at=half, failed_shard=1,
                             strategy=strategy)))
        assert_same_run(got, want, graph["snap"], graph["jsnap"])
        assert got.metrics["converged"]
        work[strategy] = got.metrics["total_work_units"]
    assert 0 < work["incremental"] < work["restart"]


def test_rescale_midfixpoint_and_fail_after(graph, tmp_path):
    t_remake, j_remake = remakes(graph)
    kw = dict(rescale_at=3, new_num_shards=8, fail_at=5, failed_shard=6)
    got, want = both(graph, "sssp", tmp_path, "rescale",
                     port_kw=dict(fault_plan=FaultPlan(**kw),
                                  remake=t_remake),
                     ref_kw=dict(fault_plan=jrec.FaultPlan(**kw),
                                 remake=j_remake))
    assert got.metrics["final_num_shards"] == 8
    assert_same_run(got, want, graph["snap"], graph["jsnap"])


def test_correlated_loss_beyond_replication_restarts(graph, tmp_path):
    snap = graph["snap"].__class__(n_keys=N, num_shards=S, replication=2)
    jsnap = JSnapshot(n_keys=N, num_shards=S, replication=2)
    g = dict(graph, snap=snap, jsnap=jsnap)
    ev = dict(kind="fail", at=2, shard=1, correlated=True)
    got, want = both(g, "sssp", tmp_path, "corr",
                     port_kw=dict(fault_plan=FaultSchedule(
                         events=(FaultEvent(**ev),))),
                     ref_kw=dict(fault_plan=jrec.FaultSchedule(
                         events=(jrec.FaultEvent(**ev),))))
    assert got.metrics["restarts"] >= 1
    assert "recovery_fallback" in [e["event"] for e in
                                   got.metrics["events"]]
    assert_same_run(got, want, snap, jsnap)


def test_straggler_speculation_and_restart_without_replicas(graph,
                                                            tmp_path):
    model = lambda stratum: [1.0, 1.0, 6.0, 1.0]  # noqa: E731
    for tag, plan, jplan in (
            ("spec", None, None),
            ("restart", FaultPlan(fail_at=2, failed_shard=1,
                                  strategy="restart"),
             jrec.FaultPlan(fail_at=2, failed_shard=1, strategy="restart"))):
        got, want = both(
            graph, "sssp", tmp_path, tag, latency_model=model,
            port_kw=dict(fault_plan=plan,
                         policy=SpeculationPolicy(threshold=2.0,
                                                  min_history=1)),
            ref_kw=dict(fault_plan=jplan,
                        policy=jrec.SpeculationPolicy(threshold=2.0,
                                                      min_history=1)))
        assert_same_run(got, want, graph["snap"], graph["jsnap"])
        assert got.metrics["speculation_saved_time"] == \
            want.metrics["speculation_saved_time"]
        if tag == "spec":
            specs = got.metrics["speculations"]
            assert specs and all(d["shard"] == 2 for d in specs)
            assert all(v["ok"] for v in got.metrics["speculation_verified"])
        else:
            assert got.metrics["bytes_replicated"] == 0
            assert got.metrics["speculations"] == []


def test_measured_speculation_after_a_restart_and_a_rescale(graph,
                                                            tmp_path):
    """Speculation on measured latencies reads the stratum just run: a
    correlated loss beyond replication restarts from zero (the strata it
    ran stay measured), then a rescale to 2 shards; the run converges to
    the failure-free state.  Port only: the reference's driver reads an
    older measurement there, one of 4 shards beside a mitigator of 2."""
    snap = graph["snap"].__class__(n_keys=N, num_shards=S, replication=2)
    t_remake, _ = remakes(dict(graph, snap=snap))
    ex, algo, st0, live0 = port(snap, "sssp")
    free = ex.run(algo, st0, live0, graph["tg"], 80)
    plan = FaultSchedule(events=(
        FaultEvent(kind="fail", at=2, shard=1, correlated=True),
        FaultEvent(kind="rescale", at=3, new_num_shards=2)))
    got = ex.run_resilient(algo, st0, live0, graph["tg"], 80,
                           ckpt_root=str(tmp_path / "measured"),
                           fault_plan=plan, policy=SpeculationPolicy(),
                           remake=t_remake)
    assert got.metrics["restarts"] >= 1
    assert got.metrics["final_num_shards"] == 2
    assert got.metrics["converged"]
    np.testing.assert_array_equal(flat(snap, free.state, S),
                                  flat(snap, got.result.state, 2))


# ---------------------------------------------------------------------------
# Chaos schedules.
# ---------------------------------------------------------------------------

def test_acceptance_schedule(graph, tmp_path):
    got, want = both(graph, "sssp", tmp_path, "acc",
                     port_kw=dict(fault_plan=chaos.acceptance_schedule(S)),
                     ref_kw=dict(fault_plan=jchaos.acceptance_schedule(S)))
    assert got.metrics["recoveries"] >= 3
    assert_same_run(got, want, graph["snap"], graph["jsnap"])


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_seeded_chaos_schedule(graph, seed, tmp_path):
    """Seeded draws with the generator's defaults: compounding failures,
    during-recovery and during-rescale failures, rescales (seeds 7, 19)
    and stragglers (seed 0)."""
    kw = dict(seed=seed, num_shards=S, n_events=3, max_stratum=5)
    t_remake, j_remake = remakes(graph)
    got, want = both(
        graph, "sssp", tmp_path, f"chaos{seed}",
        port_kw=dict(fault_plan=chaos.generate_schedule(
            chaos.ChaosConfig(**kw)), remake=t_remake),
        ref_kw=dict(fault_plan=jchaos.generate_schedule(
            jchaos.ChaosConfig(**kw)), remake=j_remake))
    assert got.metrics["converged"]
    assert got.metrics["faults_injected"] >= 2
    assert_same_run(got, want, graph["snap"], graph["jsnap"])


def test_run_with_failure_matches_reference(graph, tmp_path):
    """The stratum-runner harness: incremental and restart recovery of one
    shard at stratum 3, Fig 12's accounting equal to the reference's."""
    from repro.runtime.checkpoint import CheckpointManager as JCM
    from repro_torch.runtime.checkpoint import CheckpointManager

    ex, algo, st0, _ = port(graph["snap"], "sssp")
    jex, jalgo, jst0, _ = ref(graph["jsnap"], "sssp")
    sfn = ex.make_stratum_fn(algo, graph["tg"])
    jsfn = jex.make_stratum_fn(jalgo, graph["jg"])

    def mutable_of(state):
        return np.stack([np.asarray(x) for x in state], -1)

    def restore(state, shard, node):
        d, s = (x.clone() for x in state)
        d[node], s[node] = torch.from_numpy(shard[:, 0]), torch.from_numpy(
            shard[:, 1])
        return TS.SPState(d, s)

    def jrestore(state, shard, node):
        return JS.SPState(state[0].at[node].set(jnp.asarray(shard[:, 0])),
                          state[1].at[node].set(jnp.asarray(shard[:, 1])))

    for strategy in ("incremental", "restart"):
        got = run_with_failure(
            lambda: StratumRunner(sfn, st0, 1),
            CheckpointManager(str(tmp_path / f"t{strategy}"), S),
            mutable_of, restore, 3, 1, strategy)
        want = jrec.run_with_failure(
            lambda: jrec.StratumRunner(jsfn, jst0, 1),
            JCM(str(tmp_path / f"j{strategy}"), S),
            mutable_of, jrestore, 3, 1, strategy)
        for k in ("strata_executed", "total_work_units",
                  "bytes_replicated", "converged"):
            assert got[k] == want[k], (strategy, k)
        np.testing.assert_array_equal(mutable_of(want["final_state"]),
                                      mutable_of(got["final_state"]))


def test_unrecoverable_budget_raises(graph):
    from repro_torch.runtime.retry import RecoveryExhausted, RetryBudget
    ex, algo, st0, live0 = port(graph["snap"], "sssp")
    with tempfile.TemporaryDirectory() as td, \
            pytest.raises(RecoveryExhausted, match="recoveries"):
        ex.run_resilient(algo, st0, live0, graph["tg"], 80, ckpt_root=td,
                         fault_plan=FaultPlan(fail_at=1, failed_shard=0),
                         budget=RetryBudget(max_recoveries=0))
