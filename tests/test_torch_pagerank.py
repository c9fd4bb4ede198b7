"""The whole slice: the port's PageRank against the reference's.

Same graph, same snapshot, same settings (4 shards, ladder of 4 rungs, an
edge capacity below the per-shard edge count so runs reach a dense stratum
and several sparse rungs), under ``sort``, ``auto`` and ``nodelta``, with
the port's kernels on (their plain versions run on the CPU) and off.
Iterations and every per-stratum statistic must be equal; the values
within 1 ulp (float adds; the port keeps the reference's order, so they
come out equal).
"""
import dataclasses
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.algorithms import pagerank as JP
from repro.core import fixpoint as JF
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr

from repro_torch import convert
from repro_torch.algorithms import pagerank as TP
from repro_torch.core import fixpoint as TF
from repro_torch.core.engine import ShardedExecutor
from repro_torch.data.graphs import CSRGraph
from torch_threads import one_torch_thread  # noqa: F401

N, S = 1024, 4
CAP = dict(edge_capacity=2048, src_capacity=256, ladder_tiers=4)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def setup():
    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    jg = j_shard_csr(indptr, indices, S)
    jsnap = JSnapshot(n_keys=N, num_shards=S)
    return dict(indptr=indptr, indices=indices, jg=jg, jsnap=jsnap,
                tg=convert.to_torch(CSRGraph, jg, "cpu"),
                snap=convert.snapshot(jsnap), ref_runs={})


def _reference(setup, mode, route):
    key = (mode, route)
    if key not in setup["ref_runs"]:
        setup["ref_runs"][key] = JP.run(
            setup["jg"], setup["jsnap"], mode=mode, threshold=1e-3,
            max_iters=60, route_strategy=route, **CAP)
    return setup["ref_runs"][key]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mode,route", [("delta", "sort"), ("delta", "auto"),
                                        ("nodelta", "sort")])
def test_pagerank_parity(setup, mode, route, use_kernels):
    jpr, jres = _reference(setup, mode, route)
    pr, res = TP.run(setup["tg"], setup["snap"], mode=mode, threshold=1e-3,
                     max_iters=60, route_strategy=route, device="cpu",
                     use_kernels=use_kernels, **CAP)
    for f in JF.StratumStats._fields:
        a, b = np.asarray(getattr(jres.stats, f)), getattr(res.stats,
                                                           f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_max_ulp(np.asarray(jpr), pr.numpy(), maxulp=1)
    for f in ("acc", "sent"):
        np.testing.assert_array_max_ulp(np.asarray(getattr(jres.state, f)),
                                        getattr(res.state, f).numpy(),
                                        maxulp=1)
    it = int(res.stats.iterations)
    tiers = set(res.stats.tiers[:it].tolist())
    if mode == "delta":
        # The settings reach a dense stratum and at least two sparse rungs.
        assert -1 in tiers and len(tiers - {-1}) >= 2
        want = TF.ROUTE_SCATTER if route == "auto" else TF.ROUTE_SORT
        assert set(res.stats.routes[:it].tolist()) == {-1, want}


def test_reference_pagerank_matches(setup):
    ref_j = np.asarray(JP.reference_pagerank(setup["indptr"],
                                             setup["indices"], N, iters=50))
    ref_t = TP.reference_pagerank(setup["indptr"], setup["indices"], N,
                                  iters=50, device="cpu").numpy()
    np.testing.assert_array_max_ulp(ref_j, ref_t, maxulp=1)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_delta_close_to_nodelta_and_oracle(setup, use_kernels):
    """tests/test_algorithms.py's bound, on the port."""
    kw = dict(threshold=1e-5, max_iters=120, device="cpu",
              use_kernels=use_kernels, edge_capacity=8192,
              src_capacity=512)
    pr_d, _ = TP.run(setup["tg"], setup["snap"], mode="delta", **kw)
    pr_n, _ = TP.run(setup["tg"], setup["snap"], mode="nodelta", **kw)
    ref = TP.reference_pagerank(setup["indptr"], setup["indices"], N,
                                iters=300, device="cpu")
    assert float((pr_d - pr_n).abs().max()) < 5e-3
    assert float((pr_d[:N] - ref).abs().max()) < 5e-3


def test_resume_and_stratum_fn(setup):
    snap, tg = setup["snap"], setup["tg"]
    algo = TP.make_algorithm(snap, 1e-3, 256, 2048)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=2048, edge_capacity=2048,
                         src_capacity=256, ladder_tiers=4)
    state0 = TP.initial_state(snap, "cpu")
    assert int(ex.live_count(algo, state0, tg)) == snap.padded_keys
    full = ex.run(algo, state0, snap.padded_keys, tg, 60)
    # A converged state re-enters with no strata to run.
    again = ex.resume(algo, full.state, tg, 60)
    assert int(again.stats.iterations) == 0
    # Stepping the one-stratum function reproduces run's first strata.
    step = ex.make_stratum_fn(algo, tg)
    state = state0
    for i in range(3):
        state, outcome = step(state, i)
        assert int(outcome.emitted) == int(full.stats.delta_counts[i])
        assert outcome.tier == int(full.stats.tiers[i])
    # An explicit condition stops after the stratum that fails it.
    stop = ex.run(algo, state0, snap.padded_keys, tg, 60,
                  explicit_cond=lambda new, old, i: i < 2)
    assert int(stop.stats.iterations) == 3


def test_stats_helpers_match_reference():
    outs_j = [JF.StratumOutcome(live_count=jnp.int32(5 - i),
                                used_dense=jnp.bool_(i == 0),
                                rehash_bytes=jnp.float32(8.0 * i),
                                emitted=jnp.int32(i), tier=jnp.int32(i - 1),
                                route=jnp.int32(i % 2)) for i in range(4)]
    outs_t = [TF.StratumOutcome(*(np.asarray(v).item() for v in o))
              for o in outs_j]
    for max_iters in (3, 6):
        a = JF.stats_from_outcomes(outs_j, max_iters)
        b = TF.stats_from_outcomes(outs_t, max_iters)
        ma, mb = JF.merge_stats(a, a), TF.merge_stats(b, b)
        for f in JF.StratumStats._fields:
            for x, y in ((a, b), (ma, mb)):
                np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                              getattr(y, f).numpy())
    e = TF.empty_stats(4)
    assert int(e.iterations) == 0 and e.tiers.tolist() == [-1] * 4


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank, this process, for the shard_map backend."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group
    init_shard_group("gloo", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kw,call", [
    (dict(backend="shard_map"), "run"),
    (dict(backend="shard_map", tracer="tracer"), "run"),
    (dict(backend="shard_map", route_strategy="measured"), "run"),
    (dict(backend="shard_map"), "run_resilient")])
def test_shard_map_world1_equals_simulated(setup, kw, call, tmp_path,
                                           world1):
    """The shard_map backend on a world of one rank equals the simulated
    backend bit for bit, and the reference's run (values within 1 ulp,
    stats exactly), on the plain, traced and measured-routing paths, and
    through ``run_resilient`` (failure-free, its replica chain under
    ``ckpt_root/rank0``)."""
    from repro_torch.launch.mesh import flat_mesh
    from repro_torch.obs import Tracer
    from repro_torch.obs.calibrate import RouteCostTable
    snap = setup["snap"]
    kw = dict(kw, mesh=flat_mesh(S, device="cpu"))
    if kw.get("tracer"):
        kw = dict(kw, tracer=Tracer())
    route = "sort"
    if kw.get("route_strategy") == "measured":
        # Scatter measured faster on every rung: the routes "auto" picks.
        route = "auto"
        kw = dict(kw, route_table=RouteCostTable(
            backend="cpu", combiner="add",
            entries={c: (1.0, 0.5) for c in (128, 512, 2048)}))
    ex = ShardedExecutor(snapshot=snap, seg_capacity=2048, edge_capacity=2048,
                         src_capacity=256, ladder_tiers=4, **kw)
    algo = TP.make_algorithm(snap, src_capacity=256, edge_capacity=2048)
    args = (algo, TP.initial_state(snap, "cpu"), snap.padded_keys,
            setup["tg"], 60)
    sim = dataclasses.replace(ex, backend="simulated", mesh=None,
                              tracer=None)
    want = sim.run(*args)
    if call == "run_resilient":
        got = ex.run_resilient(*args, ckpt_root=str(tmp_path / "c")).result
        assert [p.name for p in (tmp_path / "c").iterdir()] == ["rank0"]
    else:
        got = ex.run(*args)
    for a, b in zip(want.state, got.state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for f in TF.StratumStats._fields:
        np.testing.assert_array_equal(getattr(want.stats, f).numpy(),
                                      getattr(got.stats, f).numpy())
    _, jres = _reference(setup, "delta", route)
    for f in JF.StratumStats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres.stats, f)),
                                      getattr(got.stats, f).numpy(),
                                      err_msg=f)
    for f in ("acc", "sent"):
        np.testing.assert_array_max_ulp(np.asarray(getattr(jres.state, f)),
                                        getattr(got.state, f).numpy(),
                                        maxulp=1)
    it = int(got.stats.iterations)
    assert it > 10 and set(got.stats.tiers[:it].tolist()) - {-1}
    if kw.get("tracer"):
        assert sum(e["ph"] == "X" for e in kw["tracer"].events) == it


def test_types_are_pinned(setup):
    pr, res = TP.run(setup["tg"], setup["snap"], device="cpu", max_iters=2,
                     **CAP)
    assert pr.dtype == torch.float32
    assert res.stats.delta_counts.dtype == torch.int32
    assert res.stats.rehash_bytes.dtype == torch.float32
    g = setup["tg"]
    assert {g.indptr.dtype, g.indices.dtype, g.out_degree.dtype} == {
        torch.int32}
