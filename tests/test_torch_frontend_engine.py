"""Compiled rule programs in the port, engine-level cases, against the
reference's compiled programs and oracles.

Same graph and snapshot as ``test_torch_frontend_lower.py`` (512 vertices,
4 shards): rules-only reachability against a BFS oracle and the
reference, a compiled program under the resilient driver against the
reference's, a rerun on a second graph against a fresh run
(edge_propagate's cached CSC must follow the graph), the raw plan against
the optimized one, facts outside the key space, constant-only terms, and
the shard_map backend on a world of one rank.
"""
import gc

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import torch

from repro import frontend as JFe
from repro.core import fixpoint as JF
from repro.core.engine import ShardedExecutor as JEx
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr
from repro.runtime import FaultEvent as JEvent
from repro.runtime import FaultSchedule as JSchedule

from repro_torch import convert
from repro_torch import frontend as TFe
from repro_torch.algorithms import sssp as TS
from repro_torch.core.engine import ShardedExecutor
from repro_torch.data.graphs import CSRGraph, shard_csr
from repro_torch.frontend.lower import CompiledProgram, _extract_spec
from repro_torch.runtime import FaultEvent, FaultSchedule
from torch_threads import one_torch_thread  # noqa: F401

N, S = 512, 4
CAP = dict(edge_capacity=1024, src_capacity=128)


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
                snap=convert.snapshot(jsnap),
                tg=convert.to_torch(CSRGraph, jg, "cpu"))


def assert_stats_equal(want, got):
    for f in JF.StratumStats._fields:
        a = np.asarray(getattr(want.stats, f))
        b = getattr(got.stats, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# Rules-only reachability.
# ---------------------------------------------------------------------------

def reached(indptr, indices, n, source):
    """bool[n]: the BFS oracle reaches the vertex from ``source``."""
    return torch.isfinite(TS.reference_sssp(indptr, indices, n, source,
                                            device="cpu")).numpy()


@pytest.mark.parametrize("mode,route", [("delta", "auto"), ("delta", "sort"),
                                        ("nodelta", "sort")])
def test_reachability_matches_bfs_and_reference(setup, mode, route):
    kw = dict(mode=mode, max_iters=80, route_strategy=route, ladder_tiers=4,
              **CAP)
    jvals, jres = JFe.compile_program(JFe.reachability_program(7)).run(
        setup["jg"], setup["jsnap"], **kw)
    cp = TFe.compile_program(TFe.reachability_program(7))
    for use_kernels in (True, False):
        vals, res = cp.run(setup["tg"], setup["snap"], device="cpu",
                           use_kernels=use_kernels, **kw)
        assert_stats_equal(jres, res)
        np.testing.assert_array_equal(np.asarray(jvals), vals.numpy())
        np.testing.assert_array_equal(
            vals[:N].numpy() == 1.0,
            reached(setup["indptr"], setup["indices"], N, 7))
        assert int(res.stats.iterations) < 80   # converged, not exhausted
        assert set(vals.unique().tolist()) <= {1.0, float("-inf")}


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 1000), source=st.integers(0, 511))
def test_reachability_random_graphs(seed, source):
    indptr, indices = make_powerlaw_graph(N, avg_degree=6.0, seed=seed)
    snap = convert.snapshot(JSnapshot(n_keys=N, num_shards=S))
    cp = TFe.compile_program(TFe.reachability_program(source))
    vals, _ = cp.run(shard_csr(indptr, indices, S, device="cpu"), snap,
                     max_iters=80, route_strategy="auto", ladder_tiers=4,
                     device="cpu", **CAP)
    np.testing.assert_array_equal(vals[:N].numpy() == 1.0,
                                  reached(indptr, indices, N, source))


def test_reachability_from_text(setup):
    cp = TFe.compile_program(TFe.parse_program(TFe.REACHABILITY_TEXT))
    vals, _ = cp.run(setup["tg"], setup["snap"], max_iters=80, device="cpu")
    assert float(vals[0]) == 1.0


# ---------------------------------------------------------------------------
# Engine integration.
# ---------------------------------------------------------------------------

def test_resilient_run_matches_reference(setup, tmp_path):
    """Compiled SSSP through ``run_resilient`` with two scripted failures:
    state, stats and metrics (but the wall clocks) equal the reference's,
    and the state equals the undisturbed run's."""
    snap, jsnap = setup["snap"], setup["jsnap"]
    cap = dict(src_capacity=snap.block_size, edge_capacity=8192)
    at = ((2, 1), (4, 3))

    tcp = TFe.compile_program(TFe.sssp_program())
    ex = ShardedExecutor(snapshot=snap, seg_capacity=8192, **cap)
    algo = tcp.make_algorithm(snap, **cap)
    state0 = tcp.initial_state(snap, "cpu")
    live0 = ex.live_count(algo, state0, setup["tg"])
    plain = ex.run(algo, state0, live0, setup["tg"], 80)
    got = ex.run_resilient(
        algo, state0, live0, setup["tg"], 80, ckpt_root=str(tmp_path / "t"),
        fault_plan=FaultSchedule(events=tuple(
            FaultEvent(kind="fail", at=a, shard=s) for a, s in at)))

    jcp = JFe.compile_program(JFe.sssp_program())
    jex = JEx(snapshot=jsnap, seg_capacity=8192, **cap)
    jalgo = jcp.make_algorithm(jsnap, **cap)
    jstate0 = jcp.initial_state(jsnap)
    want = jex.run_resilient(
        jalgo, jstate0, jex.live_count(jalgo, jstate0, setup["jg"]),
        setup["jg"], 80, ckpt_root=str(tmp_path / "j"),
        fault_plan=JSchedule(events=tuple(
            JEvent(kind="fail", at=a, shard=s) for a, s in at)))

    assert got.metrics["converged"] and got.metrics["recoveries"] == 2
    wall = {"stratum_wall_s", "recovery_wall_s", "speculation_saved_time"}
    assert set(got.metrics) == set(want.metrics)
    for k in set(got.metrics) - wall:
        assert got.metrics[k] == want.metrics[k], k
    assert_stats_equal(want.result, got.result)
    for a, b, c in zip(want.result.state, got.result.state, plain.state):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)
    assert torch.equal(tcp.values(got.result.state), tcp.values(plain.state))


def test_rerun_on_a_second_graph_equals_a_fresh_run(setup):
    """One algorithm run on graph A, then on graph B, equals a fresh
    algorithm on B: the dense body's CSC follows the graph."""
    snap = setup["snap"]
    other = shard_csr(*make_powerlaw_graph(N, avg_degree=8.0, seed=1), S,
                      device="cpu")
    for builder in ("pagerank_program", "cc_program",
                    "reachability_program"):
        cp = TFe.compile_program(getattr(TFe, builder)())
        ex = ShardedExecutor(snapshot=snap, seg_capacity=1024, **CAP)
        reused = cp.make_algorithm(snap, **CAP)
        state0 = cp.initial_state(snap, "cpu")
        runs = []
        for algo, graph in ((reused, setup["tg"]), (reused, other),
                            (cp.make_algorithm(snap, **CAP), other)):
            runs.append(ex.run(algo, state0, 1, graph, 60, mode="nodelta"))
        assert not torch.equal(runs[0].state[0], runs[1].state[0]), builder
        for a, b in zip(runs[1].state, runs[2].state):
            assert torch.equal(a, b), builder


def test_optimized_and_raw_plans_run_identically(setup):
    """Rewrites change cost, never semantics."""
    prog = TFe.pagerank_program()
    opt = TFe.compile_program(prog)
    logical = TFe.plan_program(prog)
    raw = CompiledProgram(program=prog, logical=logical, optimized=logical,
                          spec=_extract_spec(prog, logical))
    assert opt.optimized != raw.optimized and opt.spec == raw.spec
    kw = dict(max_iters=40, ladder_tiers=4, route_strategy="auto",
              device="cpu", **CAP)
    a, ra = opt.run(setup["tg"], setup["snap"], **kw)
    b, rb = raw.run(setup["tg"], setup["snap"], **kw)
    assert torch.equal(a, b)
    for f in ra.stats._fields:
        assert torch.equal(getattr(ra.stats, f), getattr(rb.stats, f)), f


def test_facts_outside_the_key_space_are_dropped(setup):
    """The reference drops a fact at a key of no shard (an out-of-bounds
    set); so does the port, where torch would raise."""
    snap, jsnap = setup["snap"], setup["jsnap"]
    far = snap.num_shards * snap.block_size
    kw = dict(max_iters=80, **CAP)
    for key in (far, far + 5, 10 ** 6):
        def build(F):
            return (F.ProgramBuilder("far").input("edge", "u", "v")
                    .fact("d", 3, 0.0).fact("d", key, 0.0)
                    .rule("d", "min", F.ref("d") + 1.0, var="v", src="u")
                    .build())
        jcp, tcp = (JFe.compile_program(build(JFe)),
                    TFe.compile_program(build(TFe)))
        for a, b in zip(jcp.initial_state(jsnap),
                        tcp.initial_state(snap, "cpu")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jv, _ = jcp.run(setup["jg"], jsnap, **kw)
        tv, _ = tcp.run(setup["tg"], snap, device="cpu", **kw)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_constant_terms_and_inits(setup):
    """A constant-only rule term and a constant initializer broadcast to a
    column, as the reference's do."""
    def build(F):
        return (F.ProgramBuilder("const").input("edge", "u", "v")
                .init("x", 5.0).fact("x", 0, 1.0)
                .rule("x", "min", 2.0, var="v", src="u").build())
    kw = dict(max_iters=20, ladder_tiers=4, **CAP)
    for mode in ("delta", "nodelta"):
        jv, jres = JFe.compile_program(build(JFe)).run(
            setup["jg"], setup["jsnap"], mode=mode, **kw)
        tv, tres = TFe.compile_program(build(TFe)).run(
            setup["tg"], setup["snap"], mode=mode, device="cpu", **kw)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        assert_stats_equal(jres, tres)
        assert set(tv.unique().tolist()) == {1.0, 2.0, 5.0}


def test_shard_map_world1_equals_reference(setup, tmp_path):
    """A compiled program on the shard_map backend, a gloo world of one
    rank, equals the reference's compiled program (the simulated one)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group
    cp = TFe.compile_program(TFe.sssp_program())
    jv, jres = JFe.compile_program(JFe.sssp_program()).run(
        setup["jg"], setup["jsnap"], max_iters=40, ladder_tiers=4, **CAP)
    init_shard_group("gloo", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    try:
        ex = ShardedExecutor(snapshot=setup["snap"], seg_capacity=1024,
                             backend="shard_map", ladder_tiers=4, **CAP)
        tv, tres = cp.run(setup["tg"], setup["snap"], executor=ex,
                          device="cpu", max_iters=40)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert_stats_equal(jres, tres)
