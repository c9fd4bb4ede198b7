"""The port's incremental views against the reference's.

Both packages build their views from the same numpy graph or point set
(4 shards) and absorb the same mutation batches, the port on the CPU with
its kernels on (their plain versions run) and off.  After every refresh:

* SSSP and CC: the report, the state, the answer, the seeds and every
  per-stratum statistic equal the reference's bit for bit;
* PageRank: the same, with the state and answer within 1 ulp (ROADMAP's
  float-add rule), and both within 0.05 of a cold recompute;
* k-means: slots, assignments and aggregates equal, and the KMAgg
  invariant holds.

Also: the stores' multiset, netting and slot rules against the
reference's stores, an atomic failed refresh, capacity growth with a
rebind, force modes, a repair whose resume runs the dense body (the
CSC of edge_propagate must follow each refresh's graph), journals
restored across the two packages, and ``backend="shard_map"``.
"""
import gc

import numpy as np
import pytest
import torch

import jax

from repro.data.graphs import edges_to_csr, make_powerlaw_graph
from repro.incremental import EdgeDelete as JEdgeDelete
from repro.incremental import EdgeInsert as JEdgeInsert
from repro.incremental import EdgeReweight as JEdgeReweight
from repro.incremental import GraphStore as JGraphStore
from repro.incremental import PointInsert as JPointInsert
from repro.incremental import PointRemove as JPointRemove
from repro.incremental import PointStore as JPointStore
from repro.incremental import ViewManager as JViewManager

from repro_torch.core.delta import ANN_ADJUST, ANN_DELETE, ANN_REPLACE
from repro_torch.incremental import (EdgeDelete, EdgeInsert, EdgeReweight,
                                     GraphStore, PointInsert, PointRemove,
                                     PointStore, ViewManager)
from torch_threads import one_torch_thread  # noqa: F401

N, S = 256, 4
KERNELS = (True, False)
STAT_FIELDS = ("delta_counts", "used_dense", "rehash_bytes", "tiers",
               "routes")
PORT_OF = {JEdgeInsert: EdgeInsert, JEdgeDelete: EdgeDelete,
           JEdgeReweight: EdgeReweight, JPointInsert: PointInsert,
           JPointRemove: PointRemove}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


def to_port(muts):
    """The reference's mutation records as the port's."""
    import dataclasses
    return [PORT_OF[type(m)](**dataclasses.asdict(m)) for m in muts]


def random_edge_batch(store, rng, n_ins: int, n_del: int):
    """Reference mutations: inserts of random edges, deletes of stored
    ones (``tests/test_incremental.py``'s batch)."""
    muts = [JEdgeInsert(int(rng.integers(store.n)),
                        int(rng.integers(store.n))) for _ in range(n_ins)]
    src, dst = store.edges()
    if n_del and len(src):
        for i in rng.choice(len(src), min(n_del, len(src)), replace=False):
            muts.append(JEdgeDelete(int(src[i]), int(dst[i])))
    return muts


def port_view(algo, indptr, indices, n, use_kernels, fallback=1.0,
              shards=S, **params):
    mgr = ViewManager(fallback_threshold=fallback)
    view = mgr.create_graph_view("v", algo, indptr.copy(), indices.copy(),
                                 n, num_shards=shards, device="cpu",
                                 use_kernels=use_kernels, **params)
    return mgr, view


def ref_view(algo, indptr, indices, n, fallback=1.0, shards=S, **params):
    mgr = JViewManager(fallback_threshold=fallback)
    view = mgr.create_graph_view("v", algo, indptr.copy(), indices.copy(),
                                 n, num_shards=shards, **params)
    return mgr, view


def snapshot(view) -> dict:
    """What a refresh left, as numpy: report, state, stats, answer,
    seeds."""
    def host(x):
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)
    plan = getattr(view, "last_plan", None)
    res = view.last_result
    return dict(
        report={k: v for k, v in vars(view.history[-1]).items()
                if k != "wall_s"},
        state={f: host(getattr(view.state, f)) for f in view.state._fields},
        stats={f: host(getattr(res.stats, f)) for f in STAT_FIELDS}
        | {"iterations": int(res.stats.iterations)},
        query=np.array(view.query()),
        seeds={} if plan is None else {
            k: (host(b.keys), host(b.payload), host(b.ann))
            for k, b in plan.seeds.items()})


def assert_same(ref: dict, got: dict, maxulp: int = 0, what: str = ""):
    assert got["report"] == ref["report"], what
    assert got["stats"].keys() == ref["stats"].keys()
    for f, r in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][f], r, err_msg=f"{what}{f}")
    for f, r in ref["state"].items():
        g = got["state"][f]
        assert g.dtype == r.dtype and g.shape == r.shape, (what, f)
        if maxulp and np.issubdtype(r.dtype, np.floating):
            np.testing.assert_array_max_ulp(g, r, maxulp=maxulp)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}{f}")
    if maxulp:
        np.testing.assert_array_max_ulp(got["query"], ref["query"],
                                        maxulp=maxulp)
    else:
        np.testing.assert_array_equal(got["query"], ref["query"])
    assert got["seeds"].keys() == ref["seeds"].keys(), what
    for k, (keys, pay, ann) in ref["seeds"].items():
        np.testing.assert_array_equal(got["seeds"][k][0], keys)
        np.testing.assert_array_equal(got["seeds"][k][2], ann)
        if maxulp:
            np.testing.assert_array_max_ulp(got["seeds"][k][1], pay,
                                            maxulp=maxulp)
        else:
            np.testing.assert_array_equal(got["seeds"][k][1], pay)


# ---------------------------------------------------------------------------
# Graph views: the reference's trajectory, replayed by the port.
# ---------------------------------------------------------------------------

def widest_source(indptr) -> int:
    return int(np.argmax(np.diff(indptr)))


GRAPH_CASES = {
    # name: (algorithm, avg degree, seed, params, ulp, batches (ins, del))
    "pagerank": ("pagerank", 5.0, 11, dict(threshold=1e-4, max_iters=120),
                 1, [(4, 3)] * 3),
    "sssp": ("sssp", 3.0, 5, dict(max_iters=100), 0, [(3, 3), (6, 6),
                                                       (3, 3)]),
    "cc": ("connected_components", 1.5, 3, dict(max_iters=100), 0,
           [(2, 2), (4, 4), (2, 2)]),
    # A tiny resume budget: the warm resumes flood it and run the dense
    # body, so edge_propagate's CSC must follow each refresh's graph.
    "pagerank_dense": ("pagerank", 6.0, 3, dict(
        threshold=1e-4, max_iters=120, resume_edge_capacity=64,
        resume_src_capacity=16), 1, [(10, 10)] * 3),
    "sssp_dense": ("sssp", 4.0, 7, dict(
        max_iters=100, resume_edge_capacity=64, resume_src_capacity=16), 0,
        [(12, 12)] * 3),
    "cc_dense": ("connected_components", 3.0, 9, dict(
        max_iters=100, resume_edge_capacity=64, resume_src_capacity=16), 0,
        [(12, 12)] * 3),
}


@pytest.fixture(scope="module")
def trajectories():
    return {}


def reference_trajectory(trajectories, case):
    """(graph, params, [(port mutations, snapshot)]): the reference view's
    cold start and each batch, made once per module."""
    if case not in trajectories:
        algo, deg, seed, params, _, batches = GRAPH_CASES[case]
        indptr, indices = make_powerlaw_graph(N, avg_degree=deg, seed=seed)
        params = dict(params)
        if algo == "sssp":
            params["source"] = widest_source(indptr)
        _, view = ref_view(algo, indptr, indices, N, **params)
        steps = [(None, snapshot(view))]
        rng = np.random.default_rng(seed)
        for n_ins, n_del in batches:
            muts = random_edge_batch(view.store, rng, n_ins, n_del)
            view.apply(*muts)
            view.refresh()
            steps.append((to_port(muts), snapshot(view)))
        trajectories[case] = ((indptr, indices), params, steps)
    return trajectories[case]


@pytest.mark.parametrize("use_kernels", KERNELS)
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_view_replays_the_reference(trajectories, case, use_kernels):
    algo, _, _, _, ulp, _ = GRAPH_CASES[case]
    (indptr, indices), params, steps = reference_trajectory(trajectories,
                                                           case)
    _, view = port_view(algo, indptr, indices, N, use_kernels, **params)
    assert_same(steps[0][1], snapshot(view), ulp, "cold: ")
    dense_repairs = 0
    for i, (muts, ref) in enumerate(steps[1:], 1):
        view.apply(*muts)
        view.refresh()
        got = snapshot(view)
        assert_same(ref, got, ulp, f"batch {i}: ")
        dense_repairs += (got["report"]["mode"] == "repair"
                          and bool(got["stats"]["used_dense"].any()))
        if algo == "pagerank":
            state, _ = view.rule.cold(view)
            np.testing.assert_allclose(
                got["query"], view.rule.extract(view, state), atol=0.05,
                rtol=0)
    assert all(s[1]["report"]["mode"] == "repair" for s in steps[1:])
    if case.endswith("_dense"):
        assert dense_repairs >= 2      # two graphs through the dense body


def test_bridge_deletion_closure_and_fallback_equal_the_reference():
    """A path graph: deleting an early edge invalidates everything
    downstream — the cold fallback under a tight threshold, an in-place
    repair under a permissive one, then the re-inserted bridge."""
    n = 64
    indptr, indices = edges_to_csr(np.arange(n - 1), np.arange(1, n), n)
    kw = dict(source=0, max_iters=100)
    for fallback, modes in ((0.15, ("cold", "repair")),
                            (2.0, ("repair", "repair"))):
        _, jv = ref_view("sssp", indptr, indices, n, fallback, **kw)
        tviews = [port_view("sssp", indptr, indices, n, uk, fallback, **kw)[1]
                  for uk in KERNELS]
        for muts, mode in zip(([JEdgeDelete(3, 4)], [JEdgeInsert(3, 4)]),
                              modes):
            jv.apply(*muts)
            jv.refresh()
            ref = snapshot(jv)
            assert ref["report"]["mode"] == mode
            for tv in tviews:
                tv.apply(*to_port(muts))
                tv.refresh()
                assert_same(ref, snapshot(tv))
        tv = tviews[0]
        assert np.array_equal(tv.query(), np.arange(n, dtype=np.float32))
        if fallback == 2.0:
            assert int(tv.last_plan.seeds["relax"].ann[0]) == ANN_REPLACE
    # The permissive view's deletion repaired through the closure.
    _, tv = port_view("sssp", indptr, indices, n, True, 2.0, **kw)
    tv.apply(EdgeDelete(3, 4))
    assert tv.refresh().touched_keys >= n - 4
    assert int(tv.last_plan.seeds["invalidate"].ann[0]) == ANN_DELETE
    assert not np.isfinite(tv.query()[4:]).any()


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def kmeans_points(rng):
    return np.concatenate([
        rng.normal((0, 0), 0.2, (30, 2)),
        rng.normal((4, 4), 0.2, (30, 2)),
        rng.normal((0, 4), 0.2, (30, 2))]).astype(np.float32)


@pytest.fixture(scope="module")
def kmeans_reference():
    """The reference view's snapshots over three batches, and the batches
    (``tests/test_incremental.py``'s stream)."""
    rng = np.random.default_rng(0)
    pts = kmeans_points(rng)
    view = JViewManager(fallback_threshold=1.0).create_kmeans_view(
        "km", pts, k=3, num_shards=S, seed=1)
    steps = [(None, snapshot(view), view.store.to_arrays()["valid"].copy())]
    for _ in range(3):
        slots = np.flatnonzero(view.store.to_arrays()["valid"])
        muts = [JPointInsert(float(rng.normal(4)), float(rng.normal(4))),
                JPointInsert(float(rng.normal()), float(rng.normal())),
                JPointRemove(int(rng.choice(slots)))]
        view.apply(*muts)
        view.refresh()
        steps.append((to_port(muts), snapshot(view),
                      view.store.to_arrays()["valid"].copy()))
    return pts, steps


@pytest.mark.parametrize("use_kernels", KERNELS)
def test_kmeans_view_replays_the_reference(kmeans_reference, use_kernels):
    pts, steps = kmeans_reference
    view = ViewManager(fallback_threshold=1.0).create_kmeans_view(
        "km", pts, k=3, num_shards=S, seed=1, device="cpu",
        use_kernels=use_kernels)
    assert_same(steps[0][1], snapshot(view))
    for muts, ref, valid in steps[1:]:
        view.apply(*muts)
        assert view.refresh().mode == "repair"
        assert_same(ref, snapshot(view))
        arrays = view.store.to_arrays()
        np.testing.assert_array_equal(arrays["valid"], valid)
        assert int(view.last_plan.seeds["centroid_nudge"].ann[0]) == \
            ANN_ADJUST
        # KMAgg invariant: (sums, counts) == recomputation from assignment.
        assign = view.state.assign.numpy().reshape(-1)
        for c in range(3):
            sel = arrays["valid"] & (assign == c)
            np.testing.assert_allclose(view.state.sums[c].numpy(),
                                       arrays["points"][sel].sum(axis=0),
                                       atol=1e-3)
            assert int(view.state.counts[c]) == int(sel.sum())


def test_point_store_slots_equal_the_reference():
    """A long insert/remove stream, with removals of slots inserted in the
    same batch and refills of freed slots: every effect and array equals
    the reference store's (the lowest-free-slot rule journals rely on)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(40, 2)).astype(np.float32)
    jstore, tstore = (JPointStore(pts, 4, capacity=96),
                      PointStore(pts, 4, capacity=96))
    for _ in range(60):
        valid = np.flatnonzero(jstore.to_arrays()["valid"])
        muts = [JPointRemove(int(s)) for s in rng.choice(
            valid, min(len(valid), int(rng.integers(0, 5))), replace=False)]
        for _ in range(int(rng.integers(0, 6))):
            muts.insert(int(rng.integers(len(muts) + 1)),
                        JPointInsert(float(rng.normal()),
                                     float(rng.normal())))
        if rng.random() < 0.3 and any(isinstance(m, JPointInsert)
                                      for m in muts):
            # Remove the slot the batch's first insert will take.
            free = np.flatnonzero(~jstore.to_arrays()["valid"])
            removed = {m.slot for m in muts if isinstance(m, JPointRemove)}
            first = min(free.tolist() + list(removed))
            at = next(i for i, m in enumerate(muts)
                      if isinstance(m, JPointInsert))
            if first not in removed:
                muts.insert(at + 1, JPointRemove(first))
        try:
            je = jstore.apply_batch(muts)
        except (KeyError, OverflowError) as e:
            with pytest.raises(type(e)):
                tstore.apply_batch(to_port(muts))
            continue
        te = tstore.apply_batch(to_port(muts))
        for f in ("inserted_slots", "inserted_points", "removed_slots",
                  "removed_points"):
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        for k, v in jstore.to_arrays().items():
            np.testing.assert_array_equal(tstore.to_arrays()[k], v)
    # A store restored from its arrays takes the same slots.
    back = PointStore.from_arrays(tstore.to_arrays())
    muts = [JPointInsert(1.0, 2.0), JPointInsert(3.0, 4.0)]
    np.testing.assert_array_equal(
        back.apply_batch(to_port(muts)).inserted_slots,
        jstore.apply_batch(muts).inserted_slots)


# ---------------------------------------------------------------------------
# Stores and the session layer
# ---------------------------------------------------------------------------

def test_graph_store_stream_equals_the_reference():
    """Random batches with duplicate edges, reweights and deletes of edges
    inserted earlier in the batch: effects, edges and the sorted index
    equal the reference store's after every batch."""
    rng = np.random.default_rng(2)
    n = 48
    indptr, indices = make_powerlaw_graph(n, avg_degree=3, seed=2)
    jstore, tstore = JGraphStore(indptr, indices, n, 4), GraphStore(
        indptr, indices, n, 4)
    for _ in range(25):
        muts = random_edge_batch(jstore, rng, int(rng.integers(0, 8)),
                                 int(rng.integers(0, 6)))
        for _ in range(2):
            u, v = (int(x) for x in rng.integers(n, size=2))
            muts += [JEdgeInsert(u, v), JEdgeInsert(u, v), JEdgeDelete(u, v)]
        u, v = (int(x) for x in rng.integers(n, size=2))
        muts.append(JEdgeReweight(u, v, int(rng.integers(0, 3))))
        order = rng.permutation(len(muts))
        muts = [muts[i] for i in order]
        try:
            je = jstore.apply_batch(muts)
        except KeyError:
            with pytest.raises(KeyError):
                tstore.apply_batch(to_port(muts))
            continue
        te = tstore.apply_batch(to_port(muts))
        for f in ("inserted", "deleted", "old_edges", "new_edges"):
            for a, b in zip(getattr(te, f), getattr(je, f)):
                np.testing.assert_array_equal(a, b, err_msg=f)
        for f in ("changed_src", "old_deg", "new_deg"):
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        for a, b in zip(tstore.edges(), jstore.edges()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tstore._order, jstore._order)
        np.testing.assert_array_equal(tstore._sorted_codes,
                                      jstore._sorted_codes)
    jg, tg = jstore.build_sharded(), tstore.build_sharded("cpu")
    for f in ("indptr", "indices", "out_degree"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))


def test_graph_store_multiset_semantics():
    indptr, indices = edges_to_csr(np.array([0, 0]), np.array([1, 1]), 4)
    store = GraphStore(indptr, indices, 4, num_shards=2)
    assert store.multiplicity(0, 1) == 2
    store.apply_batch([EdgeDelete(0, 1)])
    assert store.multiplicity(0, 1) == 1
    with pytest.raises(KeyError):
        store.apply_batch([EdgeDelete(0, 2)])
    with pytest.raises(IndexError):
        store.apply_batch([EdgeInsert(0, 99)])
    effect = store.apply_batch([EdgeInsert(2, 3), EdgeInsert(2, 0)])
    assert np.array_equal(effect.changed_src, [2])
    assert effect.old_deg[0] == 0 and effect.new_deg[0] == 2


def test_intra_batch_netting():
    # Delete may consume an insert earlier in the SAME batch...
    indptr, indices = edges_to_csr(np.array([0]), np.array([1]), 4)
    store = GraphStore(indptr, indices, 4, num_shards=2)
    effect = store.apply_batch([EdgeInsert(2, 3), EdgeDelete(2, 3),
                                EdgeInsert(1, 2)])
    assert store.multiplicity(2, 3) == 0
    assert len(effect.inserted[0]) == 1          # only the net insert
    assert len(effect.deleted[0]) == 0
    # ...but never a later one.
    with pytest.raises(KeyError):
        store.apply_batch([EdgeDelete(3, 0), EdgeInsert(3, 0)])

    # Point insert+remove of the same slot in one batch nets to nothing.
    pstore = PointStore(np.zeros((4, 2), np.float32), num_shards=2,
                        capacity=8)
    free = int(np.flatnonzero(~pstore.to_arrays()["valid"])[0])
    peffect = pstore.apply_batch([PointInsert(1.0, 2.0),
                                  PointRemove(free),
                                  PointRemove(0)])
    assert len(peffect.inserted_slots) == 0
    assert np.array_equal(peffect.removed_slots, [0])
    assert pstore.n_points == 3
    # A failed batch leaves the point store as it was.
    before = {k: v.copy() for k, v in pstore.to_arrays().items()}
    with pytest.raises(KeyError):
        pstore.apply_batch([PointInsert(5.0, 5.0), PointRemove(7)])
    for k, v in pstore.to_arrays().items():
        np.testing.assert_array_equal(v, before[k])
    assert pstore.apply_batch([PointInsert(5.0, 5.0)]).inserted_slots[0] \
        == 0


def test_failed_refresh_is_atomic_and_preserves_batch():
    indptr, indices = edges_to_csr(np.array([0]), np.array([1]), 8)
    mgr = ViewManager(fallback_threshold=1.0)
    view = mgr.create_graph_view("sp", "sssp", indptr, indices, 8,
                                 num_shards=2, source=0, max_iters=40,
                                 device="cpu")
    mgr.mutate("sp", EdgeInsert(1, 2), EdgeDelete(5, 6))  # second is bad
    with pytest.raises(KeyError):
        mgr.refresh("sp")
    assert view.version == 0                 # nothing took effect
    assert view.store.n_edges == 1           # store untouched
    assert view.log.pending_count == 2       # batch preserved, not lost
    view.log._pending = [m for m in view.log._pending
                         if not isinstance(m, EdgeDelete)]
    assert mgr.refresh("sp")["sp"].version == 1
    assert np.array_equal(mgr.query("sp")[:3], [0, 1, 2])


def test_capacity_growth_rebinds_and_equals_the_reference():
    n = 32
    indptr, indices = make_powerlaw_graph(n, avg_degree=2, seed=4)
    kw = dict(source=0, max_iters=60, shards=2)
    _, jv = ref_view("sssp", indptr, indices, n, **kw)
    _, tv = port_view("sssp", indptr, indices, n, True, **kw)
    cap0 = tv.store.nnz_capacity
    algo0 = tv.rule.algo
    rng = np.random.default_rng(0)
    muts = [JEdgeInsert(0, int(rng.integers(n))) for _ in range(4 * cap0)]
    jv.apply(*muts)
    jv.refresh()
    tv.apply(*to_port(muts))
    tv.refresh()
    assert tv.store.nnz_capacity == jv.store.nnz_capacity > cap0
    assert tv.rule.algo is not algo0            # the rule was rebound
    assert_same(snapshot(jv), snapshot(tv))


def test_force_modes_and_reweight():
    indptr, indices = make_powerlaw_graph(64, avg_degree=3, seed=2)
    mgr = ViewManager(fallback_threshold=0.0)    # policy always says cold
    view = mgr.create_graph_view("pr", "pagerank", indptr, indices, 64,
                                 num_shards=2, max_iters=80, device="cpu")
    mgr.mutate("pr", EdgeReweight(3, 7, 4))
    assert mgr.refresh("pr")["pr"].mode == "cold"
    assert view.store.multiplicity(3, 7) == 4

    mgr.mutate("pr", EdgeReweight(3, 7, 1))      # force overrides policy
    assert mgr.refresh("pr", force="repair")["pr"].mode == "repair"
    assert view.store.multiplicity(3, 7) == 1
    assert set(view.last_split) >= {"apply_batch", "build_sharded",
                                    "repair", "fixpoint"}

    state, _ = view.rule.cold(view)
    np.testing.assert_allclose(mgr.query("pr"),
                               view.rule.extract(view, state), atol=0.05)
    # A no-op reweight touches nothing: zero strata.
    mgr.mutate("pr", EdgeReweight(3, 7, 1))
    report = mgr.refresh("pr", force="repair")["pr"]
    assert (report.mode, report.strata, report.touched_keys) == \
        ("repair", 0, 0)


def test_query_cache_and_noop_refresh():
    indptr, indices = make_powerlaw_graph(64, avg_degree=3, seed=0)
    mgr = ViewManager(fallback_threshold=1.0)
    view = mgr.create_graph_view("pr", "pagerank", indptr, indices, 64,
                                 num_shards=2, max_iters=80, device="cpu")
    q0 = mgr.query("pr")
    assert mgr.query("pr") is q0                 # cached by version
    assert mgr.refresh("pr")["pr"].mode == "noop"
    assert view.version == 0 and mgr.query("pr") is q0
    _, res = view.rule.resume(view, view.state)
    assert int(res.stats.iterations) == 0        # converged: zero strata
    mgr.mutate("pr", EdgeInsert(1, 2))
    assert mgr.refresh("pr")["pr"].version == 1
    assert mgr.query("pr") is not q0


def test_shard_map_view_world1_equals_simulated(tmp_path):
    """A view on the shard_map backend, a gloo world of one rank, replays
    the simulated view's cold run and repair; without a process group it
    raises, and an unknown backend raises."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group
    indptr, indices = make_powerlaw_graph(64, avg_degree=3, seed=0)
    with pytest.raises(ValueError, match="process group"):
        port_view("sssp", indptr, indices, 64, True, backend="shard_map",
                  mesh=None, axis_name="shards")
    init_shard_group("gloo", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    try:
        got = []
        for params in ({}, dict(backend="shard_map", mesh=None,
                                axis_name="shards")):
            mgr, view = port_view("sssp", indptr, indices, 64, True,
                                  source=0, **params)
            mgr.mutate("v", EdgeInsert(0, 9), EdgeInsert(9, 33))
            mgr.refresh("v", force="repair")
            got.append(snapshot(view))
        assert view.rule.resume_executor.backend == "shard_map"
    finally:
        dist.destroy_process_group()
    assert_same(*got)
    with pytest.raises(ValueError):
        port_view("sssp", indptr, indices, 64, True, backend="pmap")
    # mesh and axis_name mean nothing on the simulated backend.
    _, view = port_view("sssp", indptr, indices, 64, True, mesh=None,
                        axis_name="shards")
    assert view.rule.executor.backend == "simulated"


# ---------------------------------------------------------------------------
# Journals across the two packages
# ---------------------------------------------------------------------------

def journal_workload(mgr, muts_of, rng, kw):
    """Create an SSSP and a k-means view on ``mgr``, then three batches of
    each; ``muts_of`` maps reference mutations to the manager's."""
    pts = np.concatenate([rng.normal((0, 0), .3, (30, 2)),
                          rng.normal((3, 3), .3, (30, 2))]).astype(np.float32)
    indptr, indices = make_powerlaw_graph(128, avg_degree=3, seed=6)
    km = mgr.create_kmeans_view("km", pts, k=2, num_shards=2, seed=3, **kw)
    mgr.create_graph_view("sp", "sssp", indptr, indices, 128, num_shards=S,
                          source=0, max_iters=100, **kw)
    for force in (None, None, "cold"):
        slots = np.flatnonzero(km.store.to_arrays()["valid"])
        mgr.mutate("km", *muts_of([
            JPointInsert(float(rng.normal(3)), float(rng.normal(3))),
            JPointRemove(int(rng.choice(slots)))]))
        mgr.mutate("sp", *muts_of(random_edge_batch(mgr["sp"].store, rng, 2,
                                                    2)))
        mgr.refresh(force=force)


def views_equal(a, b):
    for name in ("km", "sp"):
        assert a[name].version == b[name].version == 3
        np.testing.assert_array_equal(np.asarray(a.query(name)),
                                      np.asarray(b.query(name)))
        for x, y in zip(a[name].state, b[name].state):
            x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
            y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
            np.testing.assert_array_equal(x, y)


def test_reference_journal_restores_in_the_port(tmp_path):
    root = str(tmp_path / "journal")
    jmgr = JViewManager(journal_root=root, fallback_threshold=1.0)
    journal_workload(jmgr, list, np.random.default_rng(0), {})
    views_equal(jmgr, ViewManager.restore(root, device="cpu"))


def test_port_journal_restores_in_the_reference(tmp_path):
    root = str(tmp_path / "journal")
    tmgr = ViewManager(journal_root=root, fallback_threshold=1.0)
    journal_workload(tmgr, to_port, np.random.default_rng(0),
                     dict(device="cpu"))
    views_equal(JViewManager.restore(root), tmgr)
    # checkpoint() truncates the replay; drop() purges the view.
    tmgr.checkpoint()
    views_equal(ViewManager.restore(root, device="cpu"), tmgr)
    tmgr.drop("sp")
    assert set(ViewManager.restore(root, device="cpu").views) == {"km"}
