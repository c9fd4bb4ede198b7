"""The port's SSSP and connected components against the reference's.

Same graph (``dbpedia-small``), same snapshot, same settings, under the
``sort``, ``auto`` and ``nodelta`` routes, with the capacity ladder off and
on, and with the port's kernels on (their plain versions run on the CPU)
and off.  Min is order-free, so values, iterations and every per-stratum
statistic must be equal.  Also: the dense-fallback check and the
shard-invariance property of ``tests/test_algorithms.py``, the port's
oracles against the reference's,
and ``scatter_route``'s plain version under min and max against the
reference's oracle.
"""
import gc

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.algorithms import connected_components as JCC
from repro.algorithms import sssp as JSP
from repro.core import fixpoint as JF
from repro.core.engine import ShardedExecutor as JExecutor
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import DATASETS, make_powerlaw_graph
from repro.data.graphs import shard_csr as j_shard_csr
from repro.kernels.scatter_route.ref import \
    scatter_route_ref as j_scatter_route_ref

from repro_torch import convert
from repro_torch.algorithms import connected_components as TCC
from repro_torch.algorithms import sssp as TSP
from repro_torch.core import fixpoint as TF
from repro_torch.data.graphs import CSRGraph
from repro_torch.kernels import scatter_route as t_sr
from torch_threads import one_torch_thread  # noqa: F401

S = 4
CAP = dict(edge_capacity=8192, src_capacity=1024)
ALGOS = {"sssp": (JSP, TSP), "cc": (JCC, TCC)}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def setup():
    n, avg, alpha = DATASETS["dbpedia-small"]
    indptr, indices = make_powerlaw_graph(n, avg, alpha, seed=0)
    jg = j_shard_csr(indptr, indices, S)
    jsnap = JSnapshot(n_keys=n, num_shards=S)
    return dict(n=n, indptr=indptr, indices=indices, jg=jg, jsnap=jsnap,
                tg=convert.to_torch(CSRGraph, jg, "cpu"),
                snap=convert.snapshot(jsnap), ref_runs={})


def _reference(setup, algo, mode, route, ladder):
    key = (algo, mode, route, ladder)
    if key not in setup["ref_runs"]:
        jsnap = setup["jsnap"]
        ex = JExecutor(snapshot=jsnap, seg_capacity=CAP["edge_capacity"],
                       ladder_tiers=ladder, route_strategy=route, **CAP)
        mod = ALGOS[algo][0]
        kw = dict(source=0) if algo == "sssp" else {}
        setup["ref_runs"][key] = mod.run(setup["jg"], jsnap, mode=mode,
                                         max_iters=80, executor=ex, **kw,
                                         **CAP)
    return setup["ref_runs"][key]


def assert_same_run(jvals, jres, tvals, tres, fields):
    for f in JF.StratumStats._fields:
        a, b = np.asarray(getattr(jres.stats, f)), getattr(tres.stats,
                                                           f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres.state, f)),
                                      getattr(tres.state, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(jvals), tvals.numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mode,route,ladder", [
    ("delta", "sort", 1), ("delta", "sort", 4), ("delta", "auto", 1),
    ("delta", "auto", 4), ("nodelta", "sort", 1)])
@pytest.mark.parametrize("algo", ["sssp", "cc"])
def test_parity(setup, algo, mode, route, ladder, use_kernels):
    jvals, jres = _reference(setup, algo, mode, route, ladder)
    kw = dict(source=0) if algo == "sssp" else {}
    tvals, tres = ALGOS[algo][1].run(
        setup["tg"], setup["snap"], mode=mode, max_iters=80,
        ladder_tiers=ladder, route_strategy=route, device="cpu",
        use_kernels=use_kernels, **kw, **CAP)
    fields = ("dist", "sent") if algo == "sssp" else ("label", "sent")
    assert_same_run(jvals, jres, tvals, tres, fields)
    it = int(tres.stats.iterations)
    assert 1 < it < 80                                  # converged
    if mode == "delta":
        want = TF.ROUTE_SCATTER if route == "auto" else TF.ROUTE_SORT
        assert want in set(tres.stats.routes[:it].tolist())
        if ladder == 4:
            assert len(set(tres.stats.tiers[:it].tolist()) - {-1}) >= 2


def test_oracles_match_reference(setup):
    n, indptr, indices = setup["n"], setup["indptr"], setup["indices"]
    for src in (0, 17):
        np.testing.assert_array_equal(
            np.asarray(JSP.reference_sssp(indptr, indices, n, src)),
            TSP.reference_sssp(indptr, indices, n, src, device="cpu").numpy())
    ref_cc = TCC.reference_components(indptr, indices, n, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(JCC.reference_components(indptr, indices, n)),
        ref_cc.numpy())
    lab, _ = TCC.run(setup["tg"], setup["snap"], device="cpu", **CAP)
    assert torch.equal(lab[:n], ref_cc)


def test_overflow_falls_back_densely_and_stays_correct():
    """tests/test_algorithms.py's check, on the port, and equal to the
    reference's run stratum for stratum."""
    n = 256
    indptr, indices = make_powerlaw_graph(n, avg_degree=6.0, seed=7)
    jsnap = JSnapshot(n_keys=n, num_shards=4)
    jg = j_shard_csr(indptr, indices, 4)
    kw = dict(source=0, mode="delta", max_iters=60, edge_capacity=64,
              src_capacity=16)
    jd, jres = JSP.run(jg, jsnap, **kw)
    d, res = TSP.run(convert.to_torch(CSRGraph, jg, "cpu"),
                     convert.snapshot(jsnap), device="cpu", **kw)
    assert bool(res.stats.used_dense.any())          # fallback actually hit
    ref = TSP.reference_sssp(indptr, indices, n, 0, device="cpu")
    assert torch.equal(d[:n], ref)
    assert_same_run(jd, jres, d, res, ("dist", "sent"))


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 99), nshards=st.sampled_from([2, 4, 8]),
       route=st.sampled_from(["sort", "auto"]))
def test_property_shard_invariance(seed, nshards, route):
    """tests/test_algorithms.py's property, on the port: the fixpoint is
    invariant to the partition snapshot, for SSSP and CC alike."""
    n = 256
    indptr, indices = make_powerlaw_graph(n, avg_degree=6.0, seed=seed)
    jsnap = JSnapshot(n_keys=n, num_shards=nshards)
    g = convert.to_torch(CSRGraph, j_shard_csr(indptr, indices, nshards),
                         "cpu")
    snap = convert.snapshot(jsnap)
    kw = dict(mode="delta", max_iters=60, edge_capacity=4096,
              src_capacity=256, ladder_tiers=4, route_strategy=route,
              device="cpu")
    d, _ = TSP.run(g, snap, source=0, **kw)
    np.testing.assert_array_equal(
        np.asarray(JSP.reference_sssp(indptr, indices, n, 0)), d[:n].numpy())
    lab, _ = TCC.run(g, snap, **kw)
    np.testing.assert_array_equal(
        np.asarray(JCC.reference_components(indptr, indices, n)),
        lab[:n].numpy())


@pytest.mark.parametrize("combiner", ["min", "max"])
@pytest.mark.parametrize("c,w,shards,block,cap", [
    (300, 1, 4, 64, 40), (500, 2, 8, 32, 8), (64, 1, 2, 128, 128)])
def test_scatter_route_ref_min_max(combiner, c, w, shards, block, cap):
    rng = np.random.default_rng(c * w + shards)
    keys = rng.integers(-1, shards * block, size=c).astype(np.int32)
    keys[rng.random(c) < 0.2] = -1
    owners = np.where(keys >= 0, keys // block, shards).astype(np.int32)
    owners[rng.random(c) < 0.05] = shards + 1           # dropped owner
    local = np.where(keys >= 0, keys % block, -1).astype(np.int32)
    payload = rng.normal(size=(c, w)).astype(np.float32)
    args = (keys, payload, local, owners)
    jk, jp, ja = j_scatter_route_ref(*map(jnp.asarray, args), shards, block,
                                     cap, combiner)
    tk, tp, ta, per_owner = t_sr.scatter_route(
        *(torch.from_numpy(x) for x in args), shards, block, cap, combiner)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(ja).astype(np.int8), ta.numpy())
    live = (keys >= 0) & (owners < shards)
    want = [len(np.unique(keys[live & (owners == s)])) for s in range(shards)]
    assert per_owner.tolist() == want
