"""The port's delta layer against the reference's, on identical inputs.

Mirrors tests/test_delta_core.py and tests/test_rehash_strategies.py: the
route functions over add/min/max/replace, overflowing capacities,
all-padding buffers, out-of-range owners, and the block and hash schemes,
plus the buffer helpers, the partition snapshot, the sender-side combiner
and the emission functions.  Everything here must match exactly: keys,
ann, count, overflowed, and payload bits (the port keeps the reference's
addition order on the CPU).
"""
import gc

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
import torch

from repro.algorithms import emission as j_emission
from repro.core import delta as J
from repro.core.handlers import pre_aggregate as j_pre_aggregate
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr

from repro_torch import convert
from repro_torch.algorithms import emission as t_emission
from repro_torch.core import delta as T
from repro_torch.core.handlers import pre_aggregate as t_pre_aggregate
from repro_torch.data.graphs import CSRGraph
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


def _buffer(rng, n, keyspace, w=2, ann=None):
    count = int(rng.integers(0, n + 1))          # 0 = all-padding buffer
    keys = np.full(n, -1, np.int32)
    keys[:count] = rng.integers(0, keyspace, count)
    pay = rng.normal(size=(n, w)).astype(np.float32)
    pay[count:] = 0
    ann = np.full(n, J.ANN_ADJUST, np.int8) if ann is None else ann
    return dict(keys=keys, payload=pay, ann=ann, count=np.int32(count),
                overflowed=np.bool_(rng.integers(0, 2)))


def _both(b):
    jdb = J.DeltaBuffer(**{k: jnp.asarray(v) for k, v in b.items()})
    return jdb, convert.to_torch(T.DeltaBuffer, b, "cpu")


def _assert_same(ref, got):
    got = convert.to_numpy(got)
    for f in ("keys", "payload", "ann", "count", "overflowed"):
        a = np.asarray(getattr(ref, f))
        assert a.dtype == got[f].dtype, f
        np.testing.assert_array_equal(a, got[f], err_msg=f)


def _owners(jsnap, snap, jdb, db, shards, corrupt):
    jo, to = jsnap.owner_of(jdb.keys), snap.owner_of(db.keys)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    if corrupt:
        # Out-of-range owners drop the whole key; corrupt per key VALUE so
        # the assignment stays a function of the key.
        jo = jnp.where((jdb.keys % 5 == 0) & (jdb.keys >= 0), shards + 3, jo)
        to = torch.where((db.keys % 5 == 0) & (db.keys >= 0), shards + 3, to)
    return jo, to


ROUTES = ["route_by_owner", "combine_route", "combine_route_scatter"]


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 9999), shards=st.sampled_from([1, 2, 4, 5, 8]),
       combiner=st.sampled_from(["add", "min", "max", "replace"]),
       cap=st.sampled_from([1, 7, 49]))           # small caps overflow
@pytest.mark.parametrize("route", ROUTES)
def test_route_parity(route, seed, shards, combiner, cap):
    rng = np.random.default_rng(seed)
    n, keyspace = 48, 24
    jdb, db = _both(_buffer(rng, n, keyspace,
                            ann=rng.integers(0, 4, n).astype(np.int8)))
    scheme = ("block", "hash")[seed % 2]
    jsnap = JSnapshot(n_keys=keyspace, num_shards=shards, scheme=scheme)
    snap = convert.snapshot(jsnap)
    jo, to = _owners(jsnap, snap, jdb, db, shards,
                     corrupt=route != "route_by_owner")
    if route == "route_by_owner":
        ref = J.route_by_owner(jdb, jo, shards, cap)
        got = T.route_by_owner(db, to, shards, cap)
    elif route == "combine_route":
        ref = J.combine_route(jdb, jo, shards, cap, combiner)
        got = T.combine_route(db, to, shards, cap, combiner)
    else:
        ref = J.combine_route_scatter(jdb, jo, shards, cap, combiner,
                                      snapshot=jsnap)
        got = T.combine_route_scatter(db, to, shards, cap, combiner,
                                      snapshot=snap)
    _assert_same(ref, got)


@pytest.mark.parametrize("route", ROUTES)
def test_route_all_padding(route):
    jdb = J.DeltaBuffer.empty(16, 1)
    db = T.DeltaBuffer.empty(16, 1, device="cpu")
    jsnap = JSnapshot(n_keys=32, num_shards=4)
    snap = convert.snapshot(jsnap)
    jo = jnp.full((16,), -1, jnp.int32)
    to = torch.full((16,), -1, dtype=torch.int32)
    if route == "route_by_owner":
        ref, got = J.route_by_owner(jdb, jo, 4, 8), T.route_by_owner(db, to,
                                                                     4, 8)
    elif route == "combine_route":
        ref, got = (J.combine_route(jdb, jo, 4, 8, "add"),
                    T.combine_route(db, to, 4, 8, "add"))
    else:
        ref = J.combine_route_scatter(jdb, jo, 4, 8, "add", snapshot=jsnap)
        got = T.combine_route_scatter(db, to, 4, 8, "add", snapshot=snap)
    _assert_same(ref, got)
    assert int(got.count) == 0 and bool((got.keys == T.PAD_KEY).all())


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 999),
       combiner=st.sampled_from(["add", "min", "max", "replace"]),
       cap=st.sampled_from([5, 60]))
def test_buffer_helpers(seed, combiner, cap):
    """from_dense_mask (with and without ann), to_dense and concat."""
    rng = np.random.default_rng(seed)
    n = 40
    mask = rng.random(n) < 0.5
    keys = rng.integers(0, 30, n).astype(np.int32)
    pay = rng.normal(size=(n, 1)).astype(np.float32)
    ann = rng.integers(0, 4, n).astype(np.int8)
    for a in (None, ann):
        ref = J.DeltaBuffer.from_dense_mask(
            jnp.asarray(mask), jnp.asarray(keys), jnp.asarray(pay), cap,
            ann=None if a is None else jnp.asarray(a))
        got = T.DeltaBuffer.from_dense_mask(
            torch.from_numpy(mask), torch.from_numpy(keys),
            torch.from_numpy(pay), cap,
            ann=None if a is None else torch.from_numpy(a))
        _assert_same(ref, got)
    jdb, db = _both(_buffer(rng, n, 30, w=1))
    np.testing.assert_array_equal(np.asarray(jdb.to_dense(30, combiner)),
                                  db.to_dense(30, combiner).numpy())
    jdb2, db2 = _both(_buffer(rng, n, 30, w=1))
    _assert_same(J.concat(jdb, jdb2, cap), T.concat(db, db2, cap))
    _assert_same(J.recount(jdb2), T.recount(db2))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 999),
       combiner=st.sampled_from(["add", "min", "max"]))
def test_pre_aggregate_parity(seed, combiner):
    """The sender-side combiner (replace is not compared: the reference's
    duplicate-index set has no defined winner)."""
    rng = np.random.default_rng(seed)
    jdb, db = _both(_buffer(rng, 32, 8, w=1))
    _assert_same(j_pre_aggregate(jdb, combiner),
                 t_pre_aggregate(db, combiner))


@pytest.mark.parametrize("scheme", ["block", "hash"])
def test_partition_snapshot(scheme):
    keys = np.array([-1, 0, 1, 7, 99, 2**20 + 3, 2**31 - 1], np.int32)
    jsnap = JSnapshot(n_keys=100, num_shards=7, scheme=scheme)
    snap = convert.snapshot(jsnap)
    assert (snap.block_size, snap.padded_keys) == (jsnap.block_size,
                                                   jsnap.padded_keys)
    for f in ("owner_of", "local_index"):
        a = np.asarray(getattr(jsnap, f)(jnp.asarray(keys)))
        b = getattr(snap, f)(torch.from_numpy(keys)).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert convert.snapshot_fields(snap)["scheme"] == scheme


@pytest.fixture(scope="module")
def shard_graphs():
    n, S = 512, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=8.0, seed=1)
    jg = j_shard_csr(indptr, indices, S)
    return jg, convert.to_torch(CSRGraph, jg, "cpu"), n // S


@pytest.mark.parametrize("src_cap,edge_cap", [(128, 2048), (16, 64)])
def test_emission_parity(shard_graphs, src_cap, edge_cap):
    """emit_over_edges (incl. overflow), dense_push and scatter_local."""
    jg, tg, block = shard_graphs
    rng = np.random.default_rng(src_cap)
    for s in (1,):
        jshard = jax.tree.map(lambda x, s=s: x[s], jg)
        tshard = CSRGraph(tg.indptr[s], tg.indices[s], tg.out_degree[s])
        active = rng.random(block) < 0.3
        pay = rng.random(block).astype(np.float32)
        ref = j_emission.emit_over_edges(jshard, jnp.asarray(active),
                                         jnp.asarray(pay), src_cap, edge_cap)
        got = t_emission.emit_over_edges(tshard, torch.from_numpy(active),
                                         torch.from_numpy(pay), src_cap,
                                         edge_cap)
        _assert_same(ref, got)
        for a, b in zip(j_emission.dense_push(jshard, jnp.asarray(pay)),
                        t_emission.dense_push(tshard, torch.from_numpy(pay))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        incoming = J.DeltaBuffer(
            keys=jnp.where(ref.keys >= 0, ref.keys % block + s * block,
                           -1).astype(jnp.int32),
            payload=ref.payload, ann=ref.ann, count=ref.count,
            overflowed=ref.overflowed)
        tin = convert.to_torch(T.DeltaBuffer, incoming, "cpu")
        for comb in ("add", "min", "max"):
            np.testing.assert_array_equal(
                np.asarray(j_emission.scatter_local(incoming, s, block,
                                                    comb)),
                t_emission.scatter_local(tin, s, block, comb).numpy())


def test_graph_helpers_match():
    """Same seed, same graph; same sharding and edge-list round trips."""
    from repro.data import graphs as JG
    from repro_torch.data import graphs as TG
    a = JG.make_powerlaw_graph(700, 9.0, 2.0, seed=3)
    b = TG.make_powerlaw_graph(700, 9.0, 2.0, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    got = convert.to_numpy(TG.shard_csr(*b, 3, nnz_capacity=4000,
                                        device="cpu"))
    ref = JG.shard_csr(*a, 3, nnz_capacity=4000)
    for f, v in got.items():
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), v)
    gl = convert.to_numpy(TG.global_csr(*b, device="cpu"))
    for f, v in gl.items():
        np.testing.assert_array_equal(
            np.asarray(getattr(JG.global_csr(*a), f)), v)
    src, dst = TG.csr_to_edges(*b)
    for x, y in zip(JG.edges_to_csr(src, dst, 700),
                    TG.edges_to_csr(src, dst, 700)):
        np.testing.assert_array_equal(x, y)
    n, g = TG.load_dataset("dbpedia-small", 4, device="cpu")
    jn, jg = JG.load_dataset("dbpedia-small", 4)
    assert n == jn
    np.testing.assert_array_equal(np.asarray(jg.indices), g.indices.numpy())
