"""The port's four kernels against the reference's Pallas kernels.

Each plain torch version (``ref.py``) is held against the reference's
Pallas function run in interpret mode on the CPU, and each wrapper on CPU
tensors against the reference's ops wrapper, on identical numpy inputs.
Integer outputs and min/max payloads are exact.  Add-combined floats are
exact against the reference's own plain oracle (``ref.py``, slot order).
The Pallas kernels sum by a one-hot contraction, another addition order,
so against them add-combined floats are held to the rounding bound of a
reordered float32 sum (``assert_reordered_sum``); the ulp gaps this leaves
are recorded in ROADMAP.md queue 3.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.algorithms.emission import to_local_keys as j_to_local_keys
from repro.core.delta import ANN_ADJUST as J_ANN_ADJUST
from repro.core.delta import DeltaBuffer as JDeltaBuffer
from repro.core.delta import combine_route_scatter as j_combine_route_scatter
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph
from repro.data.graphs import shard_csr as j_shard_csr
from repro.kernels.delta_route import delta_route as j_delta_route
from repro.kernels.delta_route import route_deltas as j_route_deltas
from repro.kernels.delta_scatter import apply_delta as j_apply_delta
from repro.kernels.delta_scatter import delta_scatter as j_delta_scatter
from repro.kernels.delta_scatter.ref import \
    delta_scatter_ref as j_delta_scatter_ref
from repro.kernels.edge_propagate import build_tiled_csc
from repro.kernels.edge_propagate import edge_propagate as j_edge_propagate
from repro.kernels.edge_propagate.ref import \
    edge_propagate_ref as j_edge_propagate_ref
from repro.kernels.scatter_route import scatter_route as j_scatter_route
from repro.kernels.scatter_route import \
    scatter_route_deltas as j_scatter_route_deltas
from repro.kernels.scatter_route.ref import \
    scatter_route_ref as j_scatter_route_ref

from repro_torch import convert
from repro_torch.algorithms.emission import fold as t_fold
from repro_torch.algorithms.emission import to_local_keys as t_to_local_keys
from repro_torch.core.delta import DeltaBuffer
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph
from repro_torch.kernels import delta_route as t_dr
from repro_torch.kernels import delta_scatter as t_ds
from repro_torch.kernels import edge_propagate as t_ep
from repro_torch.kernels import scatter_route as t_sr
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


U32 = 2.0 ** -24      # float32 unit roundoff


def t(x):
    return torch.from_numpy(np.array(x))


def assert_reordered_sum(got, other, terms, abs_sum):
    """``got`` and ``other`` are float32 sums of the same ``terms`` terms
    per element, added in different orders.  Any order lands within
    gamma_k * sum|x| of the exact sum (k = terms, gamma_k = k u / (1 - k u);
    Higham, Accuracy and Stability of Numerical Algorithms, §4.2), so the
    two differ by at most twice that."""
    k = np.asarray(terms, np.float64)
    gamma = k * U32 / (1 - k * U32)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(other, np.float64))
    bound = 2 * gamma * np.asarray(abs_sum, np.float64)
    assert np.all(diff <= bound), float(np.max(diff - bound))


def _buffer(rng, n, keyspace, w, count=None, ann=None):
    count = int(rng.integers(0, n + 1)) if count is None else count
    keys = np.full(n, -1, np.int32)
    keys[:count] = rng.integers(0, keyspace, count)
    pay = rng.normal(size=(n, w)).astype(np.float32)
    ann = np.full(n, J_ANN_ADJUST, np.int8) if ann is None else ann
    return dict(keys=keys, payload=pay, ann=ann, count=np.int32(count),
                overflowed=np.bool_(False))


def _jdb(b):
    return JDeltaBuffer(**{k: jnp.asarray(v) for k, v in b.items()})


def _assert_buffers(ref, got, reordered=None):
    """ref: reference DeltaBuffer; got: the port's.  Payloads are exact,
    or, with ``reordered=(terms, abs_sum)``, a reordered sum of the same
    terms."""
    got = convert.to_numpy(got)
    for f in ("keys", "ann", "count", "overflowed"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), got[f],
                                      err_msg=f)
    if reordered is None:
        np.testing.assert_array_equal(np.asarray(ref.payload),
                                      got["payload"])
    else:
        assert_reordered_sum(got["payload"], ref.payload, *reordered)


# ---------------------------------------------------------------------------
# scatter_route (Pallas kernel #1)
# ---------------------------------------------------------------------------
class TestScatterRoute:
    @pytest.mark.parametrize("c,w,shards,block,cap", [
        (256, 1, 4, 64, 32), (512, 2, 8, 32, 32), (512, 1, 7, 40, 8)])
    def test_ref_vs_pallas(self, c, w, shards, block, cap):
        rng = np.random.default_rng(c + shards)
        keys = rng.integers(-1, shards * block, size=c).astype(np.int32)
        pay = rng.normal(size=(c, w)).astype(np.float32)
        owners = np.where(keys >= 0, keys // block, shards).astype(np.int32)
        local = np.where(keys >= 0, keys % block, -1).astype(np.int32)
        jargs = [jnp.asarray(x) for x in (keys, pay, local, owners)]
        jk, jp, ja = j_scatter_route(*jargs, shards, block, cap,
                                     interpret=True)
        plain = j_scatter_route_ref(*jargs, shards, block, cap)
        targs = (t(local), t(owners), shards, block, cap)
        tk, tp, ta, per_owner = t_sr.scatter_route_ref(t(keys), t(pay),
                                                       *targs)
        for j in (jk, plain[0]):
            np.testing.assert_array_equal(np.asarray(j), tk.numpy())
        for j in (ja, plain[2]):
            np.testing.assert_array_equal(np.asarray(j), ta.numpy())
        np.testing.assert_array_equal(np.asarray(plain[1]), tp.numpy())
        terms = t_sr.scatter_route_ref(t(keys), torch.ones(c, w).double(),
                                       *targs)[1]
        abs_sum = t_sr.scatter_route_ref(t(keys), t(np.abs(pay)).double(),
                                         *targs)[1]
        assert_reordered_sum(tp, jp, terms, abs_sum)
        live = (keys >= 0)
        distinct = [len(set(keys[live & (owners == s)].tolist()))
                    for s in range(shards)]
        assert per_owner.tolist() == distinct
        assert ta.dtype == torch.int8 and tk.dtype == torch.int32

    @pytest.mark.parametrize("combiner", ["add", "min", "max", "replace"])
    @pytest.mark.parametrize("scheme", ["block", "hash"])
    def test_wrapper_cpu_vs_reference_ops(self, combiner, scheme):
        rng = np.random.default_rng(7)
        n, shards, cap, keyspace = 300, 6, 40, 500
        b = _buffer(rng, n, keyspace, 2, count=250)
        jsnap = JSnapshot(n_keys=keyspace, num_shards=shards, scheme=scheme)
        snap = convert.snapshot(jsnap)
        jdb = _jdb(b)
        ref = j_scatter_route_deltas(jdb, jsnap.owner_of(jdb.keys), shards,
                                     cap, combiner, snapshot=jsnap)
        plain = j_combine_route_scatter(jdb, jsnap.owner_of(jdb.keys), shards,
                                        cap, combiner, snapshot=jsnap)
        db = convert.to_torch(DeltaBuffer, b, "cpu")

        def route(payload):
            return t_sr.scatter_route_deltas(
                dataclasses.replace(db, payload=payload),
                snap.owner_of(db.keys), shards, cap, combiner, snapshot=snap)

        got = route(db.payload)
        _assert_buffers(plain, got)
        if combiner == "add" and scheme == "block":
            # The reference wrapper's add goes through the Pallas
            # contraction.
            _assert_buffers(ref, got, reordered=(
                route(torch.ones_like(db.payload).double()).payload,
                route(db.payload.abs().double()).payload))
        else:
            _assert_buffers(ref, got)

    def test_overflow_keeps_smallest_keys(self):
        snap = PartitionSnapshot(n_keys=64, num_shards=2)
        keys = torch.tensor([9, 3, 7, 3, 1, 40], dtype=torch.int32)
        db = DeltaBuffer(keys=keys, payload=torch.ones(6, 1),
                         ann=torch.full((6,), 3, dtype=torch.int8),
                         count=torch.tensor(6, dtype=torch.int32),
                         overflowed=torch.tensor(False))
        out = t_sr.scatter_route_deltas(db, snap.owner_of(keys), 2, 3,
                                        snapshot=snap)
        assert out.keys.tolist() == [1, 3, 7, 40, -1, -1]
        assert out.payload[:, 0].tolist() == [1.0, 2.0, 1.0, 1.0, 0.0, 0.0]
        assert bool(out.overflowed) and int(out.count) == 4


# ---------------------------------------------------------------------------
# delta_route (Pallas kernel #2)
# ---------------------------------------------------------------------------
class TestDeltaRoute:
    @pytest.mark.parametrize("c,w,shards,cap", [
        (256, 1, 4, 64), (512, 2, 8, 32), (1024, 1, 7, 8)])
    def test_ref_vs_pallas(self, c, w, shards, cap):
        rng = np.random.default_rng(c + shards)
        keys = rng.integers(-1, 1000, size=c).astype(np.int32)
        pay = rng.normal(size=(c, w)).astype(np.float32)
        ann = rng.integers(0, 4, size=c).astype(np.int32)
        owners = np.where(keys >= 0, keys % shards, shards).astype(np.int32)
        out_j = j_delta_route(jnp.asarray(keys), jnp.asarray(pay),
                              jnp.asarray(ann), jnp.asarray(owners), shards,
                              cap, interpret=True)
        out_t = t_dr.delta_route_ref(t(keys), t(pay), t(ann), t(owners),
                                     shards, cap)
        for a, b in zip(out_j, out_t[:3]):
            np.testing.assert_array_equal(np.asarray(a),
                                          b.numpy().astype(np.asarray(a).dtype))
        live = keys >= 0
        assert out_t[3].tolist() == [int(np.sum(live & (owners == s)))
                                     for s in range(shards)]

    @pytest.mark.parametrize("count,cap", [(250, 40), (0, 8), (300, 3)])
    def test_wrapper_cpu_vs_reference_ops(self, count, cap):
        rng = np.random.default_rng(count)
        n, shards = 300, 6
        b = _buffer(rng, n, 500, 2, count=count,
                    ann=rng.integers(0, 4, n).astype(np.int8))
        jdb = _jdb(b)
        owners = np.where(b["keys"] >= 0, b["keys"] % shards, shards)
        ref = j_route_deltas(jdb, jnp.asarray(owners), shards, cap)
        got = t_dr.route_deltas(convert.to_torch(DeltaBuffer, b, "cpu"),
                                t(owners.astype(np.int32)), shards, cap)
        _assert_buffers(ref, got)


# ---------------------------------------------------------------------------
# delta_scatter (Pallas kernel #3)
# ---------------------------------------------------------------------------
class TestDeltaScatter:
    @pytest.mark.parametrize("n,w,c,combiner", [
        (512, 1, 256, "add"), (1024, 4, 512, "add"), (512, 1, 256, "min"),
        (512, 1, 256, "max")])
    def test_ref_vs_pallas(self, n, w, c, combiner):
        rng = np.random.default_rng(n + c)
        state = rng.normal(size=(n, w)).astype(np.float32)
        idx = rng.integers(-1, n + 3, size=c).astype(np.int32)
        in_range = np.where(idx < n, idx, -1).astype(np.int32)
        pay = rng.normal(size=(c, w)).astype(np.float32)
        out_j = j_delta_scatter(jnp.asarray(state), jnp.asarray(in_range),
                                jnp.asarray(pay), combiner, tile_n=256,
                                chunk=256, interpret=True)
        out_t = t_ds.delta_scatter_ref(t(state), t(in_range), t(pay),
                                       combiner)
        plain = j_delta_scatter_ref(jnp.asarray(state), jnp.asarray(idx),
                                    jnp.asarray(pay), combiner)
        np.testing.assert_array_equal(np.asarray(plain), out_t.numpy())
        if combiner == "add":
            terms = t_ds.delta_scatter_ref(torch.ones(n, w).double(),
                                           t(in_range),
                                           torch.ones(c, w).double())
            abs_sum = t_ds.delta_scatter_ref(t(np.abs(state)).double(),
                                             t(in_range),
                                             t(np.abs(pay)).double())
            assert_reordered_sum(out_t, out_j, terms, abs_sum)
        else:
            np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
        # idx >= N is dropped like the -1 padding.
        np.testing.assert_array_equal(
            t_ds.delta_scatter_ref(t(state), t(idx), t(pay),
                                   combiner).numpy(), out_t.numpy())

    @pytest.mark.parametrize("w,combiner", [(1, "add"), (4, "add"),
                                            (1, "min"), (1, "max")])
    @pytest.mark.parametrize("shard", [0, 1, 3])
    def test_key_base_vs_pallas_on_local_keys(self, w, combiner, shard):
        """Global keys with ``key_base = shard * block`` against the
        reference's kernel on keys made local by its ``to_local_keys``;
        bit for bit against ``fold`` on the port's ``to_local_keys``."""
        block, shards, c = 512, 4, 512
        rng = np.random.default_rng(100 * shard + w)
        # PAD, keys of every shard (below and above this block) and keys
        # past the last shard.
        keys = rng.integers(-1, shards * block + 7, size=c).astype(np.int32)
        keys[:8] = [-1, 0, shard * block - 1, shard * block,
                    (shard + 1) * block - 1, (shard + 1) * block,
                    shards * block, -1]
        state = rng.normal(size=(block, w)).astype(np.float32)
        pay = rng.normal(size=(c, w)).astype(np.float32)
        b = dict(keys=keys, payload=pay,
                 ann=np.full(c, J_ANN_ADJUST, np.int8),
                 count=np.int32(c), overflowed=np.bool_(False))
        j_local = j_to_local_keys(_jdb(b), jnp.int32(shard), block)
        out_j = j_delta_scatter(jnp.asarray(state), j_local, jnp.asarray(pay),
                                combiner, tile_n=256, chunk=256,
                                interpret=True)
        plain = j_delta_scatter_ref(jnp.asarray(state), j_local,
                                    jnp.asarray(pay), combiner)
        got = t_ds.delta_scatter_ref(t(state), t(keys), t(pay), combiner,
                                     key_base=shard * block)
        local = t_to_local_keys(convert.to_torch(DeltaBuffer, b, "cpu"),
                                shard, block)
        np.testing.assert_array_equal(np.asarray(j_local), local.numpy())
        np.testing.assert_array_equal(
            t_fold(t(state), local, t(pay), combiner).numpy(), got.numpy())
        np.testing.assert_array_equal(
            t_ds.delta_scatter(t(state), t(keys), t(pay), combiner,
                               key_base=shard * block).numpy(), got.numpy())
        np.testing.assert_array_equal(np.asarray(plain), got.numpy())
        if combiner == "add":
            in_block = t(np.asarray(j_local))
            terms = t_ds.delta_scatter_ref(torch.ones(block, w).double(),
                                           in_block,
                                           torch.ones(c, w).double())
            abs_sum = t_ds.delta_scatter_ref(t(np.abs(state)).double(),
                                             in_block,
                                             t(np.abs(pay)).double())
            assert_reordered_sum(got, out_j, terms, abs_sum)
        else:
            np.testing.assert_array_equal(np.asarray(out_j), got.numpy())

    def test_negative_key_base_raises(self):
        x = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="key_base"):
            t_ds.delta_scatter(torch.zeros(4, 1), x, torch.zeros(4, 1),
                               key_base=-1)

    def test_wrapper_cpu_vs_reference_ops(self):
        rng = np.random.default_rng(3)
        n = 512
        b = _buffer(rng, 64, n, 1)
        state = rng.normal(size=n).astype(np.float32)
        ref = j_apply_delta(jnp.asarray(state), _jdb(b), "add",
                            use_kernel=False)
        got = t_ds.apply_delta(t(state), convert.to_torch(DeltaBuffer, b,
                                                          "cpu"), "add")
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---------------------------------------------------------------------------
# edge_propagate (Pallas kernel #4)
# ---------------------------------------------------------------------------
class TestEdgePropagate:
    @pytest.mark.parametrize("n,deg", [(600, 6.0), (1500, 12.0)])
    @pytest.mark.parametrize("combiner", ["add", "min", "max"])
    def test_ref_vs_pallas(self, n, deg, combiner):
        indptr, indices = make_powerlaw_graph(n, avg_degree=deg, seed=n)
        rng = np.random.default_rng(1)
        payload = rng.normal(size=n).astype(np.float32)
        src_j, dstl_j, w_j = build_tiled_csc(indptr, indices, n, tile_n=512,
                                             chunk=256)
        n_pad = src_j.shape[0] * 512
        out_j = np.asarray(j_edge_propagate(jnp.asarray(payload), src_j,
                                            dstl_j, w_j, n_pad, combiner,
                                            interpret=True))[:n]
        graph = CSRGraph(indptr=t(indptr.astype(np.int32)),
                         indices=t(indices),
                         out_degree=t(np.diff(indptr).astype(np.int32)))
        csc = t_ep.build_csc(graph, n)
        plain_csc = (csc.indptr, csc.src, csc.weight)
        out_t = t_ep.edge_propagate_ref(t(payload), *plain_csc,
                                        combiner).numpy()
        plain = np.asarray(j_edge_propagate_ref(jnp.asarray(payload), src_j,
                                                dstl_j, w_j, n_pad,
                                                combiner))[:n]
        np.testing.assert_array_equal(plain, out_t)
        if combiner == "add":
            terms = t_ep.edge_propagate_ref(torch.ones(n).double(),
                                            *plain_csc)
            abs_sum = t_ep.edge_propagate_ref(t(np.abs(payload)).double(),
                                              *plain_csc)
            assert_reordered_sum(out_t, out_j, terms, abs_sum)
        else:
            np.testing.assert_array_equal(out_j, out_t)

    def test_csc_is_ragged_and_stable(self):
        indptr = np.array([0, 2, 3, 5], np.int64)
        indices = np.array([2, 0, 2, 2, -1], np.int32)
        graph = CSRGraph(indptr=t(indptr.astype(np.int32)), indices=t(indices),
                         out_degree=t(np.diff(indptr).astype(np.int32)))
        csc = t_ep.build_csc(graph, 4)
        assert csc.indptr.tolist() == [0, 1, 1, 4, 4]
        assert csc.src.tolist() == [0, 0, 1, 2]      # CSR order per dst
        assert csc.weight.tolist() == [1.0] * 4
        assert csc.heavy.dtype == torch.int32 and csc.heavy.tolist() == []

    @pytest.mark.parametrize("graph", ["toy_boundary", "powerlaw"])
    def test_csc_heavy_list_is_the_rows_past_a_warp(self, graph):
        """build_csc's heavy list holds, in order, exactly the destinations
        of more than HEAVY_EDGES (32) edges: at the 32/33 boundary, and on
        a 50,000-vertex power-law graph whose head rows cross it."""
        if graph == "toy_boundary":
            # Destinations 1, 3 and 4 get 33, 32 and 34 edges from 3
            # sources; 0 and 2 get one each; padding slots are dropped.
            dst = [1] * 33 + [3] * 32 + [4] * 34 + [0, 2, -1, -1]
            indices = np.array(dst, np.int32)
            indptr = np.array([0, 40, 80, len(dst)], np.int64)
            n = 5
        else:
            n = 50_000
            indptr, indices = make_powerlaw_graph(n, avg_degree=14.5,
                                                  seed=0)
        g = CSRGraph(indptr=t(indptr.astype(np.int32)), indices=t(indices),
                     out_degree=t(np.diff(indptr).astype(np.int32)))
        csc = t_ep.build_csc(g, n)
        in_deg = np.bincount(indices[indices >= 0], minlength=n)
        want = np.flatnonzero(in_deg > t_ep.HEAVY_EDGES)
        assert t_ep.HEAVY_EDGES == 32
        assert csc.heavy.dtype == torch.int32
        np.testing.assert_array_equal(csc.heavy.numpy(), want)
        np.testing.assert_array_equal(np.diff(csc.indptr.numpy()), in_deg)
        if graph == "toy_boundary":
            assert csc.heavy.tolist() == [1, 4]
        else:
            assert 0 < len(want) < n // 10   # the head rows, not the tail

    def test_heavy_list_is_derived_from_indptr(self):
        """A RaggedCSC's heavy list is made from its indptr and cannot be
        set: not by the constructor, not by assignment, and
        dataclasses.replace derives it again from the new indptr."""
        import dataclasses
        indptr = t(np.array([0, 40, 41, 41, 75], np.int32))
        src = torch.zeros(75, dtype=torch.int32)
        csc = t_ep.RaggedCSC(indptr, src, torch.ones(75))
        assert csc.heavy.dtype == torch.int32
        assert csc.heavy.tolist() == [0, 3]
        with pytest.raises(TypeError):
            t_ep.RaggedCSC(indptr, src, torch.ones(75), heavy=csc.heavy)
        with pytest.raises(dataclasses.FrozenInstanceError):
            csc.heavy = csc.heavy[:0]
        light = dataclasses.replace(
            csc, indptr=t(np.array([0, 20, 41, 41, 75], np.int32)))
        assert light.heavy.tolist() == [3]

    def test_wrapper_cpu_equals_dense_push_scatter(self):
        """edge_propagate over the ragged CSC == the reference's dense body
        (dense_push + scatter-add), bit for bit on the CPU."""
        from repro.algorithms.emission import dense_push
        n, S = 1024, 4
        indptr, indices = make_powerlaw_graph(n, avg_degree=8.0, seed=3)
        jg = j_shard_csr(indptr, indices, S)
        tg = convert.to_torch(CSRGraph, jg, "cpu")
        rng = np.random.default_rng(5)
        block = n // S
        for s in range(S):
            pay = rng.random(block).astype(np.float32)
            jshard = jax.tree.map(lambda x, s=s: x[s], jg)
            dst, p = dense_push(jshard, jnp.asarray(pay))
            ref = jnp.zeros((n + 1,)).at[jnp.where(dst >= 0, dst, n)].add(
                p, mode="drop")[:n]
            tshard = CSRGraph(tg.indptr[s], tg.indices[s], tg.out_degree[s])
            got = t_ep.edge_propagate(t(pay), t_ep.build_csc(tshard, n))
            np.testing.assert_array_equal(np.asarray(ref), got.numpy())
