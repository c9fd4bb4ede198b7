"""The port's k-means slice against the reference's.

``kernels/kmeans_assign``'s plain version against the reference's plain
oracle and its Pallas kernel (interpret mode), ``data/points.py`` against
the reference's generator, and ``algorithms/kmeans.py`` (run, delta and
nodelta, masked, resume) against ``repro.algorithms.kmeans`` on identical
numpy inputs.  Assignments, stats and the engine's centroids must be
equal.  d² is exact against the plain oracle where XLA's CPU product fuses
its multiply-adds as torch's does (K >= 16 at D <= 3 here); elsewhere, and
against the Pallas kernel, it is held to the rounding bound of the same
3D terms summed in another order (readings in ROADMAP.md queue 3).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import gc

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.algorithms import kmeans as JK
from repro.core import fixpoint as JF
from repro.data.points import make_geo_points as j_make_geo_points
from repro.data.points import \
    sample_initial_centroids as j_sample_initial_centroids
from repro.kernels.kmeans_assign import assign as j_assign
from repro.kernels.kmeans_assign import kmeans_assign_ref as j_assign_ref

from repro_torch import convert
from repro_torch.algorithms import kmeans as TK
from repro_torch.data.points import (make_geo_points,
                                     sample_initial_centroids)
from repro_torch.kernels import kmeans_assign as t_ka

U32 = 2.0 ** -24      # float32 unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


def t(x):
    return torch.from_numpy(np.array(x))


def assert_d2_within_reorder(got, other, points, cents, assign):
    """``got`` and ``other`` are float32 evaluations of |p|² − 2p·c + |c|²
    at the same (point, centroid) pairs: 3D terms, summed in different
    orders and with or without fused multiply-adds.  Each lands within
    gamma_3D of the terms' absolute sum of the exact value, so the two
    differ by at most twice that."""
    p = np.asarray(points, np.float64)
    c = np.asarray(cents, np.float64)[np.asarray(assign)]
    k = 3 * p.shape[1]
    gamma = k * U32 / (1 - k * U32)
    abs_sum = (p ** 2).sum(1) + np.abs(2 * p * c).sum(1) + (c ** 2).sum(1)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(other, np.float64))
    assert np.all(diff <= 2 * gamma * abs_sum), float(diff.max())


def _inputs(n, k, d, seed, dup=False):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, d)) * 40).astype(np.float32)
    cents = (rng.normal(size=(k, d)) * 40).astype(np.float32)
    if dup and k > 1:
        cents[k // 2] = cents[0]      # an exact tie: both must pick 0
        pts[: n // 8] = cents[0]      # some points sit on the tied pair
    return pts, cents


class TestKMeansAssign:
    # exact: d² equal to the plain oracle bit for bit.
    @pytest.mark.parametrize("n,k,d,exact", [
        (8192, 32, 2, True), (3001, 32, 2, True), (1023, 16, 2, True),
        (4096, 128, 2, True), (500, 64, 3, True), (1000, 8, 2, False),
        (777, 32, 5, False), (256, 3, 16, False)])
    def test_ref_vs_reference_oracle(self, n, k, d, exact):
        pts, cents = _inputs(n, k, d, seed=n * k, dup=True)
        a_j, d_j = j_assign_ref(jnp.asarray(pts), jnp.asarray(cents))
        a_t, d_t = t_ka.kmeans_assign_ref(t(pts), t(cents))
        assert a_t.dtype == torch.int32 and d_t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a_j), a_t.numpy())
        assert int((a_t[: n // 8] == 0).sum()) == n // 8   # ties -> first
        if exact:
            np.testing.assert_array_equal(np.asarray(d_j), d_t.numpy())
        else:
            assert_d2_within_reorder(d_t.numpy(), d_j, pts, cents,
                                     a_t.numpy())

    @pytest.mark.parametrize("n,k,d", [(1000, 8, 2), (777, 32, 5),
                                       (3001, 32, 2), (256, 3, 16)])
    def test_ref_vs_pallas(self, n, k, d):
        """N not a multiple of the tile: the reference's ops wrapper pads
        and runs the Pallas kernel in interpret mode."""
        pts, cents = _inputs(n, k, d, seed=n + k, dup=True)
        a_p, d_p = j_assign(jnp.asarray(pts), jnp.asarray(cents), tile_p=256)
        a_t, d_t = t_ka.assign(t(pts), t(cents))
        np.testing.assert_array_equal(np.asarray(a_p), a_t.numpy())
        assert_d2_within_reorder(d_t.numpy(), d_p, pts, cents, a_t.numpy())

    @settings(max_examples=15, deadline=None)
    @given(n=st.integers(1, 700), k=st.integers(1, 40),
           d=st.integers(1, 4), seed=st.integers(0, 10_000),
           dup=st.booleans())
    def test_property_ref_vs_reference_oracle(self, n, k, d, seed, dup):
        pts, cents = _inputs(n, k, d, seed, dup)
        a_j, d_j = j_assign_ref(jnp.asarray(pts), jnp.asarray(cents))
        a_t, d_t = t_ka.assign(t(pts), t(cents))
        np.testing.assert_array_equal(np.asarray(a_j), a_t.numpy())
        assert_d2_within_reorder(d_t.numpy(), d_j, pts, cents, a_t.numpy())


class TestPoints:
    @pytest.mark.parametrize("n,clusters,seed", [(1024, 8, 0), (777, 32, 3),
                                                 (4096, 16, 11)])
    def test_equal_to_reference(self, n, clusters, seed):
        jp = j_make_geo_points(n, n_true_clusters=clusters, seed=seed)
        tp = make_geo_points(n, n_true_clusters=clusters, seed=seed,
                             device="cpu")
        assert tp.dtype == torch.float32 and tp.shape == (n, 2)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        for k in (1, clusters):
            ji = j_sample_initial_centroids(jp, k, seed=seed + 1)
            ti = sample_initial_centroids(tp, k, seed=seed + 1)
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def _points(n, clusters, seed):
    jp = j_make_geo_points(n, n_true_clusters=clusters, seed=seed)
    ji = j_sample_initial_centroids(jp, clusters, seed=seed + 1)
    return jp, ji, t(jp), t(ji)


def assert_same_run(jc, jres, tc, tres):
    for f in JF.StratumStats._fields:
        a, b = np.asarray(getattr(jres.stats, f)), getattr(tres.stats,
                                                           f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in JK.KMState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres.state, f)),
                                      getattr(tres.state, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


SIZES = [(4, 256, 8, 0), (4, 512, 16, 4)]   # shards, block, k, seed


class TestKMeansRun:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("mode", ["delta", "nodelta"])
    @pytest.mark.parametrize("S,block,k,seed", SIZES)
    def test_run_parity(self, S, block, k, seed, mode, use_kernels):
        jp, ji, tp, ti = _points(S * block, k, seed)
        jc, jres = JK.run(jp.reshape(S, block, 2), ji, mode=mode)
        tc, tres = TK.run(tp.reshape(S, block, 2), ti, mode=mode,
                          device="cpu", use_kernels=use_kernels)
        assert_same_run(jc, jres, tc, tres)
        assert int(tres.stats.iterations) > 2

    @pytest.mark.parametrize("mode", ["delta", "nodelta"])
    def test_masked_run_and_resume_parity(self, mode):
        """The incremental views' pattern: a masked cold run, points
        toggled, then resume from the nudged state."""
        S, block, k = 4, 256, 8
        jp, ji, tp, ti = _points(S * block, k, seed=7)
        rng = np.random.default_rng(7)
        valid = rng.random((S, block)) < 0.8
        jpts, tpts = jp.reshape(S, block, 2), tp.reshape(S, block, 2)
        jc, jres = JK.run(jpts, ji, mode=mode, valid=jnp.asarray(valid))
        tc, tres = TK.run(tpts, ti, mode=mode, valid=t(valid), device="cpu")
        assert_same_run(jc, jres, tc, tres)
        # Toggle 10 % of the slots and nudge the sums as the rule does.
        flip = rng.random((S, block)) < 0.1
        valid2 = valid ^ flip
        pts = np.asarray(jp).reshape(S, block, 2)
        sign = np.where(valid2 & flip, 1.0, np.where(flip, -1.0, 0.0))
        a = np.asarray(jres.state.assign)
        sums = np.asarray(jres.state.sums).copy()
        counts = np.asarray(jres.state.counts).copy()
        np.add.at(sums, a[flip], (pts * sign[..., None])[flip])
        np.add.at(counts, a[flip], sign[flip])
        warm = dict(assign=a, sums=sums.astype(np.float32),
                    counts=counts.astype(np.float32))
        jc2, jres2 = JK.resume(jpts, JK.KMState(**{
            f: jnp.asarray(v) for f, v in warm.items()}), mode=mode,
            valid=jnp.asarray(valid2))
        tc2, tres2 = TK.resume(tpts, convert.to_torch(TK.KMState, warm,
                                                      "cpu"),
                               mode=mode, valid=t(valid2), device="cpu")
        assert_same_run(jc2, jres2, tc2, tres2)

    def test_converged_state_resumes_with_one_stratum(self):
        S, block, k = 4, 256, 8
        _, _, tp, ti = _points(S * block, k, seed=0)
        pts = tp.reshape(S, block, 2)
        c, res = TK.run(pts, ti, device="cpu")
        c2, res2 = TK.resume(pts, res.state, device="cpu")
        assert int(res2.stats.iterations) == 1
        assert int(res2.stats.delta_counts[0]) == 0
        assert torch.equal(c, c2)

    def test_reference_kmeans_matches(self):
        jp, ji, tp, ti = _points(1024, 8, seed=0)
        ref_j = np.asarray(JK.reference_kmeans(jp, ji))
        ref_t = TK.reference_kmeans(tp, ti, device="cpu").numpy()
        np.testing.assert_array_max_ulp(ref_j, ref_t, maxulp=1)
        # tests/test_algorithms.py's bound, on the port.
        c, _ = TK.run(tp.reshape(4, 256, 2), ti, device="cpu")
        assert float((c - torch.from_numpy(ref_t)).abs().max()) < 1e-3

    def test_delta_equals_dense(self):
        """tests/test_algorithms.py's check, on the port."""
        _, _, tp, ti = _points(512, 4, seed=2)
        cd, rd = TK.run(tp.reshape(4, 128, 2), ti, mode="delta",
                        device="cpu")
        cn, rn = TK.run(tp.reshape(4, 128, 2), ti, mode="nodelta",
                        device="cpu")
        assert float((cd - cn).abs().max()) < 1e-5
        assert int(rd.stats.iterations) == int(rn.stats.iterations)


def test_card_rows_do_not_stagnate():
    """One float32 cell taking 4.5 M points around 50 (spread 3) stagnates:
    each add rounds to the sum's coarse ulp with a bias, and the mean
    lands far off.  _segment_sums spreads a shard this large over cells of
    at most CELL_POINTS points, with or without a mask, and stays within
    float32 noise of the float64 sum."""
    n = 4_500_000
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(50.0, 3.0, size=(1, n, 2)
                                      ).astype(np.float32))
    assign = torch.zeros((1, n), dtype=torch.int32)
    exact = pts[0].double().sum(0) / n
    one = torch.zeros((1, 2)).index_add_(0, torch.zeros(n, dtype=torch.long),
                                         pts[0])[0]
    assert float((one.double() / n - exact).abs().max()) > 0.5
    for valid in (None, torch.ones((1, n), dtype=torch.bool)):
        spread = TK._segment_sums(pts, assign, valid, 1)[0, 0]
        assert float(spread[2]) == n
        assert float((spread[:2].double() / n - exact).abs().max()) < 1e-4


def test_segment_sums_mask_and_cells():
    """A masked shard larger than CELL_POINTS: every kept point lands in
    its centroid once, the rest nowhere."""
    S, block, k = 2, 3 * TK.CELL_POINTS + 5, 3
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.integers(-8, 8, size=(S, block, 2)
                                        ).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, k, size=(S, block)
                                           ).astype(np.int32))
    valid = torch.from_numpy(rng.random((S, block)) < 0.7)
    got = TK._segment_sums(pts, assign, valid, k)
    onehot = torch.nn.functional.one_hot(assign.long(), k).double() * \
        valid[..., None]
    want = torch.cat([torch.einsum("sbk,sbd->skd", onehot, pts.double()),
                      onehot.sum(1)[..., None]], -1)
    assert torch.equal(got.double(), want)   # small integers: exact


def test_byte_accounting_does_not_wrap():
    """The reference computes 2·n·16 in int32, which wraps from n = 2²⁶;
    the port counts in 64 bits and rounds once to float32."""
    n = torch.tensor(2 ** 27)
    assert float(TK._f32(2 * n * TK.BYTES_PER_DELTA)) == 2.0 ** 32
    assert float(TK._f32(382_000_000 * TK.BYTES_PER_POINT_RECORD)) == float(
        np.float32(382_000_000 * 16))


def test_types_are_pinned():
    _, _, tp, ti = _points(512, 4, seed=2)
    c, res = TK.run(tp.reshape(4, 128, 2), ti, device="cpu", max_iters=3)
    assert c.dtype == torch.float32
    assert res.state.assign.dtype == torch.int32
    assert res.stats.delta_counts.dtype == torch.int32
    assert res.stats.rehash_bytes.dtype == torch.float32


@pytest.mark.parametrize("k,d,table", [(32, 2, True), (16, 2, True),
                                       (33, 2, False), (32, 3, False),
                                       (5000, 3, False), (1, 2, True)])
def test_kernel_choice_is_by_shape(k, d, table):
    """The constant-table kernel runs at D = 2 with at most 32 centroids
    (its table's rows); every other shape runs the shared-memory
    kernel."""
    assert t_ka.uses_table(k, d) is table
