"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  This file imports
only the port, so it also runs where the reference's JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Integer outputs and min/max results must match exactly; float adds land
in atomic order, so add results are within 1e-5 relative (scatter_route
also at adsorption's width, W = 4; delta_scatter at W = 1, 2, 3, 4 and 8,
on global keys with a key base, and on unaligned views).  Adsorption on the
card lands within 5e-3 of the CPU's torch-op path, as does compiled
PageRank; compiled SSSP, CC and reachability equal it exactly; a
resilient SSSP with one failure, and a traced SSSP, equal the plain run
exactly.  kmeans_assign's
d² may differ from the plain version's product by rounding, so an
assignment may differ only where the plain version's best two d² lie
within 4 ulp of |p|² + |c|².  The float32 flash_attention kernel is
within 2e-4 abs + 2e-4 rel of its plain version (the reference's
kernel-vs-oracle bound), and a 2-layer full-width Llama-3 forward through
it within 1e-4 of the plain path relative to the largest logit (float32,
TF32 off).  The bf16 kernel is within 2^-8 max|v| + 2^-8 |ref| of the
float32 plain version on the same bf16 values: bf16 keeps 8 significant
bits, so rounding P moves each weight by at most 2^-8 relative (2^-8
max|v| on the output) and rounding the output costs at most 2^-8 |o|;
the bound is their sum, and the float32 sum order is far below either.
A 2-layer full-width bf16
Llama-3 forward through it is within 5e-2 of the plain path relative to
the largest logit, chip_smoke.py's bound for the bf16 model at full depth
(a last-bit difference in an attention output flips a bf16 rounding of
the residual stream).  The bf16 kernel is also held at groups 7 and 6
(arctic's 56/8 heads, mixtral's 48/8), and forward and backward at
qwen2-vl's 12/2.  Reduced minicpm3-4b's MLA prefill and absorbed decode on
the card match the CPU's within 1e-5 of the largest value (float32, TF32
off); reduced whisper-large-v3's encoder, prefill (self and cross caches)
and decode within 1e-4 (the float32 kernel in the encoder and prefill), and
a bf16 Whisper at head dim 64 through the bf16 kernel within 5e-2 of the
plain path.  Reduced recurrentgemma-2b and xlstm-350m on the card match
the CPU within 1e-5 (prefill, every cache leaf, decode), the RG-LRU scan
holds its rounding bound against a float64 recurrence and the chunked
mLSTM is within 1e-4 (relative L2) of float64 decode steps.  The bf16
kernels are held at D = 64, forward and backward,
at Whisper's 20/20 heads and at a GQA group.  ``moe_ffn`` on the card makes the
CPU's expert choices and lands within 1e-5 of max |y| of its output, and
windowed and blocked attention within 1e-5 of max |out| of theirs
(float32, TF32 off).  flash_attention_bwd is within 1e-4 of each
gradient's largest |g| of attention_bwd_ref on the same float32 values
(reordered float32 sums); the bf16 kernel, which rounds P and dS to bf16
before their products and the gradients at the end, adds 2^-8 |g| and
the terms of ``bf16_rounding_terms`` (the reason is stated at BWD_TOL).
The bf16 forward's log-sum-exp, which the bf16 backward reads, is within
S 2^-23 of torch.logsumexp; serving writes none.  A reduced train step on
the card matches the CPU's.  On a (1, 1) mesh over a one-rank NCCL group
(``launch/sharding.py``'s DTensor path), the sharded train step, with and
without the ZeRO-3 hook, gives the plain step's loss within 1e-6 relative
through the float32 flash kernels; flash decoding on that ambient mesh is
within 1e-5 of the full decode; MoE's a2a dispatch within 1e-5 of max
|y| of the sort dispatch at a capacity that drops nothing.  The
multi-process
launch: a ``local``-mode worker
process brings CUDA up and acks with sums computed on the card, and the
bring-up selftest forms a world of one NCCL rank on ``cuda:0``.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.algorithms import connected_components as cc
from repro_torch.configs import get_arch
from repro_torch.algorithms import kmeans, pagerank, sssp
from repro_torch.core.fixpoint import ROUTE_SCATTER, ROUTE_SORT
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph, make_powerlaw_graph, shard_csr
from repro_torch.data.points import make_geo_points, sample_initial_centroids
from repro_torch.kernels import delta_route as t_dr
from repro_torch.kernels import delta_scatter as t_ds
from repro_torch.kernels import edge_propagate as t_ep
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import kmeans_assign as t_ka
from repro_torch.kernels import scatter_route as t_sr
from repro_torch.kernels.delta_route import ops as dr_ops
from repro_torch.kernels.delta_scatter import ops as ds_ops
from repro_torch.kernels.edge_propagate import ops as ep_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kmeans_assign import ops as ka_ops
from repro_torch.kernels.scatter_route import ops as sr_ops
from repro_torch.models import transformer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def t(x, device):
    return torch.from_numpy(np.array(x)).to(device)


@pytest.mark.parametrize("combiner,w", [("add", 1), ("min", 1),
                                        ("max", 1), ("min", 3), ("add", 4)])
def test_scatter_route(cuda, combiner, w):
    rng = np.random.default_rng(0)
    S, B, cap, c = 8, 5000, 3000, 200_000
    keys = rng.integers(-1, S * B, size=c).astype(np.int32)
    owners = np.where(keys >= 0, keys // B, S).astype(np.int32)
    local = np.where(keys >= 0, keys % B, -1).astype(np.int32)
    args = [t(x, cuda) for x in (
        keys, rng.normal(size=(c, w)).astype(np.float32), local, owners)]
    before = sr_ops.launches
    got = t_sr.scatter_route(*args, S, B, cap, combiner)
    ref = t_sr.scatter_route_ref(*args, S, B, cap, combiner)
    assert sr_ops.launches == before + 1
    for i in (0, 2, 3):
        assert torch.equal(got[i], ref[i])
    if combiner == "add":
        torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got[1], ref[1])


def test_scatter_route_raises_outside_its_bounds(cuda):
    x = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="replace"):
        t_sr.scatter_route(x, torch.zeros(4, 1, device=cuda), x, x, 2, 2, 2,
                           combiner="replace")


def near_tie_ok(points, cents, got, ref):
    """Assignments equal except where the plain version's best two d² lie
    within 4 ulp of |p|² + |c|²; returns the count of such points."""
    if cents.shape[0] < 2:
        assert torch.equal(got, ref)
        return 0
    top2 = t_ka.kmeans_d2(points, cents).topk(2, largest=False).values
    c2 = (cents ** 2).sum(-1)
    scale = (points ** 2).sum(-1) + torch.maximum(c2[got.long()],
                                                  c2[ref.long()])
    tol = 4 * torch.finfo(torch.float32).eps * scale
    near = (top2[:, 1] - top2[:, 0]) <= tol
    assert bool(((got == ref) | near).all())
    return int(near.sum())


@pytest.mark.parametrize("n,k,d", [(1_000_003, 32, 2), (77_777, 8, 5),
                                   (20_000, 5000, 3), (4096, 1, 2),
                                   (100_003, 9, 2), (100_003, 20, 2)])
def test_kmeans_assign(cuda, n, k, d):
    rng = np.random.default_rng(n + k)
    pts = (rng.normal(size=(n, d)) * 40).astype(np.float32)
    cents = (rng.normal(size=(k, d)) * 40).astype(np.float32)
    if k > 1:
        cents[k // 2] = cents[0]       # an exact tie: both pick 0
        pts[:100] = cents[0]
    pts, cents = t(pts, cuda), t(cents, cuda)
    before = ka_ops.launches
    a, d2 = t_ka.assign(pts, cents)
    assert ka_ops.launches == before + 1
    a_ref, d2_ref = t_ka.kmeans_assign_ref(pts, cents)
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    near_tie_ok(pts, cents, a, a_ref)
    assert bool((a[:100] == 0).all())
    scale = (pts ** 2).sum(-1) + (cents ** 2).sum(-1).max()
    assert bool(((d2 - d2_ref).abs()
                 <= 4 * torch.finfo(torch.float32).eps * scale).all())


@pytest.mark.parametrize("k,d", [(32, 2), (20, 2), (5000, 3)])
def test_kmeans_assign_ties_go_to_the_first_index(cuda, k, d):
    """Both kernels (the constant table at D = 2, K = 32 and K = 20, whose
    table is padded; shared memory at K = 5000, D = 3) on small integer
    inputs, where every d² is exact: points equidistant from two distinct
    centroids, and points on a duplicated centroid, take the lower index;
    one launch a call."""
    rng = np.random.default_rng(k)
    cents = rng.integers(20, 60, size=(k, d)).astype(np.float32)
    lo, hi = 5, k - 1
    cents[lo] = 0.0
    cents[hi] = 0.0
    cents[lo, 0], cents[hi, 0] = 1.0, -1.0     # +-e_0
    cents[k - 2] = cents[2]                     # a duplicate of centroid 2
    n = 3000
    pts = np.zeros((n, d), np.float32)
    if d > 1:
        pts[:1000, 1] = rng.integers(-3, 4, 1000)   # d² = y² + 1 to both
    pts[1000:2000] = cents[2]
    pts[2000:] = rng.integers(-80, 80, size=(1000, d))
    pts, cents_t = t(pts, cuda), t(cents, cuda)
    assert t_ka.uses_table(k, d) == (d == 2)
    before = ka_ops.launches
    a, d2 = t_ka.assign(pts, cents_t)
    assert ka_ops.launches == before + 1
    a_ref, d2_ref = t_ka.kmeans_assign_ref(pts, cents_t)
    assert bool((a[:1000] == lo).all()) and bool((a[1000:2000] == 2).all())
    assert torch.equal(a, a_ref) and torch.equal(d2, d2_ref)


def test_kmeans_assign_raises_outside_its_bounds(cuda):
    pts = torch.zeros(8, 2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        t_ka.assign(pts, torch.zeros(20_000, 2, device=cuda))
    with pytest.raises(ValueError, match="D="):
        t_ka.assign(pts, torch.zeros(4, 3, device=cuda))


def test_kmeans_assign_threads_keep_their_own_table(cuda):
    """Threads (more than cores) on the default stream, each with its own
    centroids, switching often: every call's result is its own table's,
    so no call read another's constant table."""
    import os
    import sys
    import threading
    pts = torch.randn(200_000, 2, device=cuda) * 40
    tables = [torch.randn(32 - i, 2, device=cuda) * 40 for i in range(8)]
    want = [t_ka.assign(pts, c) for c in tables]
    bad = []

    def worker(i):
        for _ in range(20):
            a, d2 = t_ka.assign(pts, tables[i])
            if not (torch.equal(a, want[i][0])
                    and torch.equal(d2, want[i][1])):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i % 8,))
                   for i in range(max(16, 2 * (os.cpu_count() or 1)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert bad == []


def test_kmeans_assign_table_runs_on_the_default_stream_only(cuda):
    """The constant table is one per process: the table kernel raises on a
    side stream and launches nothing; the shared-memory kernel runs
    there."""
    pts = torch.randn(4096, 2, device=cuda)
    side = torch.cuda.Stream()
    before = ka_ops.launches
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="default stream"):
            t_ka.assign(pts, pts[:32].clone())
        assert ka_ops.launches == before
        p3 = torch.randn(4096, 3, device=cuda)
        a, _ = t_ka.assign(p3, p3[:40].clone())
    side.synchronize()
    assert ka_ops.launches == before + 1
    assert torch.equal(a, t_ka.kmeans_assign_ref(p3, p3[:40].clone())[0])


def test_delta_route(cuda):
    rng = np.random.default_rng(1)
    S, cap, c = 8, 20_000, 300_000
    args = [t(x, cuda) for x in (
        rng.integers(-1, 1 << 30, size=c).astype(np.int32),
        rng.normal(size=(c, 2)).astype(np.float32),
        rng.integers(0, 4, c).astype(np.int8),
        rng.integers(0, S + 1, size=c).astype(np.int32))]
    before = dr_ops.launches
    got = t_dr.delta_route(*args, S, cap)
    ref = t_dr.delta_route_ref(*args, S, cap)
    assert dr_ops.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def check_delta_scatter(state, keys, pay, combiner, key_base):
    """One launch of the kernel, held to its plain version: min/max
    exactly, add within 1e-5 relative."""
    before = ds_ops.launches
    got = t_ds.delta_scatter(state, keys, pay, combiner, key_base)
    ref = t_ds.delta_scatter_ref(state, keys, pay, combiner, key_base)
    assert ds_ops.launches == before + 1
    if combiner == "add":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("key_base", [0, 12_345])
@pytest.mark.parametrize("combiner,w", [
    ("add", 1), ("min", 1), ("max", 1), ("add", 2), ("add", 3), ("add", 4),
    ("add", 8)])
def test_delta_scatter(cuda, combiner, w, key_base):
    """Global keys (PAD, other shards' keys, keys past the block) folded
    at every width the kernel specialises: W = 1, 2 (float2 atomics), 3
    (scalar), 4 and 8 (float4 atomics); adsorption's apply is W = 4."""
    rng = np.random.default_rng(2 + w)
    n, c = 100_000, 400_000
    state = t(rng.normal(size=(n, w)).astype(np.float32), cuda)
    keys = t(rng.integers(-1, key_base + n + 5, size=c).astype(np.int32),
             cuda)
    pay = t(rng.normal(size=(c, w)).astype(np.float32), cuda)
    check_delta_scatter(state, keys, pay, combiner, key_base)


@pytest.mark.parametrize("case", ["keys_unaligned", "payload_unaligned",
                                  "c_mod_4", "empty", "all_pad", "hot_row"])
@pytest.mark.parametrize("combiner,w", [("add", 1), ("min", 1), ("add", 2),
                                        ("add", 4)])
def test_delta_scatter_edges(cuda, combiner, w, case):
    """A keys view off the 16-byte grid (scalar head), a payload off it
    (scalar loads), C % 4 != 0 (scalar tail), C = 0, a buffer of padding
    only, and one row receiving 8 deltas."""
    rng = np.random.default_rng(5)
    n, c, base = 5000, 40_003 if case == "c_mod_4" else 40_000, 777
    keys = rng.integers(-1, base + n + 5, size=c + 1).astype(np.int32)
    pay = rng.normal(size=((c + 1) * w + 1,)).astype(np.float32)
    if case == "all_pad":
        keys[:] = -1
    if case == "hot_row":
        keys[:] = -1
        keys[1:1 + 8 * 97:97] = base + 1234
    keys_t = t(keys, cuda)
    pay_t = t(pay, cuda)
    keys_t = keys_t[1:] if case == "keys_unaligned" else keys_t[:c]
    off = 1 if case == "payload_unaligned" else 0
    pay_t = pay_t[off:off + c * w].view(c, w)
    if case == "empty":
        keys_t, pay_t = keys_t[:0], pay_t[:0]
    if case == "keys_unaligned":
        assert keys_t.data_ptr() % 16
    if case == "payload_unaligned":
        assert pay_t.data_ptr() % 8
    state = t(rng.normal(size=(n, w)).astype(np.float32), cuda)
    check_delta_scatter(state, keys_t, pay_t, combiner, base)
    if case == "all_pad" or case == "empty":
        assert torch.equal(t_ds.delta_scatter(state, keys_t, pay_t, combiner,
                                              base), state)


@pytest.mark.parametrize("combiner", ["add", "min", "max"])
def test_edge_propagate(cuda, combiner):
    n = 50_000
    indptr, indices = make_powerlaw_graph(n, avg_degree=14.5, seed=0)
    graph = CSRGraph(indptr=t(indptr.astype(np.int32), cuda),
                     indices=t(indices, cuda),
                     out_degree=t(np.diff(indptr).astype(np.int32), cuda))
    csc = t_ep.build_csc(graph, n)
    pay = t(np.random.default_rng(3).random(n).astype(np.float32), cuda)
    before = ep_ops.launches
    got = t_ep.edge_propagate(pay, csc, combiner)
    ref = t_ep.edge_propagate_ref(pay, csc.indptr, csc.src, csc.weight,
                                  combiner)
    assert ep_ops.launches == before + 1
    if combiner == "add":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, ref)


def binned_graph(seed=0):
    """Destinations of every bin: empty rows, light rows of 1-32 edges (32
    itself included), heavy rows of 33-98 edges and one of 100,000 edges,
    from 5000 sources with weights; (CSRGraph on the CPU, n_dst, per-slot
    weights)."""
    rng = np.random.default_rng(seed)
    n_src, n_dst = 5000, 20_000
    deg = np.zeros(n_dst, np.int64)
    deg[0] = 100_000
    deg[1:300] = rng.integers(33, 99, 299)
    deg[300] = 32
    deg[301] = 33
    live = rng.random(n_dst - 302) < 0.7       # the rest stay empty
    deg[302:] = np.where(live, rng.integers(1, 11, n_dst - 302), 0)
    dst = np.repeat(np.arange(n_dst, dtype=np.int32), deg)
    src = rng.integers(0, n_src, dst.size)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n_src + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_src), out=indptr[1:])
    graph = CSRGraph(indptr=torch.from_numpy(indptr.astype(np.int32)),
                     indices=torch.from_numpy(dst[order]),
                     out_degree=torch.from_numpy(np.diff(indptr).astype(
                         np.int32)))
    weights = torch.from_numpy((rng.random(dst.size) + 0.5).astype(
        np.float32))
    return graph, n_dst, weights


@pytest.mark.parametrize("combiner", ["add", "min", "max"])
def test_edge_propagate_bins(cuda, combiner):
    """Every row of every bin is written once, and two launches agree bit
    for bit.  Min and max equal the plain version exactly; add rows are
    within the rounding bound of their summation order (a thread sums a
    light row in edge order, so light rows equal the plain version on the
    CPU bit for bit; a heavy row's lanes each sum ceil(deg/32) edges, then
    5 shuffle steps)."""
    graph, n_dst, weights = binned_graph()
    rng = np.random.default_rng(7)
    n_src = graph.n_src
    pay = (rng.random(n_src) if combiner == "add"
           else rng.normal(size=n_src)).astype(np.float32)
    cpu = t_ep.build_csc(graph, n_dst, weights)
    deg = (cpu.indptr[1:] - cpu.indptr[:-1]).long()
    assert int((deg == 0).sum()) > 0 and int(deg.max()) == 100_000
    assert cpu.heavy.tolist() == list(range(300)) + [301]
    csc = t_ep.build_csc(graph.to(cuda), n_dst, weights.to(cuda))
    assert torch.equal(csc.heavy.cpu(), cpu.heavy)
    x = t(pay, cuda)
    before = ep_ops.launches
    got = t_ep.edge_propagate(x, csc, combiner)
    again = t_ep.edge_propagate(x, csc, combiner)
    assert ep_ops.launches == before + 2
    assert torch.equal(got, again)
    plain = (csc.indptr, csc.src, csc.weight)
    if combiner != "add":
        assert torch.equal(got, t_ep.edge_propagate_ref(x, *plain, combiner))
        return
    got = got.cpu()
    ref_cpu = t_ep.edge_propagate_ref(torch.from_numpy(pay), cpu.indptr,
                                      cpu.src, cpu.weight, combiner)
    light = deg <= t_ep.HEAVY_EDGES
    assert torch.equal(got[light], ref_cpu[light])
    exact = t_ep.edge_propagate_ref(torch.from_numpy(pay).double(),
                                    cpu.indptr, cpu.src,
                                    cpu.weight.double())
    # |error| <= (1 product + ceil(deg/32) adds + 5 tree steps) u sum|terms|
    steps = 1 + (deg + 31) // 32 + 5
    bound = steps.double() * 2.0 ** -24 * exact
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("mode,route", [("delta", "auto"), ("delta", "sort"),
                                        ("nodelta", "sort")])
def test_pagerank_on_card_matches_cpu(cuda, mode, route):
    """The kernel path on the card lands within the threshold of the
    torch-op path on the CPU (atomics reorder float adds, so the active
    sets may differ late in the run)."""
    n, S = 4096, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=8.0, seed=0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    kw = dict(mode=mode, threshold=1e-5, max_iters=120, edge_capacity=8192,
              src_capacity=1024, ladder_tiers=4, route_strategy=route)
    counts = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
              ep_ops.launches)
    pr_gpu, _ = pagerank.run(shard_csr(indptr, indices, S, device=cuda),
                             snap, device=cuda, **kw)
    pr_cpu, _ = pagerank.run(shard_csr(indptr, indices, S, device="cpu"),
                             snap, device="cpu", use_kernels=False, **kw)
    assert float((pr_gpu.cpu() - pr_cpu).abs().max()) < 5e-3
    after = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
             ep_ops.launches)
    ran = [a > b for a, b in zip(after, counts)]
    expected = {("delta", "auto"): [True, False, True],
                ("delta", "sort"): [False, True, True],
                ("nodelta", "sort"): [False, False, False]}[(mode, route)]
    assert ran[:3] == expected
    assert ran[3] or mode == "delta"


@pytest.mark.parametrize("mode,route", [("delta", "auto"), ("delta", "sort"),
                                        ("nodelta", "sort")])
@pytest.mark.parametrize("algo", ["sssp", "cc"])
def test_min_algorithms_on_card_equal_cpu(cuda, algo, mode, route):
    """Min is order-free: the kernel path on the card equals the torch-op
    path on the CPU exactly, stats included."""
    n, S = 4096, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=14.5, alpha=2.1,
                                          seed=0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    mod = sssp if algo == "sssp" else cc
    kw = dict(mode=mode, max_iters=80, edge_capacity=8192, src_capacity=1024,
              ladder_tiers=4, route_strategy=route)
    counts = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
              ep_ops.launches)
    v_gpu, r_gpu = mod.run(shard_csr(indptr, indices, S, device=cuda), snap,
                           device=cuda, **kw)
    v_cpu, r_cpu = mod.run(shard_csr(indptr, indices, S, device="cpu"),
                           snap, device="cpu", use_kernels=False, **kw)
    assert torch.equal(v_gpu.cpu(), v_cpu)
    for f in r_cpu.stats._fields:
        assert torch.equal(getattr(r_gpu.stats, f), getattr(r_cpu.stats, f))
    after = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
             ep_ops.launches)
    ran = [a > b for a, b in zip(after, counts)]
    used_dense = bool(r_cpu.stats.used_dense.any())
    expected = {("delta", "auto"): [True, False, True, used_dense],
                ("delta", "sort"): [False, True, True, used_dense],
                ("nodelta", "sort"): [False, False, False, True]}
    assert ran == expected[(mode, route)]


@pytest.mark.parametrize("mode,route", [("delta", "auto"), ("delta", "sort"),
                                        ("nodelta", "sort")])
@pytest.mark.parametrize("program", ["pagerank", "sssp", "cc",
                                     "reachability"])
def test_compiled_programs_on_card_match_cpu(cuda, program, mode, route):
    """Compiled rule programs through the kernels on the card against the
    torch-op path on the CPU: PageRank within 5e-3 at threshold 1e-5
    (atomics reorder float adds), the min and max programs exactly, stats
    included, and reachability also against the BFS oracle.  Each run
    launches the kernels of its path: for reachability that is the max
    variant of scatter_route, delta_scatter and edge_propagate."""
    from repro_torch import frontend
    n, S = 4096, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=14.5, alpha=2.1,
                                          seed=0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    prog = (frontend.pagerank_program(1e-5) if program == "pagerank"
            else getattr(frontend, f"{program}_program")())
    cp = frontend.compile_program(prog)
    kw = dict(mode=mode, max_iters=120, edge_capacity=8192,
              src_capacity=1024, ladder_tiers=4, route_strategy=route)
    counts = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
              ep_ops.launches)
    v_gpu, r_gpu = cp.run(shard_csr(indptr, indices, S, device=cuda), snap,
                          device=cuda, **kw)
    after = (sr_ops.launches, dr_ops.launches, ds_ops.launches,
             ep_ops.launches)
    v_cpu, r_cpu = cp.run(shard_csr(indptr, indices, S, device="cpu"),
                          snap, device="cpu", use_kernels=False, **kw)
    if program == "pagerank":
        assert float((v_gpu.cpu() - v_cpu).abs().max()) < 5e-3
        used_dense = True if mode == "nodelta" else None
    else:
        assert torch.equal(v_gpu.cpu(), v_cpu)
        for f in r_cpu.stats._fields:
            assert torch.equal(getattr(r_gpu.stats, f).cpu(),
                               getattr(r_cpu.stats, f)), f
        used_dense = bool(r_cpu.stats.used_dense.any())
    if program == "reachability":
        bfs = sssp.reference_sssp(indptr, indices, n, device="cpu")
        assert torch.equal(v_cpu[:n] == 1.0, torch.isfinite(bfs))
    ran = [a > b for a, b in zip(after, counts)]
    expected = {("delta", "auto"): [True, False, True],
                ("delta", "sort"): [False, True, True],
                ("nodelta", "sort"): [False, False, False]}[(mode, route)]
    assert ran[:3] == expected
    if used_dense is not None:
        assert ran[3] == used_dense


@pytest.mark.parametrize("mode,route", [("delta", "auto"), ("delta", "sort"),
                                        ("nodelta", "sort")])
def test_adsorption_on_card_matches_cpu(cuda, mode, route):
    """Adsorption (L = 4) through the kernels at W = 4 lands within the
    threshold of the torch-op path on the CPU."""
    from repro_torch.algorithms import adsorption
    n, S, L = 4096, 4, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=8.0, seed=0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    seeds = torch.zeros((snap.padded_keys, L))
    v = torch.arange(0, n, 10)
    seeds[v, (v // 10) % L] = 1.0
    kw = dict(mode=mode, threshold=1e-5, max_iters=120, edge_capacity=8192,
              src_capacity=1024, ladder_tiers=4, route_strategy=route)
    counts = (sr_ops.launches, dr_ops.launches, ds_ops.launches)
    v_gpu, _ = adsorption.run(shard_csr(indptr, indices, S, device=cuda),
                              snap, seeds, device=cuda, **kw)
    v_cpu, _ = adsorption.run(shard_csr(indptr, indices, S, device="cpu"),
                              snap, seeds, device="cpu", use_kernels=False,
                              **kw)
    assert v_gpu.shape == (snap.padded_keys, L)
    assert float((v_gpu.cpu() - v_cpu).abs().max()) < 5e-3
    ran = [a > b for a, b in zip((sr_ops.launches, dr_ops.launches,
                                  ds_ops.launches), counts)]
    assert ran == {("delta", "auto"): [True, False, True],
                   ("delta", "sort"): [False, True, True],
                   ("nodelta", "sort"): [False, False, False]}[(mode, route)]


def _sssp_setup(device, n=4096, S=4, **kw):
    from repro_torch.core.engine import ShardedExecutor
    indptr, indices = make_powerlaw_graph(n, avg_degree=14.5, alpha=2.1,
                                          seed=0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=8192,
                         edge_capacity=8192, src_capacity=1024,
                         ladder_tiers=4, route_strategy="auto", **kw)
    algo = sssp.make_algorithm(snap, 1024, 8192)
    return (ex, algo, sssp.initial_state(snap, 0, device),
            shard_csr(indptr, indices, S, device=device))


def test_resilient_sssp_on_card_recovers_exactly(cuda, tmp_path):
    """One shard lost mid-run: incremental recovery on the card lands
    exactly on the failure-free run (min is order-free)."""
    from repro_torch.runtime import FaultPlan
    ex, algo, st0, g = _sssp_setup(cuda)
    ref = ex.run(algo, st0, 1, g, 80)
    half = max(int(ref.stats.iterations) // 2, 1)
    rr = ex.run_resilient(algo, st0, 1, g, 80, ckpt_root=str(tmp_path),
                          fault_plan=FaultPlan(fail_at=half, failed_shard=1))
    assert rr.metrics["converged"] and rr.metrics["recoveries"] == 1
    assert all(x.is_cuda for x in rr.result.state)
    for a, b in zip(ref.state, rr.result.state):
        assert torch.equal(a, b)
    assert torch.equal(ref.stats.delta_counts, rr.result.stats.delta_counts)


def test_traced_sssp_on_card_equals_untraced(cuda):
    """A tracer changes nothing on the card, and its spans carry the
    strata's device time."""
    from repro_torch.obs import Tracer
    ex, algo, st0, g = _sssp_setup(cuda)
    ref = ex.run(algo, st0, 1, g, 80)
    tr = Tracer()
    tex, _, _, _ = _sssp_setup(cuda, tracer=tr)
    res = tex.run(algo, st0, 1, g, 80)
    for a, b in zip(ref.state, res.state):
        assert torch.equal(a, b)
    for f in ref.stats._fields:
        assert torch.equal(getattr(ref.stats, f), getattr(res.stats, f))
    spans = [e for e in tr.events if e["name"].startswith("stratum")]
    assert len(spans) == int(ref.stats.iterations)
    assert all(0 < e["args"]["device_s"] for e in spans)


@pytest.mark.parametrize("mode", ["delta", "nodelta"])
def test_kmeans_on_card_matches_cpu(cuda, mode):
    """Atomic float sums reorder the centroid sums, so the card's run is
    held to the CPU's within 1e-3 (coordinates of +-95)."""
    S, block, k = 4, 4096, 16
    pts = make_geo_points(S * block, k, seed=0, device="cpu")
    init = sample_initial_centroids(pts, k, seed=1)
    before = ka_ops.launches
    c_gpu, r_gpu = kmeans.run(pts.reshape(S, block, 2), init, mode=mode,
                              device=cuda)
    c_cpu, r_cpu = kmeans.run(pts.reshape(S, block, 2), init, mode=mode,
                              device="cpu", use_kernels=False)
    assert ka_ops.launches == before + 1 + int(r_gpu.stats.iterations)
    assert float((c_gpu.cpu() - c_cpu).abs().max()) < 1e-3


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", [
    (2, 4, 4, 200, 200, 16, True), (1, 8, 2, 333, 333, 32, True),
    (2, 8, 2, 257, 257, 64, True), (2, 32, 8, 1000, 1000, 128, True),
    (1, 4, 1, 130, 517, 16, False), (2, 8, 8, 64, 100, 32, False),
    (2, 16, 16, 512, 768, 64, False), (1, 8, 2, 1, 300, 128, False)])
def test_flash_attention(cuda, b, h, hkv, t, s, d, causal):
    g = torch.Generator(device=cuda).manual_seed(t * 7 + s + d)
    q = torch.randn(b, h, t, d, device=cuda, generator=g)
    k = torch.randn(b, hkv, s, d, device=cuda, generator=g)
    v = torch.randn(b, hkv, s, d, device=cuda, generator=g)
    before = fa_ops.launches
    got = t_fa.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    ref = t_fa.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_flash_attention_raises_outside_its_contract(cuda):
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_fa.attention(q.transpose(2, 3), q, q, causal=False)
    with pytest.raises(ValueError, match="float32"):
        t_fa.attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 64, 80, device=cuda)
        t_fa.attention(x, x, x)


BF16_TOL = 2 ** -8


def bf16_qkv(device, b, h, hkv, t, s, d):
    g = torch.Generator(device=device).manual_seed(t * 7 + s + d)
    return tuple(torch.randn(*shape, device=device, generator=g).bfloat16()
                 for shape in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", [
    (2, 4, 4, 200, 200, 128, True), (1, 8, 2, 333, 333, 128, True),
    (2, 8, 2, 257, 257, 128, True), (2, 32, 8, 1000, 1000, 128, True),
    (1, 4, 1, 130, 517, 128, False), (2, 8, 8, 64, 100, 128, False),
    (2, 16, 16, 512, 768, 128, False), (1, 8, 2, 1, 300, 128, False),
    (1, 2, 1, 128, 128, 128, True), (2, 56, 8, 333, 333, 128, True),
    (1, 48, 8, 200, 200, 128, True), (2, 12, 2, 1000, 1000, 128, True),
    (1, 12, 2, 257, 257, 128, True),
    # D = 64 (Whisper's 20/20 heads and a GQA group): the encoder's shape,
    # the decoder's causal prefill, a ragged non-causal T != S, one row.
    (2, 20, 20, 1500, 1500, 64, False), (2, 20, 20, 384, 384, 64, True),
    (1, 8, 2, 512, 768, 64, False), (2, 8, 2, 1500, 1500, 64, False),
    (1, 8, 2, 333, 333, 64, True), (1, 20, 20, 1, 1500, 64, False)])
def test_flash_attention_bf16(cuda, b, h, hkv, t, s, d, causal):
    q, k, v = bf16_qkv(cuda, b, h, hkv, t, s, d)
    before = (fa_ops.launches, fa_ops.launches_bf16)
    got = t_fa.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.launches_bf16) == (before[0],
                                                       before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref = t_fa.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    bound = BF16_TOL * float(v.float().abs().max()) + BF16_TOL * ref.abs()
    diff = (got.float() - ref).abs()
    assert bool((diff <= bound).all()), float((diff / bound).max())
    assert torch.equal(t_fa.attention(q, k, v, causal=causal), got)


def test_flash_attention_bf16_rows_do_not_depend_on_the_batch(cuda):
    q, k, v = bf16_qkv(cuda, 8, 32, 8, 1000, 1000, 128)
    got = t_fa.attention(q, k, v)
    one = t_fa.attention(q[:1].contiguous(), k[:1].contiguous(),
                         v[:1].contiguous())
    assert torch.equal(one, got[:1])


def test_flash_attention_bf16_without_keys_is_zero(cuda):
    q, k, v = bf16_qkv(cuda, 1, 4, 2, 5, 0, 128)
    got = t_fa.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(q))
    assert torch.equal(got, t_fa.attention_ref(
        q.float(), k.float(), v.float(), causal=False).bfloat16())


def test_flash_attention_bf16_raises_outside_its_contract(cuda):
    q = torch.zeros(1, 2, 128, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        t_fa.attention(q.transpose(2, 3), q, q, causal=False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_fa.attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
        t_fa.attention(x, x, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(2 * 128 * 128 + 1, device=cuda,
                           dtype=torch.bfloat16)
        x = flat[1:].view(1, 2, 128, 128)
        t_fa.attention(x, x, x)


def test_llama3_full_width_two_layers_bf16_kernel_matches_plain(cuda):
    """Llama-3-8B's widths at 2 layers in bf16, the model's own dtype: the
    forward through the bf16 kernel (and not the float32 one) against the
    plain path on the card."""
    cfg = dataclasses.replace(get_arch("llama3-8b"), n_layers=2)
    assert cfg.dtype == "bfloat16"
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 1000), device=cuda,
                           dtype=torch.int32)
    before = (fa_ops.launches, fa_ops.launches_bf16)
    got, _ = transformer.forward(cfg, params, tokens)
    assert (fa_ops.launches, fa_ops.launches_bf16) == (before[0],
                                                       before[1] + 2)
    ref, _ = transformer.forward(cfg, params, tokens, use_kernel=False)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 5e-2, rel


@pytest.mark.parametrize("name", ["arctic-480b", "mixtral-8x22b"])
@pytest.mark.parametrize("strategy", ["sort", "onehot"])
def test_moe_ffn_on_card_matches_cpu(cuda, name, strategy):
    """moe_ffn at reduced size, float32 (TF32 off), capacity 1.25: the
    card's run against the CPU's on the same weights and input, the same
    expert choices and the output within 1e-5 of max |y|."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu").layers[0].ffn
    x = torch.randn(4, 96, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y_cpu, aux_cpu = moe.moe_ffn(cfg, params, x, strategy)
    params_gpu = copy.deepcopy(params).to(cuda)
    y, aux = moe.moe_ffn(cfg, params_gpu, x.to(cuda), strategy)
    assert torch.equal(moe._route(cfg, params_gpu, x.to(cuda).reshape(
        -1, cfg.d_model))[0].cpu(), moe._route(cfg, params, x.reshape(
            -1, cfg.d_model))[0])
    assert float((y.cpu() - y_cpu).abs().max()) <= \
        1e-5 * float(y_cpu.abs().max())
    assert abs(float(aux) - float(aux_cpu)) <= 1e-6 * float(aux_cpu)


@pytest.mark.parametrize("t,window,block_k", [(700, 256, 128),
                                              (1500, 4096, 512)])
def test_window_and_blocked_attention_on_card_match_cpu(cuda, t, window,
                                                        block_k):
    """_windowed_attention and blocked_attention (S not a multiple of
    block_k) on the card against the CPU, float32 (TF32 off), within 1e-5
    of max |out|; and the two against each other on the card."""
    from repro_torch.models import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(t)
    q = torch.randn(2, 12, t, 128, generator=g)
    k, v = (torch.randn(2, 2, t, 128, generator=g) for _ in range(2))
    win_cpu = attn._windowed_attention(q, k, v, window)
    blk_cpu = attn.blocked_attention(q, k, v, window=window, block_k=block_k)
    win = attn._windowed_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   window)
    blk = attn.blocked_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                 window=window, block_k=block_k)
    scale = float(win_cpu.abs().max())
    for got, want in ((win.cpu(), win_cpu), (blk.cpu(), blk_cpu),
                      (blk.cpu(), win.cpu())):
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_llama3_full_width_two_layers_kernel_matches_plain(cuda):
    """Llama-3-8B's widths (d 4096, 32/8 heads of 128, d_ff 14336, vocab
    128256) at 2 layers in float32: the forward through the kernel against
    the plain path on the card."""
    cfg = dataclasses.replace(get_arch("llama3-8b"), n_layers=2,
                              dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (1, 1000), device=cuda,
                           dtype=torch.int32)
    before = fa_ops.launches
    got, _ = transformer.forward(cfg, params, tokens)
    assert fa_ops.launches == before + 2
    ref, _ = transformer.forward(cfg, params, tokens, use_kernel=False)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel


def test_llama3_full_width_two_layers_prefill_kernel_matches_plain(cuda):
    """The prefill at Llama-3-8B's widths, 2 layers, float32: logits and
    caches through the kernel against the plain path on the card."""
    cfg = dataclasses.replace(get_arch("llama3-8b"), n_layers=2,
                              dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(1), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 1000), device=cuda,
                           dtype=torch.int32)
    before = fa_ops.launches
    got, cache = transformer.prefill_forward(cfg, params, tokens, 1008)
    assert fa_ops.launches == before + 2
    ref, ref_cache = transformer.prefill_forward(cfg, params, tokens, 1008,
                                                 use_kernel=False)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel
    for a, b in zip(cache["layers"], ref_cache["layers"]):
        assert torch.equal(a["attn"]["pos"], b["attn"]["pos"])
        for key in ("k", "v"):
            scale = float(b["attn"][key].abs().max())
            assert float((a["attn"][key] - b["attn"][key]).abs().max()) \
                <= 1e-4 * scale


def test_mla_prefill_and_decode_on_card_match_cpu(cuda):
    """Reduced minicpm3-4b (MLA), float32, TF32 off: the prefill's logits
    and latent caches and 4 absorbed decode steps on the card against the
    same model on the CPU, within 1e-5 of the largest value; no kernel
    launches (MLA runs plain torch on every device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("minicpm3-4b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    params_gpu = copy.deepcopy(params).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    before = (fa_ops.launches, fa_ops.launches_bf16)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        toks = tokens.to(dev)
        logits, cache = transformer.prefill_forward(cfg, p, toks[:, :36], 40)
        steps = [logits]
        for i in range(36, 40):
            logits, cache = transformer.decode_step(
                cfg, p, toks[:, i:i + 1], cache,
                torch.tensor(i, dtype=torch.int32, device=dev))
            steps.append(logits)
        out[dev] = (torch.cat(steps, 1).cpu(),
                    [{k: v.cpu() for k, v in c["attn"].items()}
                     for c in cache["layers"]])
    assert (fa_ops.launches, fa_ops.launches_bf16) == before
    for got, want in zip([out["cuda"][0]] + [c[k] for c in out["cuda"][1]
                                             for k in ("c", "kr")],
                         [out["cpu"][0]] + [c[k] for c in out["cpu"][1]
                                            for k in ("c", "kr")]):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-350m"])
def test_recurrent_prefill_and_decode_on_card_match_cpu(cuda, name):
    """Reduced recurrentgemma-2b (RG-LRU, local attention, its tail) and
    xlstm-350m (mLSTM, sLSTM), float32, TF32 off: the prefill's logits and
    every cache leaf and 4 decode steps on the card against the same model
    on the CPU, within 1e-5 of the largest value; no kernel launches (the
    recurrences and the window are plain torch on every device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    params_gpu = copy.deepcopy(params).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 41), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    before = (fa_ops.launches, fa_ops.launches_bf16)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        toks = tokens.to(dev)
        logits, cache = transformer.prefill_forward(cfg, p, toks[:, :37], 41)
        steps = [logits]
        for i in range(37, 41):
            logits, cache = transformer.decode_step(
                cfg, p, toks[:, i:i + 1], cache,
                torch.tensor(i, dtype=torch.int32, device=dev))
            steps.append(logits)
        out[dev] = [torch.cat(steps, 1).cpu()] + [
            x.cpu() for c in cache["layers"] for leaves in c.values()
            for x in leaves.values()]
    assert (fa_ops.launches, fa_ops.launches_bf16) == before
    for got, want in zip(out["cuda"], out["cpu"]):
        if not want.dtype.is_floating_point:
            assert torch.equal(got, want)
            continue
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def test_rglru_scan_on_card_matches_float64(cuda):
    """The log-depth RG-LRU scan on the card (float32, T = 1000) against
    the sequential recurrence in float64: within u (t - s + 2 ceil(log2 T))
    of each term's magnitude summed (chip_smoke.py's RGLRU_SCAN_BOUND
    derivation), and within 1e-5 of max |h|."""
    from repro_torch.models import rglru
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.rand((2, 1000, 64), generator=g, device=cuda) * 0.9
    b = torch.randn((2, 1000, 64), generator=g, device=cuda)
    _, h = rglru.associative_scan(a, b)
    a64, b64 = a.double(), b.double()
    hh, mag, lag = (torch.zeros_like(b64[:, 0]) for _ in range(3))
    adds = 2 * math.ceil(math.log2(a.shape[1]))
    for i in range(a.shape[1]):
        hh = a64[:, i] * hh + b64[:, i]
        lag = a64[:, i] * (lag + mag)
        mag = a64[:, i] * mag + b64[:, i].abs()
        diff = (h[:, i].double() - hh).abs()
        assert bool((diff <= 1.001 * 2.0 ** -24 * (lag + adds * mag)).all())
    _, h_cpu = rglru.associative_scan(a.cpu(), b.cpu())
    assert float((h.cpu() - h_cpu).abs().max()) <= 1e-6 * float(
        h_cpu.abs().max())


def test_mlstm_chunks_on_card_match_float64(cuda):
    """The chunked mLSTM forward on the card (float32; reduced xlstm-350m,
    chunk 8, T = 50 so the last chunk is padded) against T steps of
    mlstm_decode in float64: relative L2 within 1e-4 (chip_smoke.py's
    MLSTM_CHUNK_BOUND)."""
    from repro_torch.models import ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("xlstm-350m").reduced()
    cell = ssm.MLSTM(cfg, cuda)
    ssm.init_mlstm(cell, cfg, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((2, 50, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    y32 = ssm.mlstm_forward(cfg, cell, x)
    cell64 = copy.deepcopy(cell).double()
    state = {k: v.double() for k, v in
             ssm.init_mlstm_state(cfg, 2, cuda).items()}
    ys = []
    for i in range(x.shape[1]):
        y, state = ssm.mlstm_decode(cfg, cell64, x[:, i:i + 1].double(),
                                    state)
        ys.append(y)
    y64 = torch.cat(ys, 1)
    assert float(torch.linalg.vector_norm(y32.double() - y64)
                 / torch.linalg.vector_norm(y64)) <= 1e-4


def test_whisper_prefill_and_decode_on_card_match_cpu(cuda):
    """Reduced whisper-large-v3 (2 encoder and 2 decoder layers, head dim
    16), float32, TF32 off: the encoder output, the prefill's logits,
    self-attention and cross-attention caches and 4 decode steps on the
    card against the same model on the CPU, within 1e-4 of the largest
    value (the float32 flash kernel adds in another order than the CPU's
    plain attention; the LM tests' float32 bound).  The float32 kernel
    launches once an encoder layer and once a prefill layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("whisper-large-v3").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    params_gpu = copy.deepcopy(params).to(cuda)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                           generator=g)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=g)
    before = (fa_ops.launches, fa_ops.launches_bf16)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        enc = transformer.encode(cfg, p, frames.to(dev))
        toks = tokens.to(dev)
        logits, cache = transformer.prefill_forward(cfg, p, toks[:, :36], 40,
                                                    enc_out=enc)
        steps = [logits]
        for i in range(36, 40):
            logits, cache = transformer.decode_step(
                cfg, p, toks[:, i:i + 1], cache,
                torch.tensor(i, dtype=torch.int32, device=dev))
            steps.append(logits)
        out[dev] = [enc.cpu(), torch.cat(steps, 1).cpu()] + [
            x.cpu() for c in cache["layers"]
            for x in (c["attn"]["k"], c["attn"]["v"], *c["cross_kv"])]
    assert (fa_ops.launches, fa_ops.launches_bf16) == (
        before[0] + cfg.encoder_layers + cfg.n_layers, before[1])
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


def test_whisper_bf16_head_dim_64_goes_through_the_bf16_kernel(cuda):
    """A small bf16 Whisper at its head dim, 64 (2 + 2 layers, d 256, 4/4
    heads), from bf16 frames: encode and forward on the kernel path launch
    the bf16 kernel once a layer and the float32 one never, and land within
    5e-2 of the plain path relative to the largest logit (chip_smoke.py's
    bf16 bound: a last-bit difference in an attention output flips a bf16
    rounding of the residual stream)."""
    cfg = dataclasses.replace(get_arch("whisper-large-v3").reduced(),
                              dtype="bfloat16", head_dim=64, d_model=256)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    frames = torch.randn(2, 300, cfg.d_model, device=cuda,
                         generator=g).bfloat16()
    tokens = torch.randint(0, cfg.vocab, (2, 200), device=cuda,
                           dtype=torch.int32, generator=g)
    before = (fa_ops.launches, fa_ops.launches_bf16)
    enc = transformer.encode(cfg, params, frames)
    got, _ = transformer.forward(cfg, params, tokens, enc_out=enc)
    assert (fa_ops.launches, fa_ops.launches_bf16) == (
        before[0], before[1] + cfg.encoder_layers + cfg.n_layers)
    assert enc.dtype == torch.bfloat16
    plain_enc = transformer.encode(cfg, params, frames, use_kernel=False)
    ref, _ = transformer.forward(cfg, params, tokens, enc_out=plain_enc,
                                 use_kernel=False)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 5e-2, rel


# The backward kernels against attention_bwd_ref on the same values (for
# bf16 their float32 copies).  Float32: both compute in float32 and sum
# the same products in other orders, with expf against torch.exp, so each
# gradient is within 1e-4 of its largest |g|.  Bf16 (the tensor-core
# kernel): a gradient is rounded once more at the end, by at most 2^-8 of
# itself (8 significant bits), and P and dS are rounded to bf16 before
# their products, each by at most 2^-9 of itself, which moves dV by at
# most 2^-9 sum_heads |P|^T |do|, dK by 2^-9 scale sum_heads |dS|^T |q|
# and dQ by 2^-9 scale |dS| |k|; the bound adds those terms at 2^-8
# (``bf16_rounding_terms``, float32 on the plain version), which the CPU
# tests hold the plain emulation of the roundings to.
BWD_TOL = 1e-4


def check_bwd(q, k, v, causal):
    bf16 = q.dtype == torch.bfloat16
    o, lse = (t_fa.attention_with_lse(q, k, v, causal=causal) if bf16
              else (t_fa.attention(q, k, v, causal=causal), None))
    g = torch.Generator(device=q.device).manual_seed(q.shape[2])
    do = torch.randn(o.shape, device=q.device, generator=g).to(q.dtype)
    before = fa_ops.launches_bwd
    got = fa_ops.attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    # float32: statistics, dK/dV, dQ; bf16: Delta, dK/dV, dQ.
    assert fa_ops.launches_bwd == before + 3
    f32 = [x.float() for x in (q, k, v, o, do)]
    ref = t_fa.attention_bwd_ref(*f32, causal=causal)
    terms = (t_fa.bf16_rounding_terms(*f32, causal=causal) if bf16 else
             (0.0, 0.0, 0.0))
    for name, a, r, term in zip("qkv", got, ref, terms):
        assert a.dtype == q.dtype and a.shape == r.shape, name
        bound = BWD_TOL * float(r.abs().max()) + (
            BF16_TOL * r.abs() + term if bf16 else 0.0)
        diff = (a.float() - r).abs()
        assert bool((diff <= bound).all()), (name, float(diff.max()))
    assert all(torch.equal(a, b) for a, b in zip(
        got, fa_ops.attention_bwd(q, k, v, o, do, causal=causal, lse=lse)))


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal", [
    (2, 4, 4, 200, 200, 16, True), (1, 8, 2, 333, 333, 32, True),
    (2, 8, 2, 257, 257, 64, True), (1, 8, 2, 1000, 1000, 128, True),
    (1, 4, 1, 130, 517, 16, False), (2, 8, 8, 64, 100, 32, False),
    (1, 4, 4, 512, 768, 64, False), (1, 8, 2, 1, 300, 128, False),
    (1, 4, 1, 300, 65, 128, False)])
def test_flash_attention_bwd(cuda, b, h, hkv, t, s, d, causal):
    g = torch.Generator(device=cuda).manual_seed(t * 7 + s + d)
    q = torch.randn(b, h, t, d, device=cuda, generator=g)
    k = torch.randn(b, hkv, s, d, device=cuda, generator=g)
    v = torch.randn(b, hkv, s, d, device=cuda, generator=g)
    check_bwd(q, k, v, causal)


@pytest.mark.parametrize("b,h,hkv,t,s,causal", [
    (2, 4, 4, 200, 200, True), (1, 8, 2, 333, 333, True),
    (1, 8, 2, 1000, 1000, True), (1, 16, 4, 2048, 2048, True),
    (1, 4, 1, 130, 517, False), (2, 8, 8, 64, 100, False),
    (2, 12, 2, 1000, 1000, True), (1, 12, 2, 2048, 2048, True)])
def test_flash_attention_bwd_bf16(cuda, b, h, hkv, t, s, causal):
    check_bwd(*bf16_qkv(cuda, b, h, hkv, t, s, 128), causal)


@pytest.mark.parametrize("b,h,hkv,t,s,causal", [
    (1, 20, 20, 1500, 1500, False), (2, 20, 20, 384, 384, True),
    (1, 8, 2, 512, 768, False), (1, 8, 2, 333, 333, True),
    (2, 4, 4, 200, 200, True), (1, 4, 1, 130, 517, False)])
def test_flash_attention_bwd_bf16_head_dim_64(cuda, b, h, hkv, t, s, causal):
    """The bf16 backward's D = 64 instance (Whisper's head width) at the
    encoder's shape, the decoder's causal one and a GQA group with T !=
    S, within the bound of the D = 128 cases."""
    check_bwd(*bf16_qkv(cuda, b, h, hkv, t, s, 64), causal)


@pytest.mark.parametrize("b,h,hkv,t,s,causal", [
    (2, 4, 4, 200, 200, True), (1, 8, 2, 1000, 1000, True),
    (1, 4, 1, 130, 517, False), (1, 8, 2, 1, 300, False)])
def test_flash_attention_bf16_lse(cuda, b, h, hkv, t, s, causal):
    """The bf16 forward's statistic, in natural-log units, against
    torch.logsumexp of the scaled, masked scores: a float32 sum of S terms
    is off by S 2^-24 of itself, doubled for ex2.approx, so S 2^-23; the
    output is the kernel's without the statistic, bit for bit, and the
    rows past T are finite."""
    q, k, v = bf16_qkv(cuda, b, h, hkv, t, s, 128)
    o, lse = t_fa.attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, fa_ops.stat_rows(t))
    assert lse.dtype == torch.float32 and bool(torch.isfinite(lse).all())
    kx = torch.repeat_interleave(k.float(), h // hkv, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kx) / 128 ** 0.5
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool, device=cuda).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    want = torch.logsumexp(scores, dim=-1)
    diff = (lse[..., :t] * math.log(2) - want).abs()
    assert float(diff.max()) <= s * 2 ** -23, float(diff.max())
    assert torch.equal(o, t_fa.attention(q, k, v, causal=causal))


def test_flash_attention_bwd_bf16_needs_the_statistic(cuda):
    """A bf16 backward on the card reads the forward's log-sum-exp and
    raises without it (or with one of another shape); nothing falls back
    to the CUDA-core kernels."""
    q, k, v = bf16_qkv(cuda, 1, 4, 2, 200, 200, 128)
    o, lse = t_fa.attention_with_lse(q, k, v)
    before = fa_ops.launches_bwd
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa_ops.attention_bwd(q, k, v, o, o)
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa_ops.attention_bwd(q, k, v, o, o, lse=lse[..., :200].contiguous())
    assert fa_ops.launches_bwd == before


def test_flash_attention_bf16_kernels_from_a_fresh_thread(cuda):
    """The bf16 forward and backward from a thread that has run no CUDA
    work yet, as autograd's worker thread may be: the entries make the
    tensors' card current before they encode their tensor maps, and give
    the main thread's results bit for bit."""
    import threading
    q, k, v = bf16_qkv(cuda, 2, 8, 2, 300, 300, 128)
    o, lse = t_fa.attention_with_lse(q, k, v)
    do = torch.randn_like(o)
    want = fa_ops.attention_bwd(q, k, v, o, do, lse=lse)
    box = {}

    def run():
        try:
            box["fwd"] = t_fa.attention_with_lse(q, k, v)
            box["bwd"] = fa_ops.attention_bwd(q, k, v, o, do, lse=lse)
            torch.cuda.synchronize()
        except Exception as e:   # re-raised in the test's thread
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in box, box.get("error")
    assert torch.equal(box["fwd"][0], o) and torch.equal(box["fwd"][1], lse)
    assert all(torch.equal(a, b) for a, b in zip(box["bwd"], want))


def test_serving_launches_no_backward_and_writes_no_statistic(cuda):
    """lm_forward's and lm_serve's paths (a full-sequence forward, and
    launch/serve.py's prefill and decode) at a small bf16 config of head
    dim 128 launch the bf16 forward kernel, no backward, and write no
    log-sum-exp; a forward whose parameters need gradients writes one a
    layer."""
    from repro_torch.launch.serve import serve
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="bfloat16", head_dim=128)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(4), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 300), device=cuda,
                           dtype=torch.int32)
    before = (fa_ops.launches_bf16, fa_ops.launches_bwd, fa_ops.lse_written)
    transformer.forward(cfg, params, tokens)
    serve(cfg, params, tokens, 4)
    torch.cuda.synchronize()
    after = (fa_ops.launches_bf16, fa_ops.launches_bwd, fa_ops.lse_written)
    assert after[0] == before[0] + 2 * cfg.n_layers
    assert after[1:] == before[1:]
    params.requires_grad_(True)
    transformer.forward(cfg, params, tokens)
    assert fa_ops.lse_written == before[2] + cfg.n_layers


def test_flash_attention_bwd_single_key(cuda):
    """At S = 1 the softmax is 1 whatever q and k are: dq and dk are 0
    (the kernel's dS = P (dP - Delta) cancels to rounding, within 1e-6 of
    the terms' scale max|do| max|v|) and dv sums do over the group's
    heads, within 1e-4 of its largest |g|."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, 4, 300, 128, device=cuda, generator=g)
    k, v = (torch.randn(1, 1, 1, 128, device=cuda, generator=g)
            for _ in range(2))
    o = t_fa.attention(q, k, v, causal=False)
    do = torch.randn(o.shape, device=cuda, generator=g)
    dq, dk, dv = fa_ops.attention_bwd(q, k, v, o, do, causal=False)
    terms = float(do.abs().max() * v.abs().max())
    assert float(dq.abs().max()) <= 1e-6 * terms * float(k.abs().max())
    assert float(dk.abs().max()) <= 1e-6 * terms * 300 * float(
        q.abs().max())
    want = do.sum(dim=(1, 2), keepdim=True)
    assert float((dv - want).abs().max()) <= BWD_TOL * float(
        want.abs().max())


def test_flash_attention_grad_goes_through_the_bwd_kernel(cuda):
    """attention's autograd backward is one call of the kernel, equal to
    calling it on the saved output."""
    q, k, v = (x.requires_grad_() for x in bf16_qkv(cuda, 2, 8, 2, 300,
                                                    300, 128))
    o = t_fa.attention(q, k, v)
    do = torch.randn_like(o)
    before = fa_ops.launches_bwd
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert fa_ops.launches_bwd == before + 3
    # The statistic the Function saved is the forward kernel's, written
    # again bit for bit by the same launch.
    lse = t_fa.attention_with_lse(q.detach(), k.detach(), v.detach())[1]
    want = fa_ops.attention_bwd(q.detach(), k.detach(), v.detach(),
                                o.detach(), do, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_flash_attention_bwd_raises_outside_its_contract(cuda):
    x = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.attention_bwd(x, x, x, x, x.transpose(2, 3), causal=False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = x.half()
        fa_ops.attention_bwd(h, h, h, h, h)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.zeros(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
        fa_ops.attention_bwd(y, y, y, y, y)
    with pytest.raises(ValueError, match="T == S"):
        kv = torch.zeros(1, 2, 65, 64, device=cuda)
        fa_ops.attention_bwd(x, kv, kv, x, x, causal=True)
    with pytest.raises(ValueError, match="o and do"):
        fa_ops.attention_bwd(x, x, x, x, x[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(2 * 64 * 64 + 1, device=cuda)
        y = flat[1:].view(1, 2, 64, 64)
        fa_ops.attention_bwd(y, y, y, y, y)


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """Three train steps of llama3-8b's reduced config (float32, head dim
    16, GQA group 2), 2 microbatches, delta compression, on the card (the
    float32 flash kernels forward and backward, TF32 off) against the CPU
    from the same weights and batches: step 0's loss and grad_norm within
    1e-5 relative, wire_bytes equal, the loss after 3 steps within 1e-3
    (tests/test_torch_train.py's bounds against the reference)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamWConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), n_kv_heads=2)
    tcfg = tts.TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=10,
                                             total_steps=3),
                           microbatches=2, compression="delta")
    cpu = tts.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                               "cpu")
    card = tts.init_train_state(
        cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        for a, b in zip(card.params.parameters(), cpu.params.parameters()):
            a.copy_(b)
    steps = {s: tts.make_train_step(cfg, tcfg) for s in ("cpu", "cuda")}
    for i in range(3):
        batch = TokenPipeline(cfg.vocab, 64, 4, device="cpu").batch_at(i)
        cpu, met_cpu = steps["cpu"](cpu, batch)
        before = (fa_ops.launches, fa_ops.launches_bwd)
        card, met = steps["cuda"](card, {k: v.to(cuda)
                                         for k, v in batch.items()})
        assert (fa_ops.launches - before[0], fa_ops.launches_bwd -
                before[1]) == (2 * cfg.n_layers, 3 * 2 * cfg.n_layers)
        if i == 0:
            for key in ("loss", "grad_norm"):
                assert abs(float(met[key]) - float(met_cpu[key])) <= \
                    1e-5 * abs(float(met_cpu[key])), key
            assert float(met["wire_bytes"]) == float(met_cpu["wire_bytes"])
    assert abs(float(met["loss"]) - float(met_cpu["loss"])) <= \
        1e-3 * abs(float(met_cpu["loss"]))


@pytest.mark.parametrize("resume", ["sparse", "dense"])
@pytest.mark.parametrize("algo", ["pagerank", "sssp", "connected_components"])
def test_view_repair_on_card_matches_cpu(cuda, algo, resume):
    """A view's cold run and two warm repairs on the card, through the
    kernels, against the same view on the CPU's torch-op path: SSSP and
    CC exactly (min is order-free), PageRank within 1e-5 relative (run
    to the float32 fixpoint, threshold 1e-7, so the atomics' order moves
    only the last bits).  ``dense``: a tiny resume budget sends the
    repairs through edge_propagate, whose CSC must follow each refresh's
    graph."""
    from repro_torch.incremental import EdgeDelete, EdgeInsert, ViewManager
    n, S = 1024, 4
    indptr, indices = make_powerlaw_graph(n, avg_degree=6.0, seed=2)
    params = dict(max_iters=300)
    if algo == "pagerank":
        params["threshold"] = 1e-7
    if resume == "dense":
        params.update(resume_edge_capacity=64, resume_src_capacity=16)
    views = {dev: ViewManager(fallback_threshold=2.0).create_graph_view(
        "v", algo, indptr, indices, n, num_shards=S, device=dev,
        use_kernels=dev != "cpu", **params) for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(0)

    def close(a, b):
        if algo == "pagerank":
            return bool(np.all(np.abs(a - b) <= 1e-5 * np.abs(b)))
        return np.array_equal(a, b)

    assert close(views["cuda"].query(), views["cpu"].query())
    dense_repairs = 0
    for _ in range(2):
        src, dst = views["cpu"].store.edges()
        muts = [EdgeInsert(int(rng.integers(n)), int(rng.integers(n)))
                for _ in range(12)]
        muts += [EdgeDelete(int(src[i]), int(dst[i]))
                 for i in rng.choice(len(src), 12, replace=False)]
        counters = (sr_ops, dr_ops, ds_ops, ep_ops)
        before = [c.launches for c in counters]
        for view in views.values():
            view.apply(*muts)
            assert view.refresh().mode == "repair"
        ran = [c.launches > b for c, b in zip(counters, before)]
        # The kernels the card's strata must have launched, by its stats.
        st = views["cuda"].last_result.stats
        it = int(st.iterations)
        dense = st.used_dense[:it].tolist()
        routes = set(st.routes[:it].tolist())
        assert ran == [ROUTE_SCATTER in routes, ROUTE_SORT in routes,
                       not all(dense), any(dense)]
        dense_repairs += any(dense)
        assert all(x.is_cuda for x in views["cuda"].state)
        assert close(views["cuda"].query(), views["cpu"].query())
        if algo != "pagerank":
            for f in ("delta_counts", "used_dense", "tiers", "routes"):
                assert torch.equal(
                    getattr(views["cuda"].last_result.stats, f),
                    getattr(views["cpu"].last_result.stats, f))
    if resume == "dense":
        assert dense_repairs == 2


@pytest.mark.parametrize("route", ["auto", "sort"])
def test_shard_map_world1_nccl_matches_simulated(cuda, route, tmp_path):
    """The shard_map backend over NCCL, a world of one rank on cuda:0:
    SSSP and CC equal the simulated backend's run exactly (values and
    every stats column; min is order-free), nodelta PageRank too (the
    dense body has no atomics), delta PageRank within 1e-5 relative at
    threshold 1e-7; every graph kernel is launched."""
    import torch.distributed as dist
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.fixpoint import StratumStats
    from repro_torch.launch.mesh import flat_mesh, init_shard_group
    n, S = 4096, 8
    indptr, indices = make_powerlaw_graph(n, avg_degree=8.0, seed=1)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    g = shard_csr(indptr, indices, S, device=cuda)
    cap = dict(edge_capacity=4 * n, src_capacity=snap.block_size)
    ex = dict(snapshot=snap, seg_capacity=4 * n, ladder_tiers=4,
              route_strategy=route, **cap)
    init_shard_group("nccl", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    try:
        smap = ShardedExecutor(backend="shard_map", mesh=flat_mesh(S), **ex)
        before = [c.launches for c in (sr_ops, dr_ops, ds_ops, ep_ops)]
        for run, kw, exact in (
                (sssp.run, dict(source=0), True),
                (cc.run, {}, True),
                (pagerank.run, dict(mode="nodelta"), True),
                (pagerank.run, dict(threshold=1e-7, max_iters=200), False)):
            want = run(g, snap, executor=ShardedExecutor(**ex), **cap, **kw)
            got = run(g, snap, executor=smap, **cap, **kw)
            if exact:
                assert torch.equal(want[0], got[0])
                for f in StratumStats._fields:
                    assert torch.equal(getattr(want[1].stats, f),
                                       getattr(got[1].stats, f)), f
            else:
                torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                           atol=0)
        after = [c.launches for c in (sr_ops, dr_ops, ds_ops, ep_ops)]
    finally:
        dist.destroy_process_group()
    route_kernel = 0 if route == "auto" else 1
    assert after[route_kernel] > before[route_kernel]
    assert after[2] > before[2] and after[3] > before[3]


def test_local_worker_acks_with_work_on_the_card(cuda, tmp_path):
    """A ``torch_mode="local"`` worker brings CUDA up before its first
    heartbeat, and each of its acks carries a sum computed on the card."""
    from repro_torch.launch.distributed import Cluster
    from repro_torch.runtime.health import HealthConfig, ack_path, read_json
    cluster = Cluster(str(tmp_path / "cluster"), 1, num_shards=2,
                      torch_mode="local",
                      config=HealthConfig(ack_timeout=30.0,
                                          ready_timeout=120.0))
    try:
        cluster.start()
        ready = read_json(str(tmp_path / "cluster" / "worker0" /
                              "ready.json"))
        assert ready["device"] == "cuda" and ready["torch"] == "local"
        for stratum in range(3):
            bseq, t0 = cluster.broadcast_stratum(stratum)
            walls = cluster.collect_acks(bseq, t0)
            assert walls[0] is not None and walls[0] >= 0
            ack = read_json(ack_path(cluster.root, 0, bseq))
            assert ack["stratum"] == stratum
            assert ack["device_work"] == 255 * 256 / 2 + 256 * bseq
    finally:
        cluster.shutdown()
    assert not cluster.procs[0].alive()


def test_selftest_forms_an_nccl_world_of_one(cuda):
    """The bring-up selftest as chip_smoke.py's ``launch_selftest`` runs
    it: one NCCL rank on ``cuda:0`` owning every shard."""
    from repro_torch.launch.distributed import selftest
    rep = selftest(1, 4, backend="nccl")
    assert rep["backend"] == "nccl" and rep["collective_ok"]
    assert rep["devices"] == {"0": "cuda:0"}
    assert rep["ownership"] == {"0": [0, 1, 2, 3]}


@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group, make_mesh
    init_shard_group("nccl", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("hooked", [False, True])
def test_sharded_train_step_on_a_one_rank_nccl_mesh(one_rank_mesh, hooked):
    """The DTensor train step on a (1, 1) mesh against the plain step from
    the same weights and batch (reduced llama3-8b, float32, 2
    microbatches): the loss and grad_norm within 1e-6 relative, through
    the float32 flash kernels forward and backward."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.sharding import make_gather_fn
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamWConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), n_kv_heads=2)
    mets = {}
    for sharded in (False, True):
        tcfg = tts.TrainConfig(
            adamw=AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3),
            microbatches=2,
            gather_fn=make_gather_fn(one_rank_mesh) if hooked else None)
        state = tts.init_train_state(
            cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        if sharded:
            state = tts.shard_train_state(state, one_rank_mesh)
        batch = TokenPipeline(cfg.vocab, 64, 4, device=cuda).batch_at(0)
        before = (fa_ops.launches, fa_ops.launches_bwd)
        _, met = tts.make_train_step(cfg, tcfg)(state, batch)
        assert (fa_ops.launches - before[0], fa_ops.launches_bwd -
                before[1]) == (2 * cfg.n_layers, 3 * 2 * cfg.n_layers)
        mets[sharded] = met
    for key in ("loss", "grad_norm"):
        want = float(mets[False][key])
        assert abs(float(mets[True][key]) - want) <= 1e-6 * abs(want), key


def test_flash_decode_on_a_one_rank_nccl_mesh(one_rank_mesh):
    """Reduced llama3-8b on the card: 4 teacher-forced steps of flash
    decoding under the ambient (1, 1) mesh within 1e-5 of the full decode
    (float32)."""
    import copy
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.sharding import shard_cache
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("llama3-8b").reduced()
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = TokenPipeline(cfg.vocab, 24, 2, device=cuda).batch_at(0)[
        "tokens"]
    with torch.no_grad():
        _, cache = transformer.prefill_forward(cfg, params, tokens[:, :20],
                                               24)
        shard = shard_cache(copy.deepcopy(cache), one_rank_mesh, cfg)
        full, flash = [], []
        with set_mesh(one_rank_mesh):
            for i in range(20, 24):
                pos = torch.tensor(i, device=cuda)
                full.append(transformer.decode_step(
                    cfg, params, tokens[:, i:i + 1], cache, pos)[0])
                flash.append(transformer.decode_step(
                    cfg, params, tokens[:, i:i + 1], shard, pos,
                    flash_decode=True)[0])
    full, flash = torch.cat(full, 1), torch.cat(flash, 1)
    assert float((full - flash).abs().max() / full.abs().max()) <= 1e-5


def test_a2a_dispatch_on_a_one_rank_nccl_mesh(one_rank_mesh):
    """Reduced mixtral-8x22b's experts on the card at a capacity factor of
    E / k (nothing dropped): the a2a dispatch under the (1, 1) mesh within
    1e-5 of max |y| of the sort dispatch on the same routes."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("mixtral-8x22b").reduced()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda).layers[0].ffn
    x = torch.randn(256, cfg.d_model, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        top_e, top_p, _ = moe._route(cfg, params, x)
        want = moe._dispatch_sort(cfg, params, x, top_e, top_p,
                                  moe._capacity(cfg, x.shape[0]))
        with set_mesh(one_rank_mesh):
            got = moe._dispatch_a2a(cfg, params, x, top_e, top_p)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
