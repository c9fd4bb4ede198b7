"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  This file imports
only the port, so it also runs where the reference's JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Integer outputs and min/max results must match exactly; float adds land
in atomic order, so add results are within 1e-5 relative.  kmeans_assign's
d² may differ from the plain version's product by rounding, so an
assignment may differ only where the plain version's best two d² lie
within 4 ulp of |p|² + |c|².  flash_attention is within 2e-4 abs + 2e-4
rel of its plain version (the reference's kernel-vs-oracle bound), and a
2-layer full-width Llama-3 forward through it within 1e-4 of the plain
path relative to the largest logit (float32, TF32 off).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.algorithms import connected_components as cc
from repro_torch.configs import get_arch
from repro_torch.algorithms import kmeans, pagerank, sssp
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
                                        ("max", 1), ("min", 3)])
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


@pytest.mark.parametrize("combiner", ["add", "min", "max"])
def test_delta_scatter(cuda, combiner):
    rng = np.random.default_rng(2)
    n, c = 100_000, 400_000
    state = t(rng.normal(size=(n, 1)).astype(np.float32), cuda)
    idx = t(rng.integers(-1, n + 5, size=c).astype(np.int32), cuda)
    pay = t(rng.normal(size=(c, 1)).astype(np.float32), cuda)
    before = ds_ops.launches
    got = t_ds.delta_scatter(state, idx, pay, combiner)
    ref = t_ds.delta_scatter_ref(state, idx, pay, combiner)
    assert ds_ops.launches == before + 1
    if combiner == "add":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, ref)


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
