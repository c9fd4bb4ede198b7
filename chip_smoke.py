#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--n 3300000] [--shards 8] [--seed 0]
                          [--points 382000000]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a, into ``build/kernels/``), then runs the paper's three benchmark
algorithms and connected components at the paper's sizes (§6 "Data"):

* the DBPedia-shaped graph (3.3 M vertices, average degree 14.5, Zipf
  exponent 2.1), 8 shards, capacity ladder of 4 rungs, edge capacity 4n,
  source capacity one block (the settings of ``bench_pagerank.py`` and
  ``bench_sssp.py``):
  - PageRank (threshold 1e-3, at most 60 strata): ``delta_auto``
    (scatter_route + delta_scatter, add), ``delta_sort`` (delta_route +
    delta_scatter) and ``nodelta`` (edge_propagate), each checked against
    a float64 power iteration on the card (bound 1e-2), delta_sort against
    delta_auto (1e-2), and delta against nodelta at threshold 1e-5
    (5e-3);
  - SSSP from vertex 0 (at most 80 strata): ``sssp_auto`` (scatter_route +
    delta_scatter, min), ``sssp_sort`` (delta_route + delta_scatter) and
    ``sssp_nodelta`` (edge_propagate, min), each exactly equal to a
    level-synchronous BFS on the card (``sssp.reference_sssp``);
  - connected components: ``cc_auto`` and ``cc_nodelta``, each exactly
    equal to a dense min-label iteration on the card
    (``connected_components.reference_components``);
* k-means on 382 M geo points (47.75 M a shard, 8 shards), k = 32, at most
  60 strata (``bench_kmeans.py``'s settings at the paper's largest size):
  ``kmeans_delta`` and ``kmeans_nodelta`` (kmeans_assign), each within
  3e-3 (coordinates; cloud spread 3.0) of a float64 Lloyd iteration of the
  same shape on the card, and of each other;
* the dense LM serving path at Llama-3-8B's full width and depth (32
  layers, d 4096, GQA 32/8 heads of 128, d_ff 14,336, vocab 128,256, bf16
  weights from the port's seeded init), tokens from ``TokenPipeline``:
  - ``lm_forward``: the full-sequence forward at 2 x 4096 tokens
    (``train_4k``'s sequence, its batch of 256 cut to 2), 32
    flash_attention launches, its logits against the plain attention
    path (``use_kernel=False``) within 5e-2 of the largest logit; and
    at full width, 4 layers, float32 (TF32 off) within 1e-4, as are 8
    teacher-forced decode steps after a prefill against that forward;
  - ``lm_serve``: ``launch/serve.py``'s ``serve`` on 8 requests of 2048
    prompt tokens and 64 greedy new tokens (32 flash_attention launches,
    all in the prefill), the prefill's last-position logits against the
    forward's (within one bf16 ulp of the largest logit) and against the
    prefill's plain attention path (``use_kernel=False``, 5e-2), and 8
    teacher-forced decode steps against a forward over the extended
    sequence (5e-2); each bound's reason is stated beside it below.

Each kernel is held against its plain torch version on the card at the
inputs the main path gives it: integer outputs and min results exactly,
added floats within 1e-5 relative (atomics reorder float adds), and
kmeans_assign's assignment exactly except at near-ties of the plain
version (best two d² within 4 ulp of |p|² + |c|²), counted and printed,
and flash_attention within 2e-4 abs + 2e-4 rel (the reference's
kernel-vs-oracle bound) at the forward's and the prefill's shapes (inputs
of layer 0), a ragged causal shape and a non-causal one.
edge_propagate's row bins (light rows, heavy rows of more than 32 edges,
and the heavy rows' edges) are printed beside its checks.
The kernel, its plain version and, where one torch call computes the same
function, that call are timed (CUDA events around at least 5 calls, or 2
for the slowest plain versions, and at least 20 ms).  Each phase runs
with every kernel's launch count set to 0 and fails if a kernel of its
path was not launched.

Prints the card, the kernels as one JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failed check,
and without a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
TIME_MIN_MS = 20.0          # least event-timed span of a kernel row
FLOAT_RTOL = 1e-5
ACCURACY_BOUND = 5e-3       # delta vs nodelta / vs oracle at threshold 1e-5
PHASE_BOUND = 1e-2          # ten times the phases' threshold of 1e-3
KMEANS_BOUND = 3e-3         # centroid coordinates, cloud spread 3.0
KMEANS_K = 32               # centroids, and clusters of the generated cloud
KMEANS_STRATA = 60          # cap on Lloyd strata (bench_kmeans.py's)
KMEANS_CHUNK = 1 << 23      # points per chunk of the plain and f64 passes
FLASH_TOL = 2e-4            # abs and rel, tests/test_kernels.py's bound
LM_ARCH = "llama3-8b"
# The LM phases' shapes: the forward at train_4k's sequence with its batch
# cut to 2; serving 8 prompts of 2048 tokens, 64 new tokens; the float32
# check at 4 layers; 8 teacher-forced decode steps.
LM_SHAPES = dict(fwd_batch=2, fwd_seq=4096, serve_batch=8, prompt=2048,
                 new=64, tight_layers=4, decode_steps=8)
# Logit errors as max |diff| / max |logit|.  Float32: the kernel and the
# plain version differ by ~1e-6, which 4 layers carry to ~4e-6.  Bf16 at
# full depth: a last-bit difference in an attention output flips a bf16
# rounding of the residual stream, and 32 layers carry it; two readings of
# the kernel path against the plain path, 1.531e-2 and 1.653e-2, and of
# teacher-forced decode against the forward, 1.534e-2 and 1.581e-2, set
# these bounds at about 3x the worst.  The prefill's last-position logits
# equal the forward's (two readings of 0); the bound is one bf16 ulp of
# the largest logit, the most that rounding the head product for one row
# in another order than for all rows could move them.
LM_TIGHT_BOUND = 1e-4       # float32, 4 layers
LM_BF16_BOUND = 5e-2        # bf16, kernel vs plain path, full depth
LM_DECODE_BOUND = 5e-2      # bf16, teacher-forced decode vs the forward
LM_PREFILL_BOUND = 2 ** -8  # bf16, prefill vs the forward (one ulp)
OFF_PATH = "off_path"       # flash rows at shapes no LM phase runs
# The flash rows at shapes no LM phase runs: label -> ((B, H, H_kv, T, S,
# D), causal).
FLASH_OFF_PATH = {"ragged": ((2, 32, 8, 1000, 1000, 128), True),
                  "noncausal": ((2, 16, 16, 512, 768, 64), False)}
# The graph phases: name -> (algorithm module, mode, route, combiner,
# kernels its path must launch), run at RUN_SETTINGS (bench_pagerank.py's
# and bench_sssp.py's).
GRAPH_PHASES = {
    "delta_auto": ("pagerank", "delta", "auto", "add",
                   ("scatter_route", "delta_scatter")),
    "delta_sort": ("pagerank", "delta", "sort", "add",
                   ("delta_route", "delta_scatter")),
    "nodelta": ("pagerank", "nodelta", "sort", "add", ("edge_propagate",)),
    "sssp_auto": ("sssp", "delta", "auto", "min",
                  ("scatter_route", "delta_scatter")),
    "sssp_sort": ("sssp", "delta", "sort", "min",
                  ("delta_route", "delta_scatter")),
    "sssp_nodelta": ("sssp", "nodelta", "sort", "min", ("edge_propagate",)),
    "cc_auto": ("connected_components", "delta", "auto", "min",
                ("scatter_route", "delta_scatter")),
    "cc_nodelta": ("connected_components", "nodelta", "sort", "min",
                   ("edge_propagate",)),
}
RUN_SETTINGS = {"pagerank": dict(threshold=1e-3, max_iters=60),
                "sssp": dict(source=0, max_iters=80),
                "connected_components": dict(max_iters=80)}

KERNELS = {  # name: (source, TPU kernel it replaces)
    "scatter_route": ("src/repro_torch/kernels/csrc/scatter_route.cu",
                      "src/repro/kernels/scatter_route/scatter_route.py:112"),
    "delta_route": ("src/repro_torch/kernels/csrc/delta_route.cu",
                    "src/repro/kernels/delta_route/delta_route.py:100"),
    "delta_scatter": ("src/repro_torch/kernels/csrc/delta_scatter.cu",
                      "src/repro/kernels/delta_scatter/delta_scatter.py:73"),
    "edge_propagate": ("src/repro_torch/kernels/csrc/edge_propagate.cu",
                       "src/repro/kernels/edge_propagate/"
                       "edge_propagate.py:71"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:40"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:80"),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 5) -> float:
    """Milliseconds a call: CUDA events around ``reps`` calls after one
    warm-up, and again around enough calls to fill TIME_MIN_MS when the
    first ``reps`` took less (a kernel of microseconds timed over a few
    calls reads the card's clocks still rising)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(n):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    ms = timed(reps)
    if ms < TIME_MIN_MS:
        reps = math.ceil(reps * TIME_MIN_MS / max(ms, 1e-3))
        ms = timed(reps)
    return ms / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(name: str, got, ref, float_idx=()) -> float:
    """Outputs in ``float_idx`` within FLOAT_RTOL relative, all others
    exactly; returns the max absolute difference over the float outputs."""
    import torch
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: output {i} is {g.dtype}{tuple(g.shape)}, plain "
              f"version {r.dtype}{tuple(r.shape)}")
        if not g.dtype.is_floating_point:
            check(torch.equal(g, r), f"{name}: output {i} differs")
            continue
        diff = torch.where(g == r, 0.0, (g - r).abs())   # inf == inf
        if diff.numel():
            err = max(err, float(diff.max()))
        if i in float_idx:
            ok = bool(torch.all(diff <= FLOAT_RTOL * r.abs() + 1e-30))
            check(ok, f"{name}: float output {i} off by up to {err:.3e} "
                      f"(rtol {FLOAT_RTOL})")
        else:
            check(torch.equal(g, r), f"{name}: output {i} differs")
    return err


def row(name, combiner, err, ms, plain_ms, b, library_ms, shape,
        label=None):
    """One kernel check.  ``combiner`` groups the phases whose launches
    the row reports: a combiner, or an LM phase's name (None: every
    phase); ``label`` names the row when it is not the kernel's name with
    its combiner."""
    return dict(name=name, combiner=combiner, err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=library_ms, shape=shape, label=label)


def row_name(r) -> str:
    """The row's name in the kernels JSON line."""
    if r["label"]:
        return r["label"]
    if r["combiner"] in (None, "add"):
        return r["name"]
    return f"{r['name']}/{r['combiner']}"


def print_rows(rows) -> None:
    for r in rows:
        lib = (f"{r['library_ms']:.3f} ms" if r["library_ms"] is not None
               else "none")
        name = r["label"] or f"{r['name']} [{r['combiner']}]"
        print(f"kernel {name}: {r['shape']} ok "
              f"max_abs_err {r['err']:.3e} kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) library {lib}", flush=True)


def scatter_route_row(out, snap, seg, combiner):
    """scatter_route on one shard's outgoing deltas ``out`` at rung
    capacity ``seg``."""
    import torch
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.kernels import scatter_route as sr
    S, B = snap.num_shards, snap.block_size
    keys = out.keys
    owners = torch.where(keys != PAD_KEY, snap.owner_of(keys), S)
    args = (keys, out.payload, snap.local_index(keys), owners, S, B, seg,
            combiner)
    got = sr.scatter_route(*args)
    ref = sr.scatter_route_ref(*args)
    err = compare(f"scatter_route/{combiner}", got, ref,
                  float_idx=(1,) if combiner == "add" else ())
    # Every key is read; local, owner and payload only for live keys.
    live = int((keys != PAD_KEY).sum())
    W = out.payload.shape[1]
    b = bound(keys.numel() * 4 + live * (8 + 4 * W) + nbytes(*got), live * W)
    return row("scatter_route", combiner, err,
               time_ms(lambda: sr.scatter_route(*args)),
               time_ms(lambda: sr.scatter_route_ref(*args)), b, None,
               f"C={keys.numel()} live={live} S={S} B={B} cap={seg}")


def delta_scatter_row(state, idx, pay, combiner):
    """delta_scatter of one shard's incoming deltas into ``state``."""
    import torch
    from repro_torch.kernels import delta_scatter as ds
    B, W = state.shape
    got = ds.delta_scatter(state, idx, pay, combiner)
    ref = ds.delta_scatter_ref(state, idx, pay, combiner)
    err = compare(f"delta_scatter/{combiner}", [got], [ref],
                  float_idx=(0,) if combiner == "add" else ())
    # Every index is read; the payload only where it is in range; the
    # state is read and written once.
    in_range = (idx >= 0) & (idx < B)
    live = int(in_range.sum())
    b = bound(nbytes(idx) + live * 4 * W + 2 * nbytes(state), live * W)
    lib_idx = torch.where(in_range, idx, B).long()
    if combiner == "add":
        lib = lambda: torch.zeros((B + 1, W), device=state.device).index_add_(
            0, lib_idx, pay)
    else:
        fill = float("inf") if combiner == "min" else float("-inf")
        lib = lambda: torch.full((B + 1, W), fill, device=state.device
                                 ).scatter_reduce_(
            0, lib_idx[:, None].expand(-1, W), pay, "a" + combiner)
    return row("delta_scatter", combiner, err,
               time_ms(lambda: ds.delta_scatter(state, idx, pay, combiner)),
               time_ms(lambda: ds.delta_scatter_ref(state, idx, pay,
                                                    combiner)),
               b, time_ms(lib), f"N={B} C={idx.numel()} live={live}")


def edge_propagate_bins(csc, label) -> None:
    """Prints the CSC's row bins: light rows, heavy rows, heavy edges."""
    from repro_torch.kernels import edge_propagate as ep
    heavy = csc.heavy.long()
    n_dst = csc.indptr.numel() - 1
    heavy_edges = int((csc.indptr[heavy + 1] - csc.indptr[heavy]).sum())
    print(f"{label} bins: light rows {n_dst - heavy.numel()}, heavy rows "
          f"{heavy.numel()} (> {ep.HEAVY_EDGES} edges), heavy edges "
          f"{heavy_edges} of {csc.src.numel()}", flush=True)


def edge_propagate_row(payload, csc, combiner, also=()):
    """edge_propagate of one shard's dense stratum over ``csc``, timed at
    ``payload`` and held to its plain version at ``payload`` and each of
    ``also``."""
    import torch
    from repro_torch.kernels import edge_propagate as ep
    plain_csc = (csc.indptr, csc.src, csc.weight)
    n_pad = csc.indptr.numel() - 1
    err = 0.0
    for x in (payload, *also):
        got = ep.edge_propagate(x, csc, combiner)
        ref = ep.edge_propagate_ref(x, *plain_csc, combiner)
        err = max(err, compare(f"edge_propagate/{combiner}", [got], [ref],
                               float_idx=(0,) if combiner == "add" else ()))
    n_edges = csc.src.numel()
    # The function's bytes: the heavy list is the layout's, not the work's.
    b = bound(nbytes(payload, *plain_csc, got), 2 * n_edges)
    dst = torch.repeat_interleave(
        torch.arange(n_pad, device=payload.device),
        (csc.indptr[1:] - csc.indptr[:-1]).long(), output_size=n_edges)
    if combiner == "add":
        lib = lambda: torch.zeros(n_pad, device=payload.device).index_add_(
            0, dst, payload[csc.src] * csc.weight)
    else:
        lib = lambda: torch.full(
            (n_pad,), float("inf") if combiner == "min" else float("-inf"),
            device=payload.device).scatter_reduce_(
            0, dst, payload[csc.src] * csc.weight, "a" + combiner)
    return row("edge_propagate", combiner, err,
               time_ms(lambda: ep.edge_propagate(payload, csc, combiner)),
               time_ms(lambda: ep.edge_propagate_ref(payload, *plain_csc,
                                                     combiner)),
               b, time_ms(lib), f"n_dst={n_pad} E={n_edges} "
                                f"N_src={payload.numel()}")


def pagerank_edge_row(graph, snap, csc):
    """edge_propagate (add) over shard 0's ``csc`` at the first dense
    stratum from PageRank's initial state."""
    import torch
    from repro_torch.algorithms import pagerank
    from repro_torch.core.engine import _take
    g0 = _take(graph, 0)
    pr = pagerank.current_pr(_take(pagerank.initial_state(snap,
                                                          graph.device), 0))
    payload = pr / torch.clamp(g0.out_degree, min=1).to(pr.dtype)
    return edge_propagate_row(payload, csc, "add")


def sssp_edge_row(graph, snap, csc, also=()):
    """edge_propagate (min) over shard 0's ``csc`` at ``sssp_nodelta``'s
    first stratum, where every payload but the source's is inf; held also
    at the payloads of the distances ``also``."""
    import torch
    from repro_torch.algorithms import sssp

    def payload_of(d):
        return torch.where(d < float("inf"), d + 1.0, float("inf"))

    d0 = sssp.initial_state(snap, 0, graph.device).dist[0]
    return edge_propagate_row(payload_of(d0), csc, "min",
                              also=tuple(payload_of(d) for d in also))


def shard0_csc(graph, snap):
    """Shard 0's ragged CSC over every padded destination, as the nodelta
    phases build it."""
    from repro_torch.core.engine import _take
    from repro_torch.kernels import edge_propagate as ep
    return ep.build_csc(_take(graph, 0), snap.padded_keys)


def pagerank_kernel_checks(graph, snap, ex, algo):
    """Each PageRank kernel against its plain version at the first
    stratum's inputs (the first dense stratum for edge_propagate)."""
    import torch
    from repro_torch.algorithms import emission, pagerank
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take
    from repro_torch.core.handlers import pre_aggregate
    from repro_torch.kernels import delta_route as dr

    S, B = snap.num_shards, snap.block_size
    top = ex.capacity_tiers(algo)[-1]
    state = pagerank.initial_state(snap, graph.device)
    parts = []
    for s in range(S):
        st, g = _take(state, s), _take(graph, s)
        active, _ = algo.active_fn(st, g)
        parts.append(algo.sparse_emit(st, g, active, 0, s)[1])
    out0 = parts[0]
    rows = [scatter_route_row(out0, snap, top.seg, "add")]

    # delta_route: shard 0's pre-aggregated deltas (sort strategy).
    agg = pre_aggregate(out0, "add")
    owners = torch.where(agg.keys != PAD_KEY, snap.owner_of(agg.keys), S)
    args = (agg.keys, agg.payload, agg.ann, owners, S, top.seg)
    got = dr.delta_route(*args)
    ref = dr.delta_route_ref(*args)
    err = compare("delta_route", got, ref)
    # Every key is read; owner, payload and ann only for live keys.
    live = int((agg.keys != PAD_KEY).sum())
    W = agg.payload.shape[1]
    b = bound(agg.keys.numel() * 4 + live * (5 + 4 * W) + nbytes(*got), 0)
    rows.append(row("delta_route", None, err,
                    time_ms(lambda: dr.delta_route(*args)),
                    time_ms(lambda: dr.delta_route_ref(*args)), b, None,
                    f"C={agg.keys.numel()} live={live} S={S} "
                    f"cap={top.seg}"))
    del got, ref, args, agg

    # delta_scatter: shard 0's incoming deltas after the segment swap.
    incoming, _ = ex.rehash_sparse_simulated(_stack(parts), top.seg, "add",
                                             "scatter")
    del parts, out0
    in0 = _take(incoming, 0)
    idx = emission.to_local_keys(in0, 0, B).contiguous()
    pay = in0.payload.contiguous()
    del incoming, in0
    rows.append(delta_scatter_row(
        torch.zeros((B, 1), device=graph.device), idx, pay, "add"))
    del idx, pay

    # edge_propagate: shard 0's dense stratum from the initial state.
    csc = shard0_csc(graph, snap)
    edge_propagate_bins(csc, "edge_propagate/add")
    rows.append(pagerank_edge_row(graph, snap, csc))
    torch.cuda.empty_cache()
    return rows


def sssp_kernel_checks(graph, snap, ex, algo, stats):
    """The min kernels: scatter_route and delta_scatter at the widest
    sparse stratum of ``sssp_auto`` that routed at the top rung (the
    widest sparse one if none did), edge_propagate at ``sssp_nodelta``'s
    first stratum, where every payload but the source's is inf, and held
    also at that widest stratum's, where most are finite."""
    import torch
    from repro_torch.algorithms import emission, sssp
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take

    S, B = snap.num_shards, snap.block_size
    tiers = ex.capacity_tiers(algo)
    it = int(stats.iterations)
    tier_of = stats.tiers[:it].tolist()
    emitted = stats.delta_counts[:it].tolist()
    widest = max(t for t in tier_of)
    check(widest >= 0, "sssp_auto ran no sparse stratum")
    at = max((i for i in range(it) if tier_of[i] == widest),
             key=lambda i: emitted[i])
    step = ex.make_stratum_fn(algo, graph)
    state = sssp.initial_state(snap, 0, graph.device)
    for i in range(at):
        state, _ = step(state, i)
    tier = tiers[widest]
    emit_fn = ex._emit_fn(algo, tier)
    parts = []
    for s in range(S):
        st, g = _take(state, s), _take(graph, s)
        active, _ = algo.active_fn(st, g)
        parts.append(emit_fn(st, g, active, at, s)[1])
    src = max(range(S), key=lambda s: int((parts[s].keys != PAD_KEY).sum()))
    print(f"sssp min checks at stratum {at} (rung {widest}: {tier.src} src, "
          f"{tier.edge} edge, {tier.seg} seg), source shard {src}",
          flush=True)
    rows = [scatter_route_row(parts[src], snap, tier.seg, "min")]

    incoming, _ = ex.rehash_sparse_simulated(_stack(parts), tier.seg, "min",
                                             "scatter")
    del parts
    dst = max(range(S), key=lambda s: int((incoming.keys[s] != PAD_KEY)
                                          .sum()))
    in_s = _take(incoming, dst)
    idx = emission.to_local_keys(in_s, dst, B).contiguous()
    pay = in_s.payload.contiguous()
    dist = state.dist[dst][:, None].contiguous()
    mid = state.dist[0]
    del incoming, in_s, state
    rows.append(delta_scatter_row(dist, idx, pay, "min"))
    del idx, pay, dist

    d0 = sssp.initial_state(snap, 0, graph.device).dist[0]
    print(f"edge_propagate min: finite payloads {int(torch.isfinite(d0).sum())}"
          f" at stratum 0, {int(torch.isfinite(mid).sum())} at stratum {at} "
          f"of {mid.numel()}", flush=True)
    csc = shard0_csc(graph, snap)
    edge_propagate_bins(csc, "edge_propagate/min")
    rows.append(sssp_edge_row(graph, snap, csc, also=(mid,)))
    torch.cuda.empty_cache()
    return rows


def kmeans_kernel_check(points, cents):
    """kmeans_assign at the full shape, against its plain version run in
    chunks (the plain [N, K] matrix would not fit)."""
    import torch
    from repro_torch.kernels import kmeans_assign as ka
    N, D = points.shape
    K = cents.shape[0]
    got_a, got_d = ka.assign(points, cents)
    eps = torch.finfo(torch.float32).eps
    c2 = (cents ** 2).sum(-1)
    n_near = n_differ = 0
    err = 0.0
    for lo in range(0, N, KMEANS_CHUNK):
        p = points[lo:lo + KMEANS_CHUNK]
        d2 = ka.kmeans_d2(p, cents)
        top2, arg2 = d2.topk(2, largest=False)
        ref_a = arg2[:, 0].to(torch.int32)
        # topk and argmin agree except at exact ties; argmin takes the
        # first index, which is the contract.
        ref_a = torch.where(top2[:, 0] == top2[:, 1],
                            torch.argmin(d2, -1).to(torch.int32), ref_a)
        a, d = got_a[lo:lo + KMEANS_CHUNK], got_d[lo:lo + KMEANS_CHUNK]
        scale = (p ** 2).sum(-1) + torch.maximum(c2[a.long()],
                                                 c2[ref_a.long()])
        tol = 4 * eps * scale
        near = (top2[:, 1] - top2[:, 0]) <= tol
        differ = a != ref_a
        check(bool((~differ | near).all()),
              "kmeans_assign: an assignment differs away from a near-tie")
        n_near += int(near.sum())
        n_differ += int(differ.sum())
        derr = (d - top2[:, 0]).abs()
        check(bool((derr <= tol).all()), "kmeans_assign: d2 off by more "
                                         "than 4 ulp of |p|^2 + |c|^2")
        err = max(err, float(derr.max()))
        del d2, top2, arg2
    print(f"kmeans_assign: {n_differ} assignments differ from the plain "
          f"version, all at near-ties; {n_near} points are near-ties "
          f"(best two d2 within 4 ulp)", flush=True)

    def plain():
        for lo in range(0, N, KMEANS_CHUNK):
            ka.kmeans_assign_ref(points[lo:lo + KMEANS_CHUNK], cents)

    b = bound(N * (4 * D + 8) + K * D * 4, N * K * (2 * D + 3))
    out = row("kmeans_assign", None, err,
              time_ms(lambda: ka.assign(points, cents)),
              time_ms(plain, reps=2), b, None, f"N={N} D={D} K={K}")
    torch.cuda.empty_cache()
    return out


def lloyd_f64(points, init, max_iters):
    """Float64 Lloyd iteration shaped like the engine's: assign from
    ``init``, then up to ``max_iters`` rounds of centroids -> assignment,
    stopping after a round where no point switched.  Returns (centroids,
    rounds)."""
    import torch
    N = points.shape[0]
    K = init.shape[0]
    assign = torch.empty(N, dtype=torch.int64, device=points.device)

    def step(cents):
        """New assignment in place; returns (switched, sums, counts)."""
        m2 = -2.0 * cents.T
        c2 = (cents ** 2).sum(-1)
        sums = torch.zeros_like(cents)
        counts = torch.zeros(K, dtype=torch.float64, device=cents.device)
        switched = torch.zeros((), dtype=torch.int64, device=cents.device)
        for lo in range(0, N, KMEANS_CHUNK):
            p = points[lo:lo + KMEANS_CHUNK].double()
            a = torch.addmm(c2[None, :], p, m2).argmin(1)
            switched += (a != assign[lo:lo + KMEANS_CHUNK]).sum()
            assign[lo:lo + KMEANS_CHUNK] = a
            for j in range(p.shape[1]):
                sums[:, j] += torch.bincount(a, weights=p[:, j], minlength=K)
            counts += torch.bincount(a, minlength=K).double()
        return int(switched), sums, counts

    assign.fill_(-1)
    _, sums, counts = step(init.double())
    rounds = 0
    while rounds < max_iters:
        switched, sums, counts = step(sums / counts.clamp(min=1)[:, None])
        rounds += 1
        if switched == 0:
            break
    return sums / counts.clamp(min=1)[:, None], rounds


class Phases:
    """Runs phases with launch counts reset, checks their kernels, and
    keeps each phase's launches for the kernel rows."""

    def __init__(self, counters):
        self.counters = counters
        self.launches = []   # (combiner or LM phase, {kernel: launches})

    def run(self, name, combiner, needs, fn, warm_up=True):
        import torch
        if warm_up:
            fn()
            sync()
        torch.cuda.reset_peak_memory_stats()
        for mod in self.counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        counts = {k: mod.launches for k, mod in self.counters.items()}
        self.launches.append((combiner, counts))
        for k in needs:
            check(counts[k] > 0, f"{name}: kernel {k} was never launched")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, wall, counts, peak

    def of(self, kernel, combiner) -> int:
        """Launches of ``kernel`` over the phases of ``combiner`` (every
        phase when the kernel has none)."""
        return sum(c[kernel] for comb, c in self.launches
                   if combiner is None or comb == combiner)


def stats_line(st) -> str:
    it = int(st.iterations)
    return (f"iterations {it} tiers "
            f"{dict(collections.Counter(st.tiers[:it].tolist()))} routes "
            f"{dict(collections.Counter(st.routes[:it].tolist()))}")


def make_graph(n, shards, seed, dev):
    """The DBPedia-shaped graph of ``n`` vertices (average degree 14.5,
    Zipf exponent 2.1) in ``shards`` shards: (indptr, indices, graph,
    snap)."""
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
    indptr, indices = make_powerlaw_graph(n, 14.5, 2.1, seed=seed)
    graph = shard_csr(indptr, indices, shards, device=dev)
    return indptr, indices, graph, PartitionSnapshot(n_keys=n,
                                                     num_shards=shards)


def capacities(snap) -> dict:
    """The engine's capacities: a ladder of 4 rungs, edge capacity 4n,
    source capacity one block."""
    return dict(edge_capacity=4 * snap.n_keys, src_capacity=snap.block_size,
                ladder_tiers=4)


def graph_phase(name, graph, snap, dev):
    """Phase ``name`` of GRAPH_PHASES at RUN_SETTINGS: (combiner, kernels
    its path must launch, a function that runs it)."""
    import importlib
    algo, mode, route, combiner, needs = GRAPH_PHASES[name]
    mod = importlib.import_module(f"repro_torch.algorithms.{algo}")
    kw = dict(RUN_SETTINGS[algo], device=dev, **capacities(snap))
    return combiner, needs, lambda: mod.run(graph, snap, mode=mode,
                                            route_strategy=route, **kw)


def graph_section(args, dev, phases, rows):
    """PageRank, SSSP and CC on the DBPedia-shaped graph."""
    import torch
    from repro_torch.algorithms import connected_components as cc
    from repro_torch.algorithms import pagerank, sssp
    from repro_torch.core.engine import ShardedExecutor

    n, S = args.n, args.shards
    t0 = time.perf_counter()
    indptr, indices, graph, snap = make_graph(n, S, args.seed, dev)
    per_shard = graph.out_degree.sum(1).tolist()
    print(f"graph: n={n} edges={len(indices)} shards={S} block="
          f"{snap.block_size} edges/shard {min(per_shard)}..{max(per_shard)}"
          f" max out-degree {int(graph.out_degree.max())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cap = capacities(snap)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")

    # PageRank.
    algo = pagerank.make_algorithm(
        snap, RUN_SETTINGS["pagerank"]["threshold"], cap["src_capacity"],
        cap["edge_capacity"])
    print("rungs: " + " ".join(
        f"({t.src} src, {t.edge} edge, {t.seg} seg -> "
        f"{ex.pick_route_strategy(t.edge, 'add')})"
        for t in ex.capacity_tiers(algo)))
    rows += pagerank_kernel_checks(graph, snap, ex, algo)
    ref = pagerank.reference_pagerank(indptr, indices, n, iters=300,
                                      device=dev)
    values = {}
    for name in ("delta_auto", "delta_sort", "nodelta"):
        (pr, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        check(pr.shape == (snap.padded_keys,), f"{name}: pr shape {pr.shape}")
        check(bool(torch.isfinite(pr).all()), f"{name}: non-finite pr")
        rel = float(((pr[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB rel_err_vs_f64 "
              f"{rel:.3e}", flush=True)
        check(rel < PHASE_BOUND, f"{name}: rel_err_vs_f64 {rel:.3e} over "
                                 f"{PHASE_BOUND}")
        values[name] = pr
        del res
        torch.cuda.empty_cache()
    sort_vs_auto = float((values["delta_sort"] - values["delta_auto"])
                         .abs().max())
    print(f"max|delta_sort - delta_auto| {sort_vs_auto:.3e} (bound "
          f"{PHASE_BOUND})", flush=True)
    check(sort_vs_auto < PHASE_BOUND, "delta_sort and delta_auto disagree")
    del values

    # Delta against nodelta, and both against the oracle, at 1e-5.
    tight = dict(RUN_SETTINGS["pagerank"], threshold=1e-5, max_iters=120,
                 device=dev, **cap)
    pr_d, res_d = pagerank.run(graph, snap, mode="delta",
                               route_strategy="auto", **tight)
    pr_n, res_n = pagerank.run(graph, snap, mode="nodelta", **tight)
    agree = float((pr_d - pr_n).abs().max())
    rel_d = float(((pr_d[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
    rel_n = float(((pr_n[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
    print(f"accuracy at threshold 1e-5: delta {int(res_d.stats.iterations)} "
          f"strata, nodelta {int(res_n.stats.iterations)}; max|delta - "
          f"nodelta| {agree:.3e}; rel_err_vs_f64 delta {rel_d:.3e} nodelta "
          f"{rel_n:.3e} (bound {ACCURACY_BOUND})", flush=True)
    check(agree < ACCURACY_BOUND, "delta and nodelta disagree")
    check(max(rel_d, rel_n) < ACCURACY_BOUND, "values off the oracle")
    del pr_d, res_d, pr_n, res_n, ref
    torch.cuda.empty_cache()

    # SSSP from vertex 0, exactly equal to a BFS on the card.
    t0 = time.perf_counter()
    bfs = sssp.reference_sssp(indptr, indices, n,
                              RUN_SETTINGS["sssp"]["source"], device=dev)
    sync()
    print(f"sssp oracle: BFS reaches {int(torch.isfinite(bfs).sum())} of {n}"
          f" vertices, depth {int(bfs[torch.isfinite(bfs)].max())} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    auto_stats = None
    for name in ("sssp_auto", "sssp_sort", "sssp_nodelta"):
        (dist, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        exact = bool(torch.equal(dist[:n], bfs)) and bool(
            torch.isinf(dist[n:]).all())
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB equal_to_bfs "
              f"{exact}", flush=True)
        check(exact, f"{name}: distances differ from the BFS oracle")
        if name == "sssp_auto":
            auto_stats = res.stats
        del dist, res
        torch.cuda.empty_cache()
    algo = sssp.make_algorithm(snap, cap["src_capacity"],
                               cap["edge_capacity"])
    rows += sssp_kernel_checks(graph, snap, ex, algo, auto_stats)
    del bfs

    # Connected components, exactly equal to a dense min-label iteration.
    t0 = time.perf_counter()
    labels = cc.reference_components(indptr, indices, n, device=dev)
    sync()
    print(f"cc oracle: {int(torch.unique(labels).numel())} distinct labels "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    for name in ("cc_auto", "cc_nodelta"):
        (lab, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        exact = bool(torch.equal(lab[:n], labels))
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB "
              f"equal_to_oracle {exact}", flush=True)
        check(exact, f"{name}: labels differ from the oracle")
        del lab, res
        torch.cuda.empty_cache()


def make_points(n, dev):
    """``n`` geo points in KMEANS_K clouds and KMEANS_K initial centroids
    (``bench_kmeans.py``'s data): (points, init)."""
    from repro_torch.data.points import (make_geo_points,
                                         sample_initial_centroids)
    points = make_geo_points(n, n_true_clusters=KMEANS_K, seed=0,
                             device=dev)
    return points, sample_initial_centroids(points, KMEANS_K, seed=1)


def kmeans_phase(mode, sharded, init, dev):
    """A function that runs k-means in ``mode`` for up to KMEANS_STRATA
    strata."""
    from repro_torch.algorithms import kmeans
    return lambda: kmeans.run(sharded, init, mode=mode,
                              max_iters=KMEANS_STRATA, device=dev)


def kmeans_section(args, dev, phases, rows):
    """k-means at the paper's largest point set."""
    import torch
    from repro_torch.algorithms import kmeans
    from repro_torch.kernels import kmeans_assign as ka

    S, k, n = args.shards, KMEANS_K, args.points
    check(n % S == 0, f"--points {n} is not a multiple of {S} shards")
    t0 = time.perf_counter()
    points, init = make_points(n, dev)
    sync()
    print(f"points: n={n} ({n // S} a shard, {S} shards) k={k} "
          f"({time.perf_counter() - t0:.1f} s to make on the host and move)"
          f"; kmeans_assign runs its "
          f"{'constant-table' if ka.uses_table(k, 2) else 'shared-memory'}"
          f" kernel", flush=True)
    sharded = points.view(S, n // S, 2)
    # Warm-up at a small size (cuBLAS, allocator, kernel load).
    kmeans.run(sharded[:, :1 << 20].contiguous(), init, max_iters=3,
               device=dev)
    sync()
    rows.append(kmeans_kernel_check(points, init))

    t0 = time.perf_counter()
    ref, rounds = lloyd_f64(points, init, KMEANS_STRATA)
    sync()
    print(f"kmeans oracle: float64 Lloyd, {rounds} rounds "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cents = {}
    for name, mode in [("kmeans_delta", "delta"),
                       ("kmeans_nodelta", "nodelta")]:
        (c, res), wall, counts, peak = phases.run(
            name, None, ("kmeans_assign",),
            kmeans_phase(mode, sharded, init, dev), warm_up=False)
        it = int(res.stats.iterations)
        check(c.shape == (k, 2) and bool(torch.isfinite(c).all()),
              f"{name}: centroids {tuple(c.shape)} not finite")
        check(counts["kmeans_assign"] == it + 1,
              f"{name}: {counts['kmeans_assign']} kmeans_assign launches "
              f"for {it} strata")
        err = float((c.double() - ref).abs().max())
        sw = res.stats.delta_counts[:it].tolist()
        print(f"phase {name}: iterations {it} switched first {sw[:3]} last "
              f"{sw[-3:]} wall {wall:.3f} s launches {counts} peak_mem "
              f"{peak:.2f} GiB max|c - c_f64| {err:.3e} (bound "
              f"{KMEANS_BOUND})", flush=True)
        check(err < KMEANS_BOUND, f"{name}: centroids off the float64 "
                                  f"oracle by {err:.3e}")
        cents[name] = c
        del res
        torch.cuda.empty_cache()
    agree = float((cents["kmeans_delta"] - cents["kmeans_nodelta"])
                  .abs().max())
    print(f"max|kmeans_delta - kmeans_nodelta| {agree:.3e} (bound "
          f"{KMEANS_BOUND})", flush=True)
    check(agree < KMEANS_BOUND, "kmeans delta and nodelta disagree")


def flash_row(label, phase, q, k, v, causal):
    """flash_attention at q [B, H, T, D], k/v [B, H_kv, S, D] against its
    plain version, timed beside it and beside the library's
    ``scaled_dot_product_attention`` in float32.  The row reports the
    launches of the LM phase ``phase`` runs at this shape (OFF_PATH: a
    check at a shape the path does not run, 0 launches)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    got = fa.attention(q, k, v, causal=causal)
    ref = fa.attention_ref(q, k, v, causal=causal)
    diff = (got - ref).abs()
    err = float(diff.max())
    ok = bool((diff <= FLASH_TOL + FLASH_TOL * ref.abs()).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"flash_attention/{label}: off its plain version by up to "
          f"{err:.3e} (tolerance {FLASH_TOL} abs + rel)")
    del got, ref, diff
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    # Score pairs the function needs: s <= t when causal (T == S).
    pairs = t * (t + 1) // 2 if causal else t * s
    bnd = bound(2 * nbytes(q) + nbytes(k, v), 4 * d * b * h * pairs)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=h != h_kv)
    return row("flash_attention", phase, err,
               time_ms(lambda: fa.attention(q, k, v, causal=causal)),
               time_ms(lambda: fa.attention_ref(q, k, v, causal=causal),
                       reps=2), bnd, time_ms(lib),
               f"B={b} H={h} H_kv={h_kv} T={t} S={s} D={d} "
               f"{'causal' if causal else 'non-causal'}"
               f"{' (off the path)' if phase == OFF_PATH else ''}",
               label=f"flash_attention/{label}")


def random_qkv(shape, generator):
    """Standard normal float32 q [B, H, T, D], k and v [B, H_kv, S, D] on
    ``generator``'s device."""
    import torch
    b, h, h_kv, t, s, d = shape
    dev = generator.device
    return (torch.randn(b, h, t, d, generator=generator, device=dev),
            torch.randn(b, h_kv, s, d, generator=generator, device=dev),
            torch.randn(b, h_kv, s, d, generator=generator, device=dev))


def layer0_qkv(cfg, params, tokens):
    """Layer 0's attention inputs on ``tokens``, as the forward gives them
    to the kernel: float32, contiguous, q and k rotated."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_norm
    layer = params.layers[0]
    x = apply_norm(cfg.norm_kind, layer.ln1, params.embed[tokens.long()])
    b, t = tokens.shape
    pos = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    return [a.float().contiguous()
            for a in attn.gqa_qkv(cfg, layer.attn, x, pos)]


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|: the error against the logits'
    scale."""
    return float((got - ref).abs().max() / ref.abs().max())


def teacher_forced(cfg, params, tokens, start, steps):
    """Prefill ``tokens[:, :start]`` into a cache of ``start + steps``
    slots, then decode ``tokens[:, start + i]`` at position ``start + i``;
    returns the decode logits f32[B, steps, V]."""
    import torch
    from repro_torch.models import transformer
    _, cache = transformer.prefill_forward(cfg, params,
                                           tokens[:, :start].contiguous(),
                                           start + steps)
    out = []
    for i in range(steps):
        logits, cache = transformer.decode_step(
            cfg, params, tokens[:, start + i:start + i + 1], cache,
            torch.tensor(start + i, dtype=torch.int32, device=tokens.device))
        out.append(logits)
    return torch.cat(out, dim=1)


def lm_section(args, dev, phases, rows, cfg=None, shapes=LM_SHAPES):
    """The dense LM serving path at Llama-3-8B's full width and depth
    (``cfg`` and ``shapes`` shrink it for a rehearsal on the CPU)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(LM_ARCH)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    print(f"lm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)

    # lm_forward: the full-sequence forward through the kernel.
    B, T = sh["fwd_batch"], sh["fwd_seq"]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                           device=dev).batch_at(0)["tokens"]
    (logits, _), wall, counts, peak = phases.run(
        "lm_forward", "lm_forward", ("flash_attention",),
        lambda: transformer.forward(cfg, params, tokens))
    check(counts["flash_attention"] == cfg.n_layers,
          f"lm_forward: {counts['flash_attention']} flash_attention "
          f"launches for {cfg.n_layers} layers")
    check(logits.shape == (B, T, cfg.vocab) and logits.dtype ==
          torch.float32 and bool(torch.isfinite(logits).all()),
          f"lm_forward: logits {logits.dtype}{tuple(logits.shape)} not "
          f"finite")
    plain, _ = transformer.forward(cfg, params, tokens, use_kernel=False)
    err = rel_err(logits, plain)
    same = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain, logits
    print(f"phase lm_forward: [{B}x{T}] wall {wall:.3f} s "
          f"{B * T / wall:.0f} tok/s launches {counts} peak_mem "
          f"{peak:.2f} GiB max|kernel - plain| / max|logit| {err:.3e} "
          f"(bound {LM_BF16_BOUND}), argmax agreement {same:.5f}",
          flush=True)
    check(err <= LM_BF16_BOUND, f"lm_forward: kernel path off the plain "
                                f"path by {err:.3e} of the logits' scale")
    rows.append(flash_row("forward", "lm_forward",
                          *layer0_qkv(cfg, params, tokens), True))
    torch.cuda.empty_cache()

    # Full width, 4 layers, float32: the kernel path against the plain
    # path, and teacher-forced decode against that forward.
    cfg32 = dataclasses.replace(cfg, n_layers=sh["tight_layers"],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    f32, _ = transformer.forward(cfg32, p32, tokens)
    plain32, _ = transformer.forward(cfg32, p32, tokens, use_kernel=False)
    err32 = rel_err(f32, plain32)
    del plain32
    n = sh["decode_steps"]
    dec32 = teacher_forced(cfg32, p32, tokens, T - n, n)
    err_dec32 = rel_err(dec32, f32[:, T - n:])
    del p32, f32, dec32
    print(f"lm float32 at {cfg32.n_layers} layers, full width: "
          f"max|kernel - plain| / max|logit| {err32:.3e}, teacher-forced "
          f"decode ({n} steps) vs forward {err_dec32:.3e} (bound "
          f"{LM_TIGHT_BOUND})", flush=True)
    check(err32 <= LM_TIGHT_BOUND, "lm float32: kernel path off the plain "
                                   "path")
    check(err_dec32 <= LM_TIGHT_BOUND, "lm float32: decode off the forward")
    del tokens
    torch.cuda.empty_cache()

    # lm_serve: launch/serve.py's prefill + greedy decode.
    B, P, new = sh["serve_batch"], sh["prompt"], sh["new"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 1,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    res, wall, counts, peak = phases.run(
        "lm_serve", "lm_serve", ("flash_attention",),
        lambda: serve(cfg, params, prompt, new))
    check(counts["flash_attention"] == cfg.n_layers,
          f"lm_serve: {counts['flash_attention']} flash_attention launches "
          f"for a prefill of {cfg.n_layers} layers")
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"lm_serve: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(res.prefill_logits, last)
    plain, _ = transformer.prefill_forward(cfg, params, prompt, P + new,
                                           use_kernel=False)
    err_prefill_plain = rel_err(res.prefill_logits, plain)
    del plain
    full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(teacher_forced(cfg, params, ext, P, n), tail)
    del tail, last
    print(f"phase lm_serve: [{B}x{P} + {new}] wall {wall:.3f} s prefill "
          f"{res.prefill_s:.3f} s ({B * P / res.prefill_s:.0f} tok/s) "
          f"decode {res.decode_steps} steps {res.decode_s:.3f} s "
          f"({B * res.decode_steps / res.decode_s:.1f} tok/s) launches "
          f"{counts} peak_mem {peak:.2f} GiB; prefill last logits vs "
          f"forward {err_prefill:.3e} (bound {LM_PREFILL_BOUND:.3e}), vs "
          f"the plain prefill {err_prefill_plain:.3e} (bound "
          f"{LM_BF16_BOUND}), "
          f"teacher-forced decode ({n} steps) vs forward {err_dec:.3e} "
          f"(bound {LM_DECODE_BOUND}); sample {toks[0, :8].tolist()}",
          flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, "lm_serve: prefill logits off "
                                           "the forward")
    check(err_prefill_plain <= LM_BF16_BOUND, "lm_serve: prefill off the "
                                              "plain prefill")
    check(err_dec <= LM_DECODE_BOUND, "lm_serve: decode off the forward")
    rows.append(flash_row("prefill", "lm_serve",
                          *layer0_qkv(cfg, params, prompt), True))
    del params, res, ext, prompt
    torch.cuda.empty_cache()

    # The kernel at a ragged causal shape and a non-causal one.
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for label, (shape, causal) in FLASH_OFF_PATH.items():
        rows.append(flash_row(label, OFF_PATH, *random_qkv(shape, g),
                              causal))
    torch.cuda.empty_cache()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3_300_000,
                    help="vertices (default: the paper's DBPedia 3.3 M)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=382_000_000,
                    help="k-means points (default: the paper's 382 M)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_route import ops as dr_ops
    from repro_torch.kernels.delta_scatter import ops as ds_ops
    from repro_torch.kernels.edge_propagate import ops as ep_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.kernels.scatter_route import ops as sr_ops

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)

    dev = torch.device("cuda")
    phases = Phases({"scatter_route": sr_ops, "delta_route": dr_ops,
                     "delta_scatter": ds_ops, "edge_propagate": ep_ops,
                     "kmeans_assign": ka_ops,
                     "flash_attention": fa_ops})
    rows: list = []
    graph_section(args, dev, phases, rows)
    torch.cuda.empty_cache()
    kmeans_section(args, dev, phases, rows)
    torch.cuda.empty_cache()
    lm_section(args, dev, phases, rows)
    print_rows(rows)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [dict(
        name=row_name(r), route="cuda", source=KERNELS[r["name"]][0],
        replaces=KERNELS[r["name"]][1],
        launches=phases.of(r["name"], r["combiner"]),
        max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"]) for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
