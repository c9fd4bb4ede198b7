#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--n 3300000] [--shards 8] [--seed 0]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a, into ``build/kernels/``), then, at the paper's DBPedia scale
(§6 "Data": 3.3 M vertices, average degree 14.5; Zipf exponent 2.1) with
the PageRank benchmark's settings (8 shards, capacity ladder of 4 rungs,
threshold 1e-3, at most 60 strata, edge capacity 4n, source capacity one
block):

1. holds each kernel against its plain torch version on the card, at the
   inputs the main path gives it in the first stratum (the first dense
   stratum for edge_propagate): integer outputs exactly, floats within
   1e-5 relative (atomics reorder float adds), and times the kernel, the
   plain version and, where one torch call computes the same function,
   that call;
2. drives delta-mode PageRank through ``repro_torch.algorithms.pagerank.run``
   in three phases: ``delta_auto`` (route_strategy "auto": scatter_route +
   delta_scatter), ``delta_sort`` (delta_route + delta_scatter) and
   ``nodelta`` (edge_propagate); each phase runs once to warm up, then once
   with every kernel's launch count set to 0, and fails if a kernel of the
   phase was not launched;
3. checks every phase's values against a float64 power iteration on the
   card (bound 1e-2 at threshold 1e-3), delta_sort against delta_auto
   (same bound), and delta against nodelta at threshold 1e-5 (bound 5e-3).

Prints the card, the kernels as one JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failed check,
and without a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
FLOAT_RTOL = 1e-5
ACCURACY_BOUND = 5e-3       # delta vs nodelta / vs oracle at threshold 1e-5
PHASE_BOUND = 1e-2          # ten times the phases' threshold of 1e-3


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


def time_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(name: str, got, ref, float_idx=()) -> float:
    """Integer outputs exactly, float outputs within FLOAT_RTOL relative;
    returns the max absolute difference over the float outputs."""
    import torch
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: output {i} is {g.dtype}{tuple(g.shape)}, plain "
              f"version {r.dtype}{tuple(r.shape)}")
        if i in float_idx:
            diff = (g - r).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            ok = bool(torch.all(diff <= FLOAT_RTOL * r.abs() + 1e-30))
            check(ok, f"{name}: float output {i} off by up to {err:.3e} "
                      f"(rtol {FLOAT_RTOL})")
        else:
            check(torch.equal(g, r), f"{name}: integer output {i} differs")
    return err


def kernel_checks(graph, snap, ex, algo):
    """Each kernel against its plain version at the first stratum's
    inputs; returns the kernels' JSON rows (launches filled in later)."""
    import torch
    from repro_torch.algorithms import emission, pagerank
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take
    from repro_torch.core.handlers import pre_aggregate
    from repro_torch.kernels import delta_route as dr
    from repro_torch.kernels import delta_scatter as ds
    from repro_torch.kernels import edge_propagate as ep
    from repro_torch.kernels import scatter_route as sr

    S, B, n_pad = snap.num_shards, snap.block_size, snap.padded_keys
    top = ex.capacity_tiers(algo)[-1]
    state = pagerank.initial_state(snap, graph.device)
    parts = []
    for s in range(S):
        st, g = _take(state, s), _take(graph, s)
        active, _ = algo.active_fn(st, g)
        parts.append(algo.sparse_emit(st, g, active, 0, s)[1])
    out0 = parts[0]
    rows = []

    # scatter_route: shard 0's outgoing deltas, top rung.
    keys = out0.keys
    owners = torch.where(keys != PAD_KEY, snap.owner_of(keys), S)
    local = snap.local_index(keys)
    args = (keys, out0.payload, local, owners, S, B, top.seg)
    got = sr.scatter_route(*args)
    ref = sr.scatter_route_ref(*args)
    err = compare("scatter_route", got, ref, float_idx=(1,))
    # Every key is read; local, owner and payload only for live keys.
    live = int((keys != PAD_KEY).sum())
    W = out0.payload.shape[1]
    b, by = bound(keys.numel() * 4 + live * (8 + 4 * W) + nbytes(*got),
                  live)
    rows.append(dict(
        name="scatter_route", err=err, ms=time_ms(lambda: sr.scatter_route(
            *args)), plain_ms=time_ms(lambda: sr.scatter_route_ref(*args)),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"C={keys.numel()} live={live} S={S} B={B} cap={top.seg}"))
    del got, ref, args

    # delta_route: shard 0's pre-aggregated deltas (sort strategy).
    agg = pre_aggregate(out0, "add")
    owners = torch.where(agg.keys != PAD_KEY, snap.owner_of(agg.keys), S)
    args = (agg.keys, agg.payload, agg.ann, owners, S, top.seg)
    got = dr.delta_route(*args)
    ref = dr.delta_route_ref(*args)
    err = compare("delta_route", got, ref, float_idx=())
    # Every key is read; owner, payload and ann only for live keys.
    live = int((agg.keys != PAD_KEY).sum())
    b, by = bound(agg.keys.numel() * 4 + live * (5 + 4 * W) + nbytes(*got),
                  0)
    rows.append(dict(
        name="delta_route", err=err, ms=time_ms(lambda: dr.delta_route(
            *args)), plain_ms=time_ms(lambda: dr.delta_route_ref(*args)),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"C={agg.keys.numel()} live={live} S={S} cap={top.seg}"))
    del got, ref, args, agg

    # delta_scatter: shard 0's incoming deltas after the segment swap.
    incoming, _ = ex.rehash_sparse_simulated(_stack(parts), top.seg, "add",
                                             "scatter")
    del parts, out0
    in0 = _take(incoming, 0)
    idx = emission.to_local_keys(in0, 0, B).contiguous()
    pay = in0.payload.contiguous()
    del incoming, in0
    zero = torch.zeros((B, 1), device=graph.device)
    got = ds.delta_scatter(zero, idx, pay)
    ref = ds.delta_scatter_ref(zero, idx, pay)
    err = compare("delta_scatter", [got], [ref], float_idx=(0,))
    # Every index is read; the payload only where it is in range; the
    # state is read and written once.
    live = int(((idx >= 0) & (idx < B)).sum())
    b, by = bound(nbytes(idx) + live * 4 * W + 2 * nbytes(zero), live * W)
    lib_idx = torch.where((idx >= 0) & (idx < B), idx, B)
    lib_ms = time_ms(lambda: torch.zeros((B + 1, 1), device=zero.device)
                     .index_add_(0, lib_idx, pay))
    rows.append(dict(
        name="delta_scatter", err=err,
        ms=time_ms(lambda: ds.delta_scatter(zero, idx, pay)),
        plain_ms=time_ms(lambda: ds.delta_scatter_ref(zero, idx, pay)),
        bound_ms=b, bound_by=by, library_ms=lib_ms,
        shape=f"N={B} C={idx.numel()} live={live}"))
    del got, ref, idx, pay, lib_idx

    # edge_propagate: shard 0's dense stratum from the initial state.
    g0, st0 = _take(graph, 0), _take(state, 0)
    pr = pagerank.current_pr(st0)
    payload = pr / torch.clamp(g0.out_degree, min=1).to(pr.dtype)
    csc = ep.build_csc(g0, n_pad)
    got = ep.edge_propagate(payload, csc)
    ref = ep.edge_propagate_ref(payload, *csc)
    err = compare("edge_propagate", [got], [ref], float_idx=(0,))
    n_edges = csc.src.numel()
    b, by = bound(nbytes(payload, *csc, got), 2 * n_edges)
    dst = torch.repeat_interleave(
        torch.arange(n_pad, device=payload.device),
        (csc.indptr[1:] - csc.indptr[:-1]).long(), output_size=n_edges)
    lib_ms = time_ms(lambda: torch.zeros(n_pad, device=payload.device)
                     .index_add_(0, dst, payload[csc.src] * csc.weight))
    rows.append(dict(
        name="edge_propagate", err=err,
        ms=time_ms(lambda: ep.edge_propagate(payload, csc)),
        plain_ms=time_ms(lambda: ep.edge_propagate_ref(payload, *csc)),
        bound_ms=b, bound_by=by, library_ms=lib_ms,
        shape=f"n_dst={n_pad} E={n_edges} N_src={B}"))
    del got, ref, dst, csc
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3_300_000,
                    help="vertices (default: the paper's DBPedia 3.3 M)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.algorithms import pagerank
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_route import ops as dr_ops
    from repro_torch.kernels.delta_scatter import ops as ds_ops
    from repro_torch.kernels.edge_propagate import ops as ep_ops
    from repro_torch.kernels.scatter_route import ops as sr_ops

    counters = {"scatter_route": sr_ops, "delta_route": dr_ops,
                "delta_scatter": ds_ops, "edge_propagate": ep_ops}
    sources = {
        "scatter_route": ("src/repro_torch/kernels/csrc/scatter_route.cu",
                          "src/repro/kernels/scatter_route/"
                          "scatter_route.py:112"),
        "delta_route": ("src/repro_torch/kernels/csrc/delta_route.cu",
                        "src/repro/kernels/delta_route/delta_route.py:100"),
        "delta_scatter": ("src/repro_torch/kernels/csrc/delta_scatter.cu",
                          "src/repro/kernels/delta_scatter/"
                          "delta_scatter.py:73"),
        "edge_propagate": ("src/repro_torch/kernels/csrc/edge_propagate.cu",
                           "src/repro/kernels/edge_propagate/"
                           "edge_propagate.py:71"),
    }
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)

    dev = torch.device("cuda")
    n, S = args.n, args.shards
    t0 = time.perf_counter()
    indptr, indices = make_powerlaw_graph(n, 14.5, 2.1, seed=args.seed)
    graph = shard_csr(indptr, indices, S, device=dev)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    per_shard = graph.out_degree.sum(1).tolist()
    print(f"graph: n={n} edges={len(indices)} shards={S} block="
          f"{snap.block_size} edges/shard {min(per_shard)}..{max(per_shard)}"
          f" max out-degree {int(graph.out_degree.max())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cap = dict(edge_capacity=4 * n, src_capacity=snap.block_size,
               ladder_tiers=4)
    base = dict(threshold=1e-3, max_iters=60, device=dev, **cap)

    # 1. Kernels against their plain versions at the main path's inputs.
    algo = pagerank.make_algorithm(snap, 1e-3, cap["src_capacity"],
                                   cap["edge_capacity"])
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")
    print("rungs: " + " ".join(
        f"({t.src} src, {t.edge} edge, {t.seg} seg -> "
        f"{ex.pick_route_strategy(t.edge, 'add')})"
        for t in ex.capacity_tiers(algo)))
    rows = kernel_checks(graph, snap, ex, algo)
    for r in rows:
        print(f"kernel {r['name']}: {r['shape']} ok max_abs_err "
              f"{r['err']:.3e} kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) library {r['library_ms']}", flush=True)

    # 2. The main path, three phases.
    ref = pagerank.reference_pagerank(indptr, indices, n, iters=300,
                                      device=dev)
    phases = [("delta_auto", "delta", "auto",
               ("scatter_route", "delta_scatter")),
              ("delta_sort", "delta", "sort",
               ("delta_route", "delta_scatter")),
              ("nodelta", "nodelta", "sort", ("edge_propagate",))]
    launches = collections.Counter()
    values = {}
    for name, mode, route, needs in phases:
        kw = dict(mode=mode, route_strategy=route, **base)
        pagerank.run(graph, snap, **kw)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        pr, res = pagerank.run(graph, snap, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: mod.launches for k, mod in counters.items()}
        launches.update(counts)
        st = res.stats
        it = int(st.iterations)
        check(pr.shape == (snap.padded_keys,), f"{name}: pr shape {pr.shape}")
        check(bool(torch.isfinite(pr).all()), f"{name}: non-finite pr")
        rel = float(((pr[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
        print(f"phase {name}: iterations {it} wall {wall:.3f} s tiers "
              f"{dict(collections.Counter(st.tiers[:it].tolist()))} routes "
              f"{dict(collections.Counter(st.routes[:it].tolist()))} "
              f"launches {counts} peak_mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"rel_err_vs_f64 {rel:.3e}", flush=True)
        for k in needs:
            check(counts[k] > 0, f"{name}: kernel {k} was never launched")
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

    # 3. Delta against nodelta, and both against the oracle, at 1e-5.
    tight = dict(base, threshold=1e-5, max_iters=120)
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

    print(json.dumps({"kernels": [dict(
        name=r["name"], route="cuda", source=sources[r["name"]][0],
        replaces=sources[r["name"]][1], launches=launches[r["name"]],
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
