"""Delta-based PageRank (paper §1 Ex.1, §3.5, Listing 1, Figs 2/6/8).

Fixpoint: ``pr(v) = 0.15 + 0.85 * Σ_{u→v} sent(u) / outdeg(u)``.

Every vertex tracks the value it last *propagated* (``sent``) and its
accumulated incoming mass (``acc``).  A vertex is in the Δᵢ set when its
current value ``pr = 0.15 + 0.85·acc`` differs from ``sent`` by more than
the threshold; it then emits ``(pr − sent)/outdeg`` along each out-edge and
records ``sent ← pr``.  Receivers fold the adjustment deltas into ``acc``.
The no-delta mode re-derives every vertex's full contribution each stratum
(contributions are *replaced*, not adjusted).

With ``use_kernels`` the sparse apply goes through ``kernels/delta_scatter``,
which takes the incoming buffer's global keys and the shard's first key,
and the dense body through ``kernels/edge_propagate`` (over a ragged CSC
built once per shard and graph); otherwise the torch-op functions of ``emission.py``
run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.algorithms import emission
from repro_torch.core.delta import DeltaBuffer, _i32
from repro_torch.core.engine import DeltaAlgorithm, ShardedExecutor
from repro_torch.core.fixpoint import FixpointResult
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_propagate import CSCCache, edge_propagate

DAMPING = 0.85
BASE = 0.15


class PRState(NamedTuple):
    acc: torch.Tensor    # f32[block] accumulated incoming mass Σ sent(u)/deg(u)
    sent: torch.Tensor   # f32[block] value last propagated to neighbors


_DAMPING32 = float(np.float32(DAMPING))
_BASE32 = float(np.float32(BASE))


def current_pr(state: PRState) -> torch.Tensor:
    """``BASE + DAMPING * acc`` rounded once, as a fused multiply-add: the
    reference's compiled stratum contracts it into one, so rounding the
    product separately would drift from it by an ulp.  The float32
    product is exact in float64."""
    return (state.acc.double() * _DAMPING32 + _BASE32).to(state.acc.dtype)


def make_algorithm(snapshot: PartitionSnapshot, threshold: float = 1e-3,
                   src_capacity: int = 1024, edge_capacity: int = 16384,
                   use_kernels: bool = True) -> DeltaAlgorithm:
    block = snapshot.block_size
    n_padded = snapshot.padded_keys
    csc = CSCCache(n_padded)   # ragged CSC per shard, kept per graph

    def n_active(state: PRState) -> torch.Tensor:
        diff = torch.abs(current_pr(state) - state.sent)
        return _i32((diff > threshold).sum())

    def active_fn(state: PRState, graph: CSRGraph):
        active = torch.abs(current_pr(state) - state.sent) > threshold
        est_edges = _i32(torch.where(active, graph.out_degree, 0).sum())
        return active, est_edges

    def make_sparse_emit(src_cap: int, edge_cap: int):
        def sparse_emit(state: PRState, graph: CSRGraph, active, stratum,
                        shard_id):
            pr = current_pr(state)
            deg = torch.clamp(graph.out_degree, min=1).to(pr.dtype)
            payload = torch.where(active, (pr - state.sent) / deg, 0.0)
            out = emission.emit_over_edges(graph, active, payload, src_cap,
                                           edge_cap)
            # sent <- pr for the sources whose diff we just shipped.
            new_sent = torch.where(active, pr, state.sent)
            return PRState(acc=state.acc, sent=new_sent), out
        return sparse_emit

    def dense_emit(state: PRState, graph: CSRGraph, stratum, shard_id):
        pr = current_pr(state)
        deg = torch.clamp(graph.out_degree, min=1).to(pr.dtype)
        if use_kernels:
            contrib = edge_propagate(pr / deg, csc.get(shard_id, graph))
        else:
            dst, payload = emission.dense_push(graph, pr / deg)
            contrib = emission.fold(pr.new_zeros((n_padded, 1)), dst,
                                    payload[:, None])[:, 0]
        # Dense strata REPLACE acc, so sent must reflect the full pr pushed.
        return PRState(acc=state.acc, sent=pr), contrib[:, None]

    def apply_sparse(state: PRState, incoming: DeltaBuffer, graph: CSRGraph,
                     stratum, shard_id):
        # Fold into a zero block first, then acc + inc: the reference's
        # order of operations, so sums round the same way.
        if use_kernels:
            from repro_torch.kernels.delta_scatter import delta_scatter
            zero = torch.zeros((block, 1), dtype=state.acc.dtype,
                               device=state.acc.device)
            inc = delta_scatter(zero, incoming.keys.contiguous(),
                                incoming.payload.contiguous(),
                                key_base=shard_id * block)[:, 0]
        else:
            inc = emission.scatter_local(incoming, shard_id, block, "add")
        new_state = PRState(acc=state.acc + inc, sent=state.sent)
        return new_state, n_active(new_state)

    def apply_dense(state: PRState, incoming: torch.Tensor, graph: CSRGraph,
                    stratum, shard_id):
        new_state = PRState(acc=incoming[:, 0], sent=state.sent)
        return new_state, n_active(new_state)

    return DeltaAlgorithm(
        active_fn=active_fn,
        sparse_emit=make_sparse_emit(src_capacity, edge_capacity),
        dense_emit=dense_emit, apply_sparse=apply_sparse,
        apply_dense=apply_dense, combiner="add", payload_width=1,
        bytes_per_delta=8, emit_factory=make_sparse_emit)


def initial_state(snapshot: PartitionSnapshot, device=None) -> PRState:
    """Δ₀ = every vertex (sent=0, so pr₀ = 0.15 must propagate)."""
    z = torch.zeros((snapshot.num_shards, snapshot.block_size),
                    dtype=torch.float32, device=resolve_device(device))
    return PRState(acc=z, sent=z)


def run(graph_sharded: CSRGraph, snapshot: PartitionSnapshot,
        mode: str = "delta", threshold: float = 1e-3, max_iters: int = 60,
        executor: Optional[ShardedExecutor] = None,
        src_capacity: int = 1024, edge_capacity: int = 16384,
        ladder_tiers: int = 1, route_strategy: str = "sort",
        device=None, use_kernels: bool = True
        ) -> tuple[torch.Tensor, FixpointResult]:
    """Run PageRank on ``device`` (None = CUDA; raises without it);
    returns (pr values [padded_keys], FixpointResult)."""
    dev = resolve_device(device)
    graph = graph_sharded.to(dev)
    algo = make_algorithm(snapshot, threshold, src_capacity, edge_capacity,
                          use_kernels=use_kernels)
    if executor is None:
        executor = ShardedExecutor(
            snapshot=snapshot, seg_capacity=edge_capacity,
            edge_capacity=edge_capacity, src_capacity=src_capacity,
            ladder_tiers=ladder_tiers, route_strategy=route_strategy,
            use_kernels=use_kernels)
    res = executor.run(algo, initial_state(snapshot, dev),
                       snapshot.padded_keys, graph, max_iters, mode=mode)
    # The returned values round the product and the sum apart, as the
    # reference does outside its compiled loop.
    return (BASE + DAMPING * res.state.acc).reshape(-1), res


def reference_pagerank(indptr: np.ndarray, indices: np.ndarray, n: int,
                       iters: int = 100, device=None) -> torch.Tensor:
    """Dense float64 power iteration: pr = 0.15 + 0.85 Σ pr(u)/deg(u).
    Returns float32[n] on ``device``."""
    dev = resolve_device(device)
    counts = np.diff(indptr)
    deg = torch.from_numpy(np.maximum(counts, 1).astype(np.float64)).to(dev)
    src = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.from_numpy(counts).to(dev))
    dst = torch.from_numpy(np.asarray(indices[:len(src)],
                                      np.int64)).to(dev)
    pr = torch.full((n,), BASE, dtype=torch.float64, device=dev)
    for _ in range(iters):
        contrib = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, dst, pr[src] / deg[src])
        pr = BASE + DAMPING * contrib
    return pr.to(torch.float32)
