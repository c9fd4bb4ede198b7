"""Connected components by min-label propagation (delta form).

Not one of the paper's three benchmark algorithms, but the canonical extra
member of its Δᵢ-set family (same shape as Fig 3's shortest-path row): the
mutable set is each vertex's component label (its vertex id as f32, exact
below 2²⁴), the Δᵢ set is the vertices whose label decreased since they
last propagated.  Fixpoint ``label(v) = min(label(v), min_{u→v}
label(u))``: labels flow along edge direction only.

Kernels as in ``sssp.py``: delta_scatter and edge_propagate with min, and
scatter_route with min under the ``auto`` route.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.algorithms import emission
from repro_torch.algorithms.sssp import INF, min_fold, min_push
from repro_torch.core.delta import DeltaBuffer, _i32
from repro_torch.core.engine import DeltaAlgorithm, ShardedExecutor
from repro_torch.core.fixpoint import FixpointResult
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_propagate import CSCCache


class CCState(NamedTuple):
    label: torch.Tensor   # f32[block] current component label (vertex ids)
    sent: torch.Tensor    # f32[block] label last propagated


def make_algorithm(snapshot: PartitionSnapshot, src_capacity: int = 1024,
                   edge_capacity: int = 16384, use_kernels: bool = True
                   ) -> DeltaAlgorithm:
    block = snapshot.block_size
    n_padded = snapshot.padded_keys
    csc = CSCCache(n_padded)   # ragged CSC per shard, kept per graph

    def active_fn(state: CCState, graph: CSRGraph):
        active = state.label < state.sent
        est_edges = _i32(torch.where(active, graph.out_degree, 0).sum())
        return active, est_edges

    def make_sparse_emit(src_cap: int, edge_cap: int):
        def sparse_emit(state: CCState, graph: CSRGraph, active, stratum,
                        shard_id):
            payload = torch.where(active, state.label, INF)
            out = emission.emit_over_edges(graph, active, payload, src_cap,
                                           edge_cap)
            new_sent = torch.where(active, state.label, state.sent)
            return CCState(label=state.label, sent=new_sent), out
        return sparse_emit

    def dense_emit(state: CCState, graph: CSRGraph, stratum, shard_id):
        contrib = min_push(state.label, graph, csc, shard_id, use_kernels)
        return CCState(label=state.label, sent=state.label), contrib[:, None]

    def apply_sparse(state: CCState, incoming: DeltaBuffer, graph: CSRGraph,
                     stratum, shard_id):
        label = min_fold(state.label, incoming, shard_id, block, use_kernels)
        return (CCState(label=label, sent=state.sent),
                _i32((label < state.sent).sum()))

    def apply_dense(state: CCState, incoming: torch.Tensor, graph: CSRGraph,
                    stratum, shard_id):
        label = torch.minimum(state.label, incoming[:, 0])
        return (CCState(label=label, sent=state.sent),
                _i32((label < state.sent).sum()))

    return DeltaAlgorithm(
        active_fn=active_fn,
        sparse_emit=make_sparse_emit(src_capacity, edge_capacity),
        dense_emit=dense_emit, apply_sparse=apply_sparse,
        apply_dense=apply_dense, combiner="min", payload_width=1,
        bytes_per_delta=8, emit_factory=make_sparse_emit)


def initial_state(snapshot: PartitionSnapshot, device=None) -> CCState:
    S, block = snapshot.num_shards, snapshot.block_size
    dev = resolve_device(device)
    ids = torch.arange(S * block, dtype=torch.float32, device=dev)
    return CCState(label=ids.reshape(S, block),
                   sent=torch.full((S, block), INF, dtype=torch.float32,
                                   device=dev))


def run(graph_sharded: CSRGraph, snapshot: PartitionSnapshot,
        mode: str = "delta", max_iters: int = 80,
        executor: Optional[ShardedExecutor] = None,
        src_capacity: int = 1024, edge_capacity: int = 16384,
        ladder_tiers: int = 1, route_strategy: str = "sort",
        device=None, use_kernels: bool = True
        ) -> tuple[torch.Tensor, FixpointResult]:
    """Run CC on ``device`` (None = CUDA; raises without it); returns
    (labels [padded_keys], FixpointResult)."""
    dev = resolve_device(device)
    graph = graph_sharded.to(dev)
    algo = make_algorithm(snapshot, src_capacity, edge_capacity,
                          use_kernels=use_kernels)
    if executor is None:
        executor = ShardedExecutor(
            snapshot=snapshot, seg_capacity=edge_capacity,
            edge_capacity=edge_capacity, src_capacity=src_capacity,
            ladder_tiers=ladder_tiers, route_strategy=route_strategy,
            use_kernels=use_kernels)
    res = executor.run(algo, initial_state(snapshot, dev),
                       snapshot.padded_keys, graph, max_iters, mode=mode)
    return res.state.label.reshape(-1), res


def reference_components(indptr: np.ndarray, indices: np.ndarray, n: int,
                         device=None) -> torch.Tensor:
    """Dense oracle of the same directed min-label fixpoint: every edge
    each round (``scatter_reduce`` amin) until no label changes.  f32[n]."""
    dev = resolve_device(device)
    counts = np.diff(indptr)
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.from_numpy(counts).to(dev))
    dst = torch.from_numpy(np.asarray(indices[:len(src)], np.int64)).to(dev)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    label = torch.arange(n, dtype=torch.float64, device=dev)
    for _ in range(n):  # worst-case diameter
        new = label.scatter_reduce(0, dst, label[src], "amin",
                                   include_self=True)
        if bool(torch.equal(new, label)):
            break
        label = new
    return label.to(torch.float32)
