"""Delta-based single-source shortest path (paper Listing 2, Figs 7/9).

Fixpoint: ``dist(v) = min(dist(v), min_{u→v} dist(u) + 1)`` (unweighted,
as in the paper's DBPedia/Twitter experiments).

Delta formulation (the paper's SPAgg handler): a vertex is in the Δᵢ set,
the *frontier*, when its distance improved since it last propagated.  It
emits ``dist+1`` to each out-neighbor; receivers fold with a min-combiner.
No-delta re-relaxes every settled vertex each stratum.

With ``use_kernels`` the sparse apply folds through ``kernels/delta_scatter``
(min; it takes the incoming buffer's global keys and the shard's first
key) and the dense body through ``kernels/edge_propagate`` (min, over a
ragged CSC built once per shard and graph); the engine's ``auto`` route
reaches ``kernels/scatter_route`` with min.  Otherwise the torch-op functions of
``emission.py`` run.  Min is order-free, so both paths give equal values.
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

INF = float("inf")


class SPState(NamedTuple):
    dist: torch.Tensor   # f32[block] current best distance
    sent: torch.Tensor   # f32[block] distance last propagated (inf = never)


def min_fold(values: torch.Tensor, incoming: DeltaBuffer, shard_id: int,
             block: int, use_kernels: bool) -> torch.Tensor:
    """``min(values, scatter_local(incoming, "min"))``: the incoming deltas
    of one shard folded into f32[block] with the min combiner."""
    if use_kernels:
        from repro_torch.kernels.delta_scatter import delta_scatter
        return delta_scatter(values[:, None].contiguous(),
                             incoming.keys.contiguous(),
                             incoming.payload[:, :1].contiguous(), "min",
                             key_base=shard_id * block)[:, 0]
    return torch.minimum(values, emission.scatter_local(incoming, shard_id,
                                                        block, "min"))


def min_push(payload: torch.Tensor, graph: CSRGraph, csc: CSCCache,
             shard_id: int, use_kernels: bool) -> torch.Tensor:
    """Dense min over every edge u→v of ``payload[u]``: f32[csc.n_dst], inf
    where no edge lands."""
    if use_kernels:
        return edge_propagate(payload, csc.get(shard_id, graph), "min")
    dst, pay = emission.dense_push(graph, payload)
    return emission.fold(pay.new_full((csc.n_dst, 1), INF), dst,
                         pay[:, None], "min")[:, 0]


def make_algorithm(snapshot: PartitionSnapshot, src_capacity: int = 1024,
                   edge_capacity: int = 16384, use_kernels: bool = True
                   ) -> DeltaAlgorithm:
    block = snapshot.block_size
    n_padded = snapshot.padded_keys
    csc = CSCCache(n_padded)   # ragged CSC per shard, kept per graph

    def active_fn(state: SPState, graph: CSRGraph):
        active = state.dist < state.sent          # improved since last send
        est_edges = _i32(torch.where(active, graph.out_degree, 0).sum())
        return active, est_edges

    def make_sparse_emit(src_cap: int, edge_cap: int):
        def sparse_emit(state: SPState, graph: CSRGraph, active, stratum,
                        shard_id):
            payload = torch.where(active, state.dist + 1.0, INF)
            out = emission.emit_over_edges(graph, active, payload, src_cap,
                                           edge_cap)
            new_sent = torch.where(active, state.dist, state.sent)
            return SPState(dist=state.dist, sent=new_sent), out
        return sparse_emit

    def dense_emit(state: SPState, graph: CSRGraph, stratum, shard_id):
        payload = torch.where(state.dist < INF, state.dist + 1.0, INF)
        contrib = min_push(payload, graph, csc, shard_id, use_kernels)
        return SPState(dist=state.dist, sent=state.dist), contrib[:, None]

    def apply_sparse(state: SPState, incoming: DeltaBuffer, graph: CSRGraph,
                     stratum, shard_id):
        dist = min_fold(state.dist, incoming, shard_id, block, use_kernels)
        return (SPState(dist=dist, sent=state.sent),
                _i32((dist < state.sent).sum()))

    def apply_dense(state: SPState, incoming: torch.Tensor, graph: CSRGraph,
                    stratum, shard_id):
        dist = torch.minimum(state.dist, incoming[:, 0])
        return (SPState(dist=dist, sent=state.sent),
                _i32((dist < state.sent).sum()))

    return DeltaAlgorithm(
        active_fn=active_fn,
        sparse_emit=make_sparse_emit(src_capacity, edge_capacity),
        dense_emit=dense_emit, apply_sparse=apply_sparse,
        apply_dense=apply_dense, combiner="min", payload_width=1,
        bytes_per_delta=8, emit_factory=make_sparse_emit)


def initial_state(snapshot: PartitionSnapshot, source: int = 0,
                  device=None) -> SPState:
    S, block = snapshot.num_shards, snapshot.block_size
    dev = resolve_device(device)
    dist = torch.full((S, block), INF, dtype=torch.float32, device=dev)
    dist[source // block, source % block] = 0.0
    sent = torch.full((S, block), INF, dtype=torch.float32, device=dev)
    return SPState(dist=dist, sent=sent)


def run(graph_sharded: CSRGraph, snapshot: PartitionSnapshot,
        source: int = 0, mode: str = "delta", max_iters: int = 80,
        executor: Optional[ShardedExecutor] = None,
        src_capacity: int = 1024, edge_capacity: int = 16384,
        ladder_tiers: int = 1, route_strategy: str = "sort",
        device=None, use_kernels: bool = True
        ) -> tuple[torch.Tensor, FixpointResult]:
    """Run SSSP from ``source`` on ``device`` (None = CUDA; raises without
    it); returns (dist [padded_keys], FixpointResult)."""
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
    res = executor.run(algo, initial_state(snapshot, source, dev), 1, graph,
                       max_iters, mode=mode)
    return res.state.dist.reshape(-1), res


def reference_sssp(indptr: np.ndarray, indices: np.ndarray, n: int,
                   source: int = 0, device=None) -> torch.Tensor:
    """BFS oracle (unweighted shortest path), level-synchronous over the
    global edge list: f32[n], inf where unreachable."""
    dev = resolve_device(device)
    counts = np.diff(indptr)
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.from_numpy(counts).to(dev))
    dst = torch.from_numpy(np.asarray(indices[:len(src)], np.int64)).to(dev)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    dist = torch.full((n,), INF, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    level = 0
    while bool(frontier.any()):
        level += 1
        reached = torch.zeros(n, dtype=torch.bool, device=dev)
        reached[dst[frontier[src]]] = True
        frontier = reached & torch.isinf(dist)
        dist[frontier] = float(level)
    return dist
