"""Delta-based adsorption / label propagation (paper Fig 3, row 2).

Each vertex carries an L-dimensional label distribution.  Seeded vertices
inject their own label; every vertex's vector is the damped average of its
in-neighbors' vectors plus its injection:

    vec(v) = inj·seed(v) + (1 − inj) · Σ_{u→v} sent(u) / outdeg(u)

The Δᵢ set is the vertices whose vector moved (L∞) past the threshold since
they last propagated.  Payloads are W = L columns; everything else is the
PageRank pattern with vector deltas.

With ``use_kernels`` the sparse apply folds through ``kernels/delta_scatter``
(add at W = L), which takes the incoming buffer's global keys and the
shard's first key; the engine's routes reach ``kernels/scatter_route`` and
``kernels/delta_route`` at the same width.  The dense body is its own
scatter over the edges, as in the reference (no kernel).
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

INJECTION = 0.25


class AdsorptionState(NamedTuple):
    acc: torch.Tensor    # f32[block, L] accumulated incoming mass
    sent: torch.Tensor   # f32[block, L] vector last propagated
    seed: torch.Tensor   # f32[block, L] injected label (fixed for a run)


def current_vec(state: AdsorptionState) -> torch.Tensor:
    return INJECTION * state.seed + (1.0 - INJECTION) * state.acc


def current_vec_fma(state: AdsorptionState) -> torch.Tensor:
    """:func:`current_vec` rounded once, as a fused multiply-add (the
    products are exact in float64)."""
    return ((1.0 - INJECTION) * state.acc.double()
            + INJECTION * state.seed.double()).to(state.acc.dtype)


def make_algorithm(snapshot: PartitionSnapshot, n_labels: int,
                   threshold: float = 1e-2, src_capacity: int = 1024,
                   edge_capacity: int = 16384, use_kernels: bool = True
                   ) -> DeltaAlgorithm:
    """The dense body rounds its vector once (:func:`current_vec_fma`)
    when every stratum is dense (``mode="nodelta"``), as the reference's
    compiled loop does, and twice as a branch of the density ladder."""
    block = snapshot.block_size
    n_padded = snapshot.padded_keys

    def n_active(state: AdsorptionState) -> torch.Tensor:
        diff = torch.abs(current_vec(state) - state.sent).amax(-1)
        return _i32((diff > threshold).sum())

    def active_fn(state: AdsorptionState, graph: CSRGraph):
        active = torch.abs(current_vec(state) - state.sent).amax(-1) \
            > threshold
        est_edges = _i32(torch.where(active, graph.out_degree, 0).sum())
        return active, est_edges

    def make_sparse_emit(src_cap: int, edge_cap: int):
        def sparse_emit(state: AdsorptionState, graph: CSRGraph, active,
                        stratum, shard_id):
            vec = current_vec(state)
            deg = torch.clamp(graph.out_degree, min=1).to(vec.dtype)[:, None]
            payload = torch.where(active[:, None], (vec - state.sent) / deg,
                                  0.0)
            out = emission.emit_over_edges_vec(graph, active, payload,
                                               src_cap, edge_cap)
            new_sent = torch.where(active[:, None], vec, state.sent)
            return AdsorptionState(state.acc, new_sent, state.seed), out
        return sparse_emit

    def make_dense_emit(vec_of):
        def dense_emit(state: AdsorptionState, graph: CSRGraph, stratum,
                       shard_id):
            # Full push: every source contributes vec/deg along every edge.
            vec = vec_of(state)
            deg = torch.clamp(graph.out_degree, min=1).to(vec.dtype)[:, None]
            dst, per_edge = emission.dense_push(graph, vec / deg)
            contrib = emission.fold(vec.new_zeros((n_padded, vec.shape[-1])),
                                    dst, per_edge)
            return AdsorptionState(state.acc, vec, state.seed), contrib
        return dense_emit

    def apply_sparse(state: AdsorptionState, incoming: DeltaBuffer,
                     graph: CSRGraph, stratum, shard_id):
        if use_kernels:
            from repro_torch.kernels.delta_scatter import delta_scatter
            inc = delta_scatter(state.acc.new_zeros(state.acc.shape),
                                incoming.keys.contiguous(),
                                incoming.payload.contiguous(),
                                key_base=shard_id * block)
        else:
            inc = emission.scatter_local_vec(incoming, shard_id, block)
        new_state = AdsorptionState(state.acc + inc, state.sent, state.seed)
        return new_state, n_active(new_state)

    def apply_dense(state: AdsorptionState, incoming: torch.Tensor,
                    graph: CSRGraph, stratum, shard_id):
        new_state = AdsorptionState(incoming, state.sent, state.seed)
        return new_state, n_active(new_state)

    return DeltaAlgorithm(
        active_fn=active_fn,
        sparse_emit=make_sparse_emit(src_capacity, edge_capacity),
        dense_emit=make_dense_emit(current_vec), apply_sparse=apply_sparse,
        apply_dense=apply_dense, combiner="add", payload_width=n_labels,
        bytes_per_delta=4 + 4 * n_labels, emit_factory=make_sparse_emit,
        nodelta_dense_emit=make_dense_emit(current_vec_fma))


def initial_state(snapshot: PartitionSnapshot, seeds, device=None
                  ) -> AdsorptionState:
    """seeds: f32[padded_keys, L] one-hot (or zero) injection vectors (a
    tensor or anything ``numpy.asarray`` reads)."""
    dev = resolve_device(device)
    S, block = snapshot.num_shards, snapshot.block_size
    if not torch.is_tensor(seeds):
        seeds = torch.from_numpy(np.asarray(seeds, np.float32))
    seed = seeds.to(device=dev, dtype=torch.float32).reshape(S, block, -1)
    z = torch.zeros_like(seed)
    return AdsorptionState(acc=z, sent=z, seed=seed)


def run(graph_sharded: CSRGraph, snapshot: PartitionSnapshot, seeds,
        mode: str = "delta", threshold: float = 1e-2, max_iters: int = 50,
        executor: Optional[ShardedExecutor] = None,
        src_capacity: int = 1024, edge_capacity: int = 16384,
        ladder_tiers: int = 1, route_strategy: str = "sort", device=None,
        use_kernels: bool = True) -> tuple[torch.Tensor, FixpointResult]:
    """Run adsorption on ``device`` (None = CUDA; raises without it);
    returns (label vectors f32[padded_keys, L], FixpointResult)."""
    dev = resolve_device(device)
    state0 = initial_state(snapshot, seeds, dev)
    n_labels = state0.seed.shape[-1]
    algo = make_algorithm(snapshot, n_labels, threshold, src_capacity,
                          edge_capacity, use_kernels=use_kernels)
    if executor is None:
        executor = ShardedExecutor(
            snapshot=snapshot, seg_capacity=edge_capacity,
            edge_capacity=edge_capacity, src_capacity=src_capacity,
            ladder_tiers=ladder_tiers, route_strategy=route_strategy,
            use_kernels=use_kernels)
    res = executor.run(algo, state0, snapshot.padded_keys,
                       graph_sharded.to(dev), max_iters, mode=mode)
    return current_vec(res.state).reshape(-1, n_labels), res
