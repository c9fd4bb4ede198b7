"""Sparse delta emission over CSR adjacency.

The join-handler emission (PRAgg / SPAgg ``update`` returning a ``resBag``
of per-neighbor deltas): for the set of *active* sources, walk their
out-edges and emit one delta per edge.  The work is O(|Δ| edges), bounded by
an edge-slot budget ``edge_capacity``:

  1. compact active sources into a list (≤ ``src_capacity``),
  2. prefix-sum their degrees,
  3. map each edge slot e ∈ [0, edge_capacity) to (source rank, offset)
     by binary search over the prefix sums,
  4. gather destination + payload per slot.

Every function works on one shard's tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import (ANN_ADJUST, PAD_KEY, DeltaBuffer, _i32,
                                    _scatter_minmax)
from repro_torch.data.graphs import CSRGraph


def emit_over_edges(graph: CSRGraph, active_mask: torch.Tensor,
                    payload_of_src: torch.Tensor, src_capacity: int,
                    edge_capacity: int) -> DeltaBuffer:
    """Emit one delta per out-edge of each active source.

    graph           local CSR shard (indptr[int32; B+1], indices global).
    active_mask     bool[B] over local sources.
    payload_of_src  f32[B]: per-edge payload emitted by source v.
    Returns a DeltaBuffer of capacity ``edge_capacity`` keyed by GLOBAL
    destination vertex; ``overflowed`` is set when either the active-source
    list or the edge budget is exceeded.
    """
    return emit_over_edges_vec(graph, active_mask, payload_of_src[:, None],
                               src_capacity, edge_capacity)


def emit_over_edges_vec(graph: CSRGraph, active_mask: torch.Tensor,
                        payload_of_src: torch.Tensor, src_capacity: int,
                        edge_capacity: int) -> DeltaBuffer:
    """Vector-payload form of :func:`emit_over_edges`: payload_of_src is
    f32[B, W], one W-column payload per source (adsorption ships whole
    label-distribution diffs; paper Fig 3 row 2)."""
    dev = active_mask.device
    B = active_mask.shape[0]
    src_db = DeltaBuffer.from_dense_mask(
        active_mask, torch.arange(B, dtype=torch.int32, device=dev),
        payload_of_src, src_capacity)
    src_idx = src_db.keys.clamp(0, B - 1).long()
    live_src = src_db.keys != PAD_KEY
    deg = torch.where(live_src, graph.indptr[src_idx + 1]
                      - graph.indptr[src_idx], 0)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        _i32(torch.cumsum(deg, 0))])
    total_edges = starts[-1]
    slots = torch.arange(edge_capacity, dtype=torch.int32, device=dev)
    owner = torch.searchsorted(starts, slots, right=True, out_int32=True) - 1
    owner = owner.clamp(0, src_capacity - 1).long()
    offset = slots - starts[owner]
    valid = slots < total_edges
    pos = (graph.indptr[src_idx[owner]] + offset).clamp(
        0, graph.nnz_capacity - 1).long()
    dst = graph.indices[pos]
    valid = valid & (dst >= 0)
    payload = src_db.payload[owner]
    return DeltaBuffer(
        keys=torch.where(valid, dst, PAD_KEY),
        payload=torch.where(valid[:, None], payload, 0.0),
        ann=torch.full((edge_capacity,), ANN_ADJUST, dtype=torch.int8,
                       device=dev),
        count=_i32(valid.sum()),
        overflowed=src_db.overflowed | (total_edges > edge_capacity))


def dense_push(graph: CSRGraph, payload_of_src: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense analogue: every source pushes payload along ALL its edges.

    ``payload_of_src`` is f32[B] or f32[B, W].  Returns per-edge
    (dst_global_keys[int32; nnz_cap] with -1 on padding, payload[f32;
    nnz_cap] or [f32; nnz_cap, W]); callers fold them into their own key
    space.
    """
    dev = payload_of_src.device
    slots = torch.arange(graph.nnz_capacity, dtype=torch.int32, device=dev)
    src = torch.searchsorted(graph.indptr, slots, right=True,
                             out_int32=True) - 1
    src = src.clamp(0, graph.n_src - 1).long()
    dst = graph.indices
    valid = dst >= 0
    payload = payload_of_src[src]
    payload = torch.where(valid.view((-1,) + (1,) * (payload.dim() - 1)),
                          payload, 0.0)
    return torch.where(valid, dst, -1), payload


def to_local_keys(db: DeltaBuffer, shard_id: int, block: int
                  ) -> torch.Tensor:
    """Global → local key conversion under the block partition scheme."""
    return torch.where(db.keys == PAD_KEY, -1, db.keys - shard_id * block)


IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf")}


def fold(state: torch.Tensor, idx: torch.Tensor, payload: torch.Tensor,
         combiner: str = "add") -> torch.Tensor:
    """A new f32[N, W]: ``state`` with each row ``payload[i]`` combined into
    row ``idx[i]``; out-of-range idx (-1 padding included) are dropped.
    Adds land in slot order.  This is the plain version of the
    ``delta_scatter`` kernel and of ``edge_propagate``'s reduction."""
    if combiner not in IDENTITY:
        raise ValueError(f"unknown combiner {combiner!r}")
    n, w = state.shape
    safe = (idx >= 0) & (idx < n)
    tgt = torch.where(safe, idx, n)
    base = torch.cat([state, state.new_zeros((1, w))])
    vals = torch.where(safe[:, None], payload, IDENTITY[combiner])
    if combiner == "add":
        return base.index_add_(0, tgt, vals)[:n]
    return _scatter_minmax(base, tgt, vals, combiner)[:n]


def scatter_local(db: DeltaBuffer, shard_id: int, block: int,
                  combiner: str = "add") -> torch.Tensor:
    """Scatter an incoming (post-rehash) delta buffer into a dense local
    block with the requested combiner; returns f32[block]."""
    base = torch.full((block, 1), IDENTITY.get(combiner, 0.0),
                      dtype=db.payload.dtype, device=db.device)
    return fold(base, to_local_keys(db, shard_id, block), db.payload[:, :1],
                combiner)[:, 0]


def scatter_local_vec(db: DeltaBuffer, shard_id: int, block: int
                      ) -> torch.Tensor:
    """Vector add-scatter of an incoming buffer: returns f32[block, W]."""
    return fold(db.payload.new_zeros((block, db.payload_width)),
                to_local_keys(db, shard_id, block), db.payload)
