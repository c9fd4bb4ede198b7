"""Public op + one-time ragged CSC of the immutable set.

:func:`build_csc` turns one shard's CSR into the destination-grouped pull
layout the kernel reads: destinations in order, an indptr over them, and
src / weight per edge, and the list of *heavy* destinations (more than
``HEAVY_EDGES`` edges, a warp's width), which the kernel gives a warp each
while every other destination gets a thread.  The edge relation is REX's
*immutable set*, so this is paid once per graph.  Unlike the TPU layout
(every destination tile padded to one edge count), nothing is padded: on
power-law graphs the head-biased destinations would blow the padding up.

On a CUDA tensor :func:`edge_propagate` launches the kernel
(``csrc/edge_propagate.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data.graphs import CSRGraph
from repro_torch.kernels.edge_propagate.ref import edge_propagate_ref

OPS = {"add": 0, "min": 1, "max": 2}
HEAVY_EDGES = 32     # a row with more edges than a warp's width is heavy

launches = 0         # kernel launches since the last reset


@dataclasses.dataclass(frozen=True, eq=False)
class RaggedCSC:
    """One shard's ragged CSC.  ``heavy`` is not a field a caller sets: it
    is derived from ``indptr`` whenever a RaggedCSC is made (by
    :func:`build_csc`, directly or by ``dataclasses.replace``), so it lists
    exactly the rows of more than ``HEAVY_EDGES`` edges, which the kernel
    writes from the list and nowhere else."""
    indptr: torch.Tensor   # int32[n_dst + 1] edge range of each destination
    src: torch.Tensor      # int32[E] local source of each edge
    weight: torch.Tensor   # f32[E]
    heavy: torch.Tensor = dataclasses.field(init=False)  # int32[n_heavy]

    def __post_init__(self):
        lengths = self.indptr[1:] - self.indptr[:-1]
        heavy = torch.nonzero(lengths > HEAVY_EDGES)[:, 0].to(torch.int32)
        object.__setattr__(self, "heavy", heavy.contiguous())


def build_csc(graph: CSRGraph, n_dst: int,
              weights: Optional[torch.Tensor] = None) -> RaggedCSC:
    """One shard's CSR (PAD = -1 slots dropped) -> ragged CSC over
    destinations [0, n_dst).  Edges of one destination keep their CSR
    order.  ``heavy`` lists, in order, the destinations of more than
    ``HEAVY_EDGES`` edges."""
    dev = graph.device
    slots = torch.arange(graph.nnz_capacity, dtype=torch.int32, device=dev)
    src = torch.searchsorted(graph.indptr, slots, right=True,
                             out_int32=True) - 1
    dst = graph.indices
    keep = (dst >= 0) & (dst < n_dst)
    w = (torch.ones(graph.nnz_capacity, dtype=torch.float32, device=dev)
         if weights is None else weights.to(torch.float32))
    src, dst, w = src[keep], dst[keep], w[keep]
    dst_sorted, order = torch.sort(dst, stable=True)
    counts = torch.bincount(dst_sorted, minlength=n_dst)
    indptr = torch.zeros(n_dst + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return RaggedCSC(indptr=indptr, src=src[order].contiguous(),
                     weight=w[order].contiguous())


class CSCCache:
    """Each shard's ragged CSC over destinations [0, ``n_dst``), built on
    first use and rebuilt when, and only when, the shard's graph changes:
    an entry is reused only while ``indptr`` and ``indices`` are the same
    tensors as before (device, address, shape, strides and ``_version``,
    which counts in-place writes).  The entry holds those tensors, so no
    other graph can take their memory while it lives.  An algorithm keeps
    one cache across runs: a view hands it a rebuilt graph every refresh."""

    def __init__(self, n_dst: int):
        self.n_dst = n_dst
        self._entries: dict = {}   # shard -> (identity, tensors, RaggedCSC)

    @staticmethod
    def _identity(graph: CSRGraph) -> tuple:
        return tuple((str(t.device), t.data_ptr(), tuple(t.shape),
                      t.stride(), t._version)
                     for t in (graph.indptr, graph.indices))

    def get(self, shard_id: int, graph: CSRGraph) -> RaggedCSC:
        ident = self._identity(graph)
        entry = self._entries.get(shard_id)
        if entry is None or entry[0] != ident:
            entry = (ident, (graph.indptr, graph.indices),
                     build_csc(graph, self.n_dst))
            self._entries[shard_id] = entry
        return entry[2]


def edge_propagate(payload: torch.Tensor, csc: RaggedCSC,
                   combiner: str = "add") -> torch.Tensor:
    """payload f32[N_src] -> f32[n_dst]: out[d] = combine over edges s->d
    of payload[s] * w, identity where d has no edges.  The kernel gives a
    thread to each row of at most ``HEAVY_EDGES`` edges and a warp to each
    row of ``csc.heavy``."""
    if not payload.is_cuda:
        return edge_propagate_ref(payload, csc.indptr, csc.src, csc.weight,
                                  combiner)
    if combiner not in OPS:
        raise ValueError(f"unsupported combiner {combiner!r}")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    n_dst = csc.indptr.shape[0] - 1
    out = torch.empty((n_dst,), dtype=torch.float32, device=payload.device)
    p = _build.ptr
    err = lib.edge_propagate(
        p(payload, torch.float32, "payload"),
        p(csc.indptr, torch.int32, "indptr"), p(csc.src, torch.int32, "src"),
        p(csc.weight, torch.float32, "weight"),
        p(csc.heavy, torch.int32, "heavy"), n_dst, csc.heavy.shape[0],
        HEAVY_EDGES, OPS[combiner], out.data_ptr(), _build.stream_of(payload))
    _build.check(err, "edge_propagate")
    launches += 1
    return out
