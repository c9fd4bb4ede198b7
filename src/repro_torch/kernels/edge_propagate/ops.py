"""Public op + one-time ragged CSC of the immutable set.

:func:`build_csc` turns one shard's CSR into the destination-grouped pull
layout the kernel reads: destinations in order, an indptr over them, and
src / weight per edge.  The edge relation is REX's *immutable set*, so this
is paid once per graph.  Unlike the TPU layout (every destination tile
padded to one edge count), nothing is padded: on power-law graphs the
head-biased destinations would blow the padding up.

On a CUDA tensor :func:`edge_propagate` launches the kernel
(``csrc/edge_propagate.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.data.graphs import CSRGraph
from repro_torch.kernels.edge_propagate.ref import edge_propagate_ref

OPS = {"add": 0, "min": 1, "max": 2}

launches = 0         # kernel launches since the last reset


class RaggedCSC(NamedTuple):
    indptr: torch.Tensor   # int32[n_dst + 1] edge range of each destination
    src: torch.Tensor      # int32[E] local source of each edge
    weight: torch.Tensor   # f32[E]


def build_csc(graph: CSRGraph, n_dst: int,
              weights: Optional[torch.Tensor] = None) -> RaggedCSC:
    """One shard's CSR (PAD = -1 slots dropped) -> ragged CSC over
    destinations [0, n_dst).  Edges of one destination keep their CSR
    order."""
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


def edge_propagate(payload: torch.Tensor, csc: RaggedCSC,
                   combiner: str = "add") -> torch.Tensor:
    """payload f32[N_src] -> f32[n_dst]: out[d] = combine over edges s->d
    of payload[s] * w, identity where d has no edges."""
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
        p(csc.weight, torch.float32, "weight"), n_dst, OPS[combiner],
        out.data_ptr(), _build.stream_of(payload))
    _build.check(err, "edge_propagate")
    launches += 1
    return out
