"""Plain torch version of the edge_propagate kernel: a gather over the
ragged CSC, then ``emission.fold`` (the reduction PageRank's dense body
runs on ``emission.dense_push``'s edges)."""
from __future__ import annotations

import torch

from repro_torch.algorithms.emission import IDENTITY, fold


def edge_propagate_ref(payload: torch.Tensor, indptr: torch.Tensor,
                       src: torch.Tensor, weight: torch.Tensor,
                       combiner: str = "add") -> torch.Tensor:
    """Same contract as ``ops.edge_propagate`` over the ragged CSC: returns
    f32[n_dst] with out[d] = combine over d's edges of payload[src] * w
    (identity where d has none).  Adds land in edge order."""
    if combiner not in IDENTITY:
        raise ValueError(f"unknown combiner {combiner!r}")
    n_dst = indptr.shape[0] - 1
    dev = payload.device
    dst = torch.repeat_interleave(
        torch.arange(n_dst, dtype=torch.int32, device=dev),
        (indptr[1:] - indptr[:-1]).long(), output_size=src.shape[0])
    base = torch.full((n_dst, 1), IDENTITY[combiner], dtype=payload.dtype,
                      device=dev)
    return fold(base, dst, (payload[src.long()] * weight)[:, None],
                combiner)[:, 0]
