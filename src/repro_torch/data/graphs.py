"""Synthetic graphs shaped like the paper's datasets (§6 "Data").

The paper uses the DBPedia article-link graph (48M edges / 3.3M vertices,
avg degree ~14.5) and a Twitter follower graph (1.4B edges / 41M vertices,
avg degree ~34).  We generate power-law (Zipf out-degree) directed graphs
with matching shape statistics, stored as padded CSR partitioned by source
vertex: the paper's "edge relation partitioned by vertexId" (immutable set).

The generator is numpy, identical to the reference package's, so the same
seed gives the same graph in both.

CSR layout per shard (block partition over sources):
  indptr:  int32[block+1]       local CSR row pointers
  indices: int32[nnz_capacity]  destination GLOBAL vertex ids (PAD = -1)
  out_degree: int32[block]      true out-degree per local source
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Single-shard (or global) padded CSR directed graph; the sharded form
    carries a leading [num_shards] axis on every field."""

    indptr: torch.Tensor      # int32[n_src + 1]
    indices: torch.Tensor     # int32[nnz_cap], PAD = -1
    out_degree: torch.Tensor  # int32[n_src]

    @property
    def n_src(self) -> int:
        return self.out_degree.shape[-1]

    @property
    def nnz_capacity(self) -> int:
        return self.indices.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "CSRGraph":
        return CSRGraph(*(t.to(device) for t in
                          (self.indptr, self.indices, self.out_degree)))


def zipf_outdegrees(n_vertices: int, avg_degree: float, alpha: float,
                    rng: np.random.Generator, max_degree: int | None = None
                    ) -> np.ndarray:
    """Zipf-ish out-degree sequence normalized to the requested average."""
    raw = rng.zipf(alpha, size=n_vertices).astype(np.float64)
    if max_degree is None:
        max_degree = max(int(avg_degree * 50), 8)
    raw = np.minimum(raw, max_degree)
    scale = avg_degree * n_vertices / raw.sum()
    deg = np.maximum(np.round(raw * scale), 0).astype(np.int64)
    deg = np.minimum(deg, n_vertices - 1)
    return deg.astype(np.int32)


def make_powerlaw_graph(n_vertices: int, avg_degree: float = 14.5,
                        alpha: float = 2.1, seed: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Global CSR (indptr int64, indices int32) with Zipf out-degrees and
    head-biased destinations (in-degree is heavy-tailed too)."""
    rng = np.random.default_rng(seed)
    deg = zipf_outdegrees(n_vertices, avg_degree, alpha, rng)
    indptr = np.zeros(n_vertices + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    n_head = max(n_vertices // 100, 1)
    n_from_head = nnz // 3
    dst = np.empty(nnz, np.int32)
    dst[:n_from_head] = rng.integers(0, n_head, n_from_head)
    dst[n_from_head:] = rng.integers(0, n_vertices, nnz - n_from_head)
    rng.shuffle(dst)
    return indptr.astype(np.int64), dst


def shard_csr(indptr: np.ndarray, indices: np.ndarray, num_shards: int,
              nnz_capacity: int | None = None, device=None) -> CSRGraph:
    """Partition a global CSR by source block into stacked per-shard CSR
    with a leading [num_shards] axis.  ``nnz_capacity`` pins the per-shard
    edge-slot capacity (raises if a shard's edges exceed it)."""
    dev = resolve_device(device)
    n = indptr.shape[0] - 1
    block = -(-n // num_shards)
    padded = block * num_shards
    deg_padded = np.zeros(padded, np.int64)
    deg_padded[:n] = np.diff(indptr)
    per_shard_nnz = deg_padded.reshape(num_shards, block).sum(axis=1)
    nnz_cap = max(int(per_shard_nnz.max()) if len(per_shard_nnz) else 0, 1)
    if nnz_capacity is not None:
        if nnz_cap > nnz_capacity:
            raise ValueError(
                f"shard nnz {nnz_cap} exceeds pinned capacity {nnz_capacity}")
        nnz_cap = nnz_capacity
    sh_indptr = np.zeros((num_shards, block + 1), np.int32)
    sh_indices = np.full((num_shards, nnz_cap), -1, np.int32)
    sh_deg = deg_padded.reshape(num_shards, block).astype(np.int32)
    for s in range(num_shards):
        lo, hi = s * block, min((s + 1) * block, n)
        sh_indptr[s, 1:] = np.cumsum(sh_deg[s])
        if hi > lo:
            seg = indices[indptr[lo]:indptr[hi]]
            sh_indices[s, :len(seg)] = seg
    return CSRGraph(indptr=torch.from_numpy(sh_indptr).to(dev),
                    indices=torch.from_numpy(sh_indices).to(dev),
                    out_degree=torch.from_numpy(sh_deg).to(dev))


def csr_to_edges(indptr: np.ndarray, indices: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Global CSR -> (src, dst) edge list (drops PAD=-1 slots)."""
    n = indptr.shape[0] - 1
    src = np.repeat(np.arange(n, dtype=np.int32),
                    np.diff(indptr).astype(np.int64))
    dst = np.asarray(indices[:len(src)], np.int32)
    keep = dst >= 0
    return src[keep], dst[keep]


def edges_to_csr(src: np.ndarray, dst: np.ndarray, n: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) edge list -> global CSR (indptr int64, indices int32),
    stable in the input edge order within each source row."""
    src = np.asarray(src, np.int64)
    order = np.argsort(src, kind="stable")
    deg = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, np.asarray(dst, np.int32)[order]


def global_csr(indptr: np.ndarray, indices: np.ndarray, device=None
               ) -> CSRGraph:
    """Single-shard CSRGraph view of a global CSR."""
    dev = resolve_device(device)
    return CSRGraph(
        indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
        indices=torch.from_numpy(np.asarray(indices, np.int32)).to(dev),
        out_degree=torch.from_numpy(np.diff(indptr).astype(np.int32)).to(dev))


# Named dataset shapes (scaled-down analogues of the paper's datasets).
DATASETS = {
    # name: (n_vertices, avg_degree, alpha)
    "dbpedia-small": (4_096, 14.5, 2.1),     # unit tests
    "dbpedia": (65_536, 14.5, 2.1),          # benches
    "twitter-small": (8_192, 34.0, 1.9),
    "twitter": (131_072, 34.0, 1.9),
}


def load_dataset(name: str, num_shards: int = 1, seed: int = 0, device=None):
    """(n, sharded CSR with a leading [num_shards] axis) on ``device``."""
    dev = resolve_device(device)
    n, avg, alpha = DATASETS[name]
    indptr, indices = make_powerlaw_graph(n, avg, alpha, seed)
    return n, shard_csr(indptr, indices, num_shards, device=dev)
