"""Versioned base-data stores for materialized views.

A store owns the host-side authoritative copy of a view's *immutable* set
(the paper's base data) and absorbs sealed mutation batches, reporting to
the repair rules exactly what changed (:class:`GraphBatchEffect` /
:class:`PointBatchEffect`).  Device tensors are rebuilt with **pinned
capacities**, so every refresh hands the engine the same shapes.

``GraphStore`` keeps the edge relation as a multiset (parallel src/dst
arrays plus a sorted-code index for O(log E) membership); ``PointStore``
keeps a fixed-capacity slot array with a validity mask (dead slots are
masked out of the k-means strata, never reshaped away).  Both stay numpy
on the host; ``build_sharded(device)`` makes the tensors.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np
import torch

from repro_torch.data.graphs import (CSRGraph, csr_to_edges, edges_to_csr,
                                     shard_csr)
from repro_torch.incremental.mutations import (EdgeDelete, EdgeInsert,
                                               EdgeReweight, Mutation,
                                               PointInsert, PointRemove)


@dataclasses.dataclass(frozen=True)
class GraphBatchEffect:
    """What one sealed batch did to the edge relation.

    ``changed_src`` lists every source whose out-edge set changed, with its
    pre/post out-degree (multiplicity-counted) aligned by position.
    ``old_edges`` / ``new_edges`` are the FULL (src, dst) edge lists of the
    changed sources before/after the batch — exactly what the PageRank
    rank-redistribution rule needs.  ``inserted`` / ``deleted`` are the raw
    per-occurrence edge arrays for the monotone/closure rules.
    """

    inserted: tuple[np.ndarray, np.ndarray]
    deleted: tuple[np.ndarray, np.ndarray]
    changed_src: np.ndarray
    old_deg: np.ndarray
    new_deg: np.ndarray
    old_edges: tuple[np.ndarray, np.ndarray]
    new_edges: tuple[np.ndarray, np.ndarray]

    @property
    def size(self) -> int:
        return len(self.inserted[0]) + len(self.deleted[0])


@dataclasses.dataclass(frozen=True)
class PointBatchEffect:
    """Slot-level effect of a point batch: arrays aligned per occurrence."""

    inserted_slots: np.ndarray
    inserted_points: np.ndarray     # f32[n_ins, 2]
    removed_slots: np.ndarray
    removed_points: np.ndarray      # f32[n_rem, 2]

    @property
    def size(self) -> int:
        return len(self.inserted_slots) + len(self.removed_slots)


class GraphStore:
    """Mutable edge multiset over a fixed vertex set [0, n).

    The sharded CSR is rebuilt per refresh with a pinned per-shard
    ``nnz_capacity`` (initial max shard load × ``headroom``); if a batch
    overflows the pin, capacity doubles and the view rebinds its rule once:
    growth is amortized, shrink never rebinds.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n: int,
                 num_shards: int, headroom: float = 2.0):
        src, dst = csr_to_edges(np.asarray(indptr), np.asarray(indices))
        self.n = int(n)
        self.num_shards = int(num_shards)
        self._src = src.astype(np.int64)
        self._dst = dst.astype(np.int64)
        self._reindex()
        self.nnz_capacity = max(int(self._max_shard_nnz() * headroom), 1)

    # ---- construction helpers -------------------------------------------
    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n: int,
                   num_shards: int, headroom: float = 2.0) -> "GraphStore":
        indptr, indices = edges_to_csr(np.asarray(src), np.asarray(dst), n)
        return cls(indptr, indices, n, num_shards, headroom)

    def _reindex(self):
        codes = self._src * self.n + self._dst
        self._order = np.argsort(codes, kind="stable")
        self._sorted_codes = codes[self._order]

    def _reindex_after(self, keep: np.ndarray, ins_codes: np.ndarray):
        """:meth:`_reindex` after dropping the edges ``keep`` is False at
        and appending ``ins_codes`` (sorted): the same stable order, by
        merging instead of sorting again.  Kept edges keep their relative
        order and appended ones come last, so among equal codes the kept
        ones go first, as a stable sort puts them."""
        kept = keep[self._order]
        new_pos = np.cumsum(keep) - 1
        order = new_pos[self._order[kept]]
        sorted_codes = self._sorted_codes[kept]
        at = np.searchsorted(sorted_codes, ins_codes, "right")
        self._order = np.insert(order, at, len(order) + np.arange(
            len(ins_codes), dtype=order.dtype))
        self._sorted_codes = np.insert(sorted_codes, at, ins_codes)

    def _max_shard_nnz(self) -> int:
        block = -(-self.n // self.num_shards)
        shard_of_src = self._src // block
        counts = np.bincount(shard_of_src, minlength=self.num_shards)
        return int(counts.max()) if len(counts) else 0

    # ---- queries ---------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return len(self._src)

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Current (src, dst) arrays — shared, do not mutate."""
        return self._src, self._dst

    def multiplicity(self, u: int, v: int) -> int:
        c = u * self.n + v
        lo = np.searchsorted(self._sorted_codes, c, "left")
        hi = np.searchsorted(self._sorted_codes, c, "right")
        return int(hi - lo)

    def out_degree_of(self, sources: np.ndarray) -> np.ndarray:
        sources = np.asarray(sources, np.int64)
        lo = np.searchsorted(self._sorted_codes, sources * self.n, "left")
        hi = np.searchsorted(self._sorted_codes, (sources + 1) * self.n,
                             "left")
        return (hi - lo).astype(np.int64)

    def edges_of(self, sources: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (src, dst) occurrences whose source is in ``sources``, source
        by source in the given order, each source's in code order."""
        sources = np.asarray(sources, np.int64)
        lo = np.searchsorted(self._sorted_codes, sources * self.n, "left")
        hi = np.searchsorted(self._sorted_codes, (sources + 1) * self.n,
                             "left")
        pos = self._order[_ranges(lo, hi)]
        return self._src[pos], self._dst[pos]

    # ---- mutation --------------------------------------------------------
    def apply_batch(self, mutations: Sequence[Mutation]) -> GraphBatchEffect:
        # Walk the batch in order, accumulating each edge's multiplicity
        # delta relative to the base store; sequential validity (a delete
        # may consume an insert earlier in the same batch, never a later
        # one) falls out of the running count.  The NET delta is what the
        # store applies and what the repair rules see.
        net: dict[int, int] = {}
        for m in mutations:
            if isinstance(m, (EdgeInsert, EdgeDelete, EdgeReweight)):
                self._check_vertex(m.u, m.v)
                code = m.u * self.n + m.v
            else:
                raise TypeError(
                    f"GraphStore cannot apply {type(m).__name__}")
            if isinstance(m, EdgeInsert):
                net[code] = net.get(code, 0) + 1
            elif isinstance(m, EdgeDelete):
                if self.multiplicity(m.u, m.v) + net.get(code, 0) <= 0:
                    raise KeyError(
                        f"delete of edge ({m.u}, {m.v}): no occurrence "
                        f"present at this point in the batch")
                net[code] = net.get(code, 0) - 1
            else:
                if m.multiplicity < 0:
                    raise ValueError("multiplicity must be >= 0")
                cur = self.multiplicity(m.u, m.v) + net.get(code, 0)
                net[code] = net.get(code, 0) + (m.multiplicity - cur)

        codes = np.fromiter(net.keys(), np.int64, len(net))
        counts = np.fromiter(net.values(), np.int64, len(net))
        ins_codes = np.sort(np.repeat(codes[counts > 0],
                                      counts[counts > 0]))
        del_codes = np.sort(np.repeat(codes[counts < 0],
                                      -counts[counts < 0]))
        ins = (ins_codes // self.n, ins_codes % self.n)
        dele = (del_codes // self.n, del_codes % self.n)
        changed = np.unique(np.concatenate([ins[0], dele[0]]))
        old_deg = self.out_degree_of(changed)
        old_edges = self.edges_of(changed)

        # Locate one stored occurrence per delete (grouped by code so that
        # duplicate deletes of the same edge consume successive slots).
        keep = np.ones(len(self._src), bool)
        if len(dele[0]):
            uniq, counts = np.unique(del_codes, return_counts=True)
            lo = np.searchsorted(self._sorted_codes, uniq, "left")
            hi = np.searchsorted(self._sorted_codes, uniq, "right")
            short = np.flatnonzero(hi - lo < counts)
            if len(short):
                c, m = int(uniq[short[0]]), int(counts[short[0]])
                u, v = divmod(c, self.n)
                raise KeyError(
                    f"delete of edge ({u}, {v}) x{m}: only "
                    f"{int(hi[short[0]] - lo[short[0]])} occurrence(s) "
                    f"present")
            keep[self._order[_ranges(lo, lo + counts)]] = False
            self._src = self._src[keep]
            self._dst = self._dst[keep]
        if len(ins[0]):
            self._src = np.concatenate([self._src, ins[0]])
            self._dst = np.concatenate([self._dst, ins[1]])
        self._reindex_after(keep, ins_codes)

        return GraphBatchEffect(
            inserted=ins, deleted=dele, changed_src=changed,
            old_deg=old_deg, new_deg=self.out_degree_of(changed),
            old_edges=old_edges, new_edges=self.edges_of(changed))

    def _check_vertex(self, *vs: int):
        for v in vs:
            if not (0 <= v < self.n):
                raise IndexError(f"vertex {v} outside [0, {self.n})")

    # ---- device view -----------------------------------------------------
    def build_sharded(self, device) -> CSRGraph:
        """Sharded CSR on ``device`` with the pinned capacity; doubles the
        pin (the caller then rebinds) when a growth batch overflows it."""
        indptr, indices = edges_to_csr(self._src, self._dst, self.n)
        while True:
            try:
                return shard_csr(indptr, indices, self.num_shards,
                                 nnz_capacity=self.nnz_capacity,
                                 device=device)
            except ValueError:
                self.nnz_capacity *= 2

    # ---- journal snapshot ------------------------------------------------
    def to_arrays(self) -> dict:
        return {"src": self._src, "dst": self._dst,
                "n": np.asarray(self.n), "num_shards":
                np.asarray(self.num_shards),
                "nnz_capacity": np.asarray(self.nnz_capacity)}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "GraphStore":
        store = cls.from_edges(np.asarray(arrays["src"]),
                               np.asarray(arrays["dst"]),
                               int(arrays["n"]), int(arrays["num_shards"]))
        store.nnz_capacity = int(arrays["nnz_capacity"])
        return store


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The concatenation of ``arange(lo[i], hi[i])`` over i, int64."""
    lengths = (hi - lo).astype(np.int64)
    total = int(lengths.sum())
    if not total:
        return np.zeros(0, np.int64)
    starts = np.cumsum(lengths) - lengths
    return (np.repeat(lo.astype(np.int64) - starts, lengths)
            + np.arange(total, dtype=np.int64))


class PointStore:
    """Fixed-capacity 2-D point set with a validity mask (k-means views).

    ``capacity`` is padded to ``num_shards`` equal blocks; slot ids are
    global indices into the flattened [capacity] array.  Inserts take the
    lowest free slot (deterministic for journal replay).  The store finds
    it without scanning the mask: every free slot is either in a min-heap
    of freed slots or at or above the high-water mark (one past the last
    slot ever taken).
    """

    def __init__(self, points: np.ndarray, num_shards: int,
                 capacity: int | None = None):
        points = np.asarray(points, np.float32).reshape(-1, 2)
        n = len(points)
        if capacity is None:
            capacity = 2 * n
        block = -(-capacity // num_shards)
        self.capacity = block * num_shards
        self.block = block
        self.num_shards = int(num_shards)
        self._points = np.zeros((self.capacity, 2), np.float32)
        self._points[:n] = points
        self._valid = np.zeros(self.capacity, bool)
        self._valid[:n] = True
        self._index_free()

    def _index_free(self) -> None:
        """The free-slot index of the mask: the heap and the high-water
        mark."""
        taken = np.flatnonzero(self._valid)
        self._high = int(taken[-1]) + 1 if len(taken) else 0
        self._free = np.flatnonzero(~self._valid[:self._high]).tolist()
        heapq.heapify(self._free)

    @property
    def n_points(self) -> int:
        return int(self._valid.sum())

    def point(self, slot: int) -> np.ndarray:
        return self._points[slot]

    def is_valid(self, slot: int) -> bool:
        return bool(self._valid[slot])

    def apply_batch(self, mutations: Sequence[Mutation]) -> PointBatchEffect:
        # Stage the batch's writes and take slots from a copy of the free
        # index; commit at the end: a mid-batch error (bad slot, store
        # full) must leave the store untouched so the caller can drop or
        # fix the batch without losing atomicity.
        staged_valid: dict[int, bool] = {}
        staged_points: dict[int, tuple[float, float]] = {}
        free = list(self._free)
        high = self._high
        ins_slots: list[int] = []
        ins_pts: list[tuple[float, float]] = []
        rem_slots: list[int] = []
        rem_pts: list[np.ndarray] = []
        live_in_batch: dict[int, int] = {}   # slot -> index into ins_slots

        def valid(slot: int) -> bool:
            return staged_valid.get(slot, bool(self._valid[slot]))

        for m in mutations:
            if isinstance(m, PointInsert):
                if free:
                    slot = heapq.heappop(free)
                elif high < self.capacity:
                    slot, high = high, high + 1
                else:
                    raise OverflowError("PointStore is full")
                staged_points[slot] = (m.x, m.y)
                staged_valid[slot] = True
                live_in_batch[slot] = len(ins_slots)
                ins_slots.append(slot)
                ins_pts.append((m.x, m.y))
            elif isinstance(m, PointRemove):
                if not (0 <= m.slot < self.capacity) or not valid(m.slot):
                    raise KeyError(f"slot {m.slot} is not occupied")
                staged_valid[m.slot] = False
                heapq.heappush(free, m.slot)
                if m.slot in live_in_batch:
                    # Inserted earlier in this batch: the point never
                    # crosses a refresh boundary — cancel the pair so the
                    # repair rule never retracts a not-yet-granted slot.
                    i = live_in_batch.pop(m.slot)
                    ins_slots[i] = -1
                else:
                    rem_slots.append(m.slot)
                    rem_pts.append(self._points[m.slot].copy())
            else:
                raise TypeError(
                    f"PointStore cannot apply {type(m).__name__}")
        for slot, xy in staged_points.items():
            self._points[slot] = xy
        for slot, ok in staged_valid.items():
            self._valid[slot] = ok
        self._free, self._high = free, high
        keep = [i for i, s in enumerate(ins_slots) if s >= 0]
        return PointBatchEffect(
            inserted_slots=np.asarray([ins_slots[i] for i in keep],
                                      np.int64),
            inserted_points=np.asarray([ins_pts[i] for i in keep],
                                       np.float32).reshape(-1, 2),
            removed_slots=np.asarray(rem_slots, np.int64),
            removed_points=np.asarray(rem_pts, np.float32).reshape(-1, 2))

    # ---- device view -----------------------------------------------------
    def build_sharded(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(points f32[S, block, 2], valid bool[S, block]) on ``device``,
        copies of the store's arrays — static shapes."""
        pts = torch.from_numpy(
            self._points.reshape(self.num_shards, self.block, 2))
        valid = torch.from_numpy(
            self._valid.reshape(self.num_shards, self.block))
        return pts.to(device, copy=True), valid.to(device, copy=True)

    # ---- journal snapshot ------------------------------------------------
    def to_arrays(self) -> dict:
        return {"points": self._points, "valid": self._valid,
                "num_shards": np.asarray(self.num_shards),
                "capacity": np.asarray(self.capacity)}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "PointStore":
        store = cls.__new__(cls)
        # copy: checkpoint-loaded arrays may be read-only views
        store._points = np.array(arrays["points"], np.float32)
        store._valid = np.array(arrays["valid"], bool)
        store.num_shards = int(arrays["num_shards"])
        store.capacity = int(arrays["capacity"])
        store.block = store.capacity // store.num_shards
        store._index_free()
        return store
