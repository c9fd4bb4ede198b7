"""Base-data mutations and the versioned mutation log.

The incremental subsystem treats a change to the *immutable* set (the
paper's terminology for base data) as just another delta: an edge insert
is a ``+()`` tuple, a delete a ``−()``, a reweight a ``→(t')``, and the
per-algorithm repair they induce on converged state is a ``δ(E)``
adjustment (see ``incremental/rules/``).  This module defines the host-side
mutation records and the :class:`MutationLog` that batches them between
view refreshes.

Every mutation gets a monotonically increasing sequence number; a refresh
*seals* the pending mutations into a :class:`MutationBatch` stamped with
the view version it produces.  Sealed batches are what the durable journal
(``incremental/journal.py``) persists and what recovery replays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delta import ANN_DELETE, ANN_INSERT, ANN_REPLACE

# Journal encoding ids (payload column 0 of the encoded batch).
KIND_EDGE_INSERT = 0
KIND_EDGE_DELETE = 1
KIND_EDGE_REWEIGHT = 2
KIND_POINT_INSERT = 3
KIND_POINT_REMOVE = 4


@dataclasses.dataclass(frozen=True)
class EdgeInsert:
    """+() on the edge relation: add one (u, v) occurrence (multi-edges
    are meaningful — PageRank mass follows multiplicity)."""

    u: int
    v: int
    kind = KIND_EDGE_INSERT
    ann = ANN_INSERT


@dataclasses.dataclass(frozen=True)
class EdgeDelete:
    """−() on the edge relation: remove one (u, v) occurrence."""

    u: int
    v: int
    kind = KIND_EDGE_DELETE
    ann = ANN_DELETE


@dataclasses.dataclass(frozen=True)
class EdgeReweight:
    """→(t') on the edge relation: set the multiplicity of (u, v).

    The engine's graphs are unweighted; integer multiplicity is the weight
    analogue (PageRank mass is proportional to it).  Lowered to the
    insert/delete difference by the store.
    """

    u: int
    v: int
    multiplicity: int
    kind = KIND_EDGE_REWEIGHT
    ann = ANN_REPLACE


@dataclasses.dataclass(frozen=True)
class PointInsert:
    """+() on the point relation (k-means).  The store assigns the lowest
    free slot deterministically so journal replay is reproducible."""

    x: float
    y: float
    kind = KIND_POINT_INSERT
    ann = ANN_INSERT


@dataclasses.dataclass(frozen=True)
class PointRemove:
    """−() on the point relation: free one occupied slot."""

    slot: int
    kind = KIND_POINT_REMOVE
    ann = ANN_DELETE


Mutation = EdgeInsert | EdgeDelete | EdgeReweight | PointInsert | PointRemove


@dataclasses.dataclass(frozen=True)
class MutationBatch:
    """A sealed group of mutations producing view version ``version``."""

    version: int
    first_seq: int
    mutations: tuple[Mutation, ...]

    def __len__(self) -> int:
        return len(self.mutations)


class MutationLog:
    """Append-only mutation buffer with versioned sealing.

    ``append`` stamps sequence numbers; ``seal`` drains the pending buffer
    into a :class:`MutationBatch` for the given target version.  The log
    keeps sealed batches (bounded by ``history``) so the journal and
    debugging tools can inspect what produced each version.
    """

    def __init__(self, history: int = 64):
        self._pending: list[Mutation] = []
        self._seq = 0
        self._history = history
        self.batches: list[MutationBatch] = []

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def next_seq(self) -> int:
        return self._seq

    def append(self, *mutations: Mutation) -> int:
        """Append mutations; returns the sequence number of the first."""
        first = self._seq
        self._pending.extend(mutations)
        self._seq += len(mutations)
        return first

    def seal(self, version: int) -> MutationBatch:
        batch = MutationBatch(
            version=version,
            first_seq=self._seq - len(self._pending),
            mutations=tuple(self._pending))
        self._pending = []
        self.batches.append(batch)
        if len(self.batches) > self._history:
            self.batches = self.batches[-self._history:]
        return batch

    def unseal(self, batch: MutationBatch) -> None:
        """Undo a just-sealed batch (refresh failed before taking effect):
        its mutations go back to the front of the pending buffer."""
        if self.batches and self.batches[-1] is batch:
            self.batches.pop()
        self._pending = list(batch.mutations) + self._pending


# ---------------------------------------------------------------------------
# Journal encoding: one mutation -> one (key, payload[4]) row, reusing the
# delta-checkpoint wire shape of runtime/checkpoint.py (keys + payloads).
# ---------------------------------------------------------------------------

def encode_batch(batch: MutationBatch) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch as (keys=int64 seq ids, payload=f64[n, 4]) arrays.

    Payload rows are ``[kind, a, b, c]``; float64 carries vertex ids and
    point coordinates exactly.
    """
    n = len(batch.mutations)
    keys = batch.first_seq + np.arange(n, dtype=np.int64)
    payload = np.zeros((n, 4), np.float64)
    for i, m in enumerate(batch.mutations):
        if isinstance(m, EdgeInsert):
            payload[i] = [KIND_EDGE_INSERT, m.u, m.v, 0.0]
        elif isinstance(m, EdgeDelete):
            payload[i] = [KIND_EDGE_DELETE, m.u, m.v, 0.0]
        elif isinstance(m, EdgeReweight):
            payload[i] = [KIND_EDGE_REWEIGHT, m.u, m.v, m.multiplicity]
        elif isinstance(m, PointInsert):
            payload[i] = [KIND_POINT_INSERT, m.x, m.y, 0.0]
        elif isinstance(m, PointRemove):
            payload[i] = [KIND_POINT_REMOVE, m.slot, 0.0, 0.0]
        else:  # pragma: no cover - exhaustive over Mutation
            raise TypeError(type(m))
    return keys, payload


def decode_batch(version: int, keys: np.ndarray, payload: np.ndarray
                 ) -> MutationBatch:
    """Inverse of :func:`encode_batch`."""
    muts: list[Mutation] = []
    for row in np.asarray(payload, np.float64):
        kind = int(row[0])
        if kind == KIND_EDGE_INSERT:
            muts.append(EdgeInsert(int(row[1]), int(row[2])))
        elif kind == KIND_EDGE_DELETE:
            muts.append(EdgeDelete(int(row[1]), int(row[2])))
        elif kind == KIND_EDGE_REWEIGHT:
            muts.append(EdgeReweight(int(row[1]), int(row[2]), int(row[3])))
        elif kind == KIND_POINT_INSERT:
            muts.append(PointInsert(float(row[1]), float(row[2])))
        elif kind == KIND_POINT_REMOVE:
            muts.append(PointRemove(int(row[1])))
        else:
            raise ValueError(f"unknown mutation kind {kind}")
    first = int(keys[0]) if len(keys) else 0
    return MutationBatch(version=version, first_seq=first,
                         mutations=tuple(muts))
