"""Elastic re-scaling: partition re-snapshot + state migration.

Paper §4.1: every query carries a partition snapshot; when the node set
changes (failure recovery, scale-up/down), a NEW snapshot is taken and
data is routed according to it from then on.  Here ``remap_state`` moves
the dense keyed mutable set from an S₁-shard layout to an S₂-shard layout
(the all-to-all a real cluster would run), preserving key→value contents
exactly, and ``migrate_route_buffers`` re-routes in-flight delta buffers
through the engine's own ``combine_route`` under the new snapshot.

``reshard_tree`` re-commits a tree of tensors or DTensors onto a new
``DeviceMesh`` with the placements of a spec function's specs (the
training-side elastic move): every leaf's whole value is gathered from its
old mesh and each rank keeps its block on the new one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import PAD_KEY, DeltaBuffer, combine_route
from repro_torch.core.partition import (PartitionSnapshot, shard_dense_state,
                                        unshard_dense_state)


def remap_state(old: PartitionSnapshot, new: PartitionSnapshot,
                state_sharded: torch.Tensor) -> torch.Tensor:
    """[S1, block1, ...] -> [S2, block2, ...] preserving global keys.

    The flatten→reshape is the logical effect of the migration
    all-to-all: every key lands on its new owner."""
    flat = unshard_dense_state(old, state_sharded)
    return shard_dense_state(new, flat)


def grow(snapshot: PartitionSnapshot, new_num_shards: int,
         *state_arrays):
    """Re-snapshot to ``new_num_shards`` and migrate every state array."""
    new_snap = snapshot.resnapshot(new_num_shards)
    return new_snap, tuple(remap_state(snapshot, new_snap, s)
                           for s in state_arrays)


def migrate_route_buffers(new: PartitionSnapshot, entries,
                          payload_width: int,
                          combiner: str = "replace") -> DeltaBuffer:
    """Re-route in-flight delta buffers under a NEW partition snapshot.

    ``entries`` is a chronologically ordered iterable of ``(keys,
    payload)`` host arrays with GLOBAL keys (e.g. a replica chain's
    changed-entry buffers accumulated under the old snapshot).  They are
    concatenated in order and pushed through ``core.delta.combine_route``
    (torch ops, on the host) under the new snapshot, so each new owner
    receives exactly the entries it now owns, grouped into its segment.
    The default ``"replace"`` combiner keeps the chronologically LAST value
    per key (``combine_route``'s stable last-writer rule): the chain-replay
    semantics, so new shard s's segment applied over the migrated baseline
    reproduces the pre-migration state of every key s now owns.

    Returns a segmented DeltaBuffer with ``new.num_shards`` segments of
    ``new.block_size`` slots (an owner receives at most one entry per key
    it owns, so no segment overflows).
    """
    keys_list, payload_list = [], []
    for keys, payload in entries:
        keys = np.asarray(keys, np.int32).reshape(-1)
        keys_list.append(keys)
        payload_list.append(np.asarray(payload, np.float32).reshape(
            len(keys), payload_width))
    n = sum(len(k) for k in keys_list)
    if n == 0:
        return DeltaBuffer.empty(new.num_shards * new.block_size,
                                 payload_width, device="cpu")
    keys = torch.from_numpy(np.concatenate(keys_list))
    db = DeltaBuffer(
        keys=keys, payload=torch.from_numpy(np.concatenate(payload_list)),
        ann=torch.zeros((n,), dtype=torch.int8),
        count=torch.tensor(n, dtype=torch.int32),
        overflowed=torch.zeros((), dtype=torch.bool))
    return combine_route(db, new.owner_of(keys), new.num_shards,
                         new.block_size, combiner=combiner)


def apply_route_buffer(routed: DeltaBuffer, new: PartitionSnapshot,
                       shard: int, block: np.ndarray) -> np.ndarray:
    """Fold new-shard ``shard``'s segment of a migrated route buffer into
    its dense mutable block (host-side replace of the live rows)."""
    seg = new.block_size
    keys = routed.keys[shard * seg:(shard + 1) * seg].cpu()
    payload = routed.payload[shard * seg:(shard + 1) * seg].cpu().numpy()
    live = keys != PAD_KEY
    local = new.local_index(keys[live]).numpy()
    out = np.array(block, copy=True)
    out[local] = payload[live.numpy()]
    return out


def reshard_tree(tree, mesh, spec_fn):
    """Re-commit a tree (dicts, lists, tuples) of tensors or DTensors onto
    ``mesh`` with the placements of ``spec_fn(tree, mesh)`` (a tree of
    ``launch.sharding.P`` of the same structure): the training-side
    elastic move (new device set => new mesh => the same values in a new
    layout).  Returns a tree of DTensors whose whole values are the old
    ones, bit for bit."""
    from repro_torch.launch import sharding
    specs = spec_fn(tree, mesh)

    def move(_, t, spec):
        return sharding.distribute(sharding.full(t), mesh,
                                   sharding.placements(spec, mesh))
    return sharding.walk(tree, move, specs)
