"""Plain torch version of the scatter_route kernel.

Same raw-tensor contract as ``ops.scatter_route`` but supporting every
combiner (add/min/max/replace); the CUDA kernel implements add, min and
max.  The work is ``core.delta.scatter_segments``, the function behind
``combine_route_scatter``.
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import PAD_KEY, scatter_segments


def scatter_route_ref(keys: torch.Tensor, payload: torch.Tensor,
                      local: torch.Tensor, owners: torch.Tensor,
                      num_shards: int, block_size: int,
                      per_shard_capacity: int, combiner: str = "add"):
    """Returns (keys', payload', ann' int8, per_owner int32[S]); the first
    three have ``num_shards * per_shard_capacity`` slots, segment s holding
    owner-s deltas merged per key in ascending-key order (keys rebuilt as
    ``owner * block_size + local``); ``per_owner`` counts each owner's
    distinct live keys."""
    S, B = num_shards, block_size
    live = ((keys != PAD_KEY) & (owners >= 0) & (owners < S)
            & (local >= 0) & (local < B))
    cell = torch.where(live, owners * B + local, PAD_KEY)
    return scatter_segments(cell, payload, owners, S, per_shard_capacity,
                            combiner, S * B, B)
