"""Plain torch version of the delta_route kernel: ``core.delta``'s
``route_segments``, the function behind ``route_by_owner``."""
from __future__ import annotations

import torch

from repro_torch.core.delta import PAD_KEY, route_segments


def delta_route_ref(keys: torch.Tensor, payload: torch.Tensor,
                    ann: torch.Tensor, owners: torch.Tensor, num_shards: int,
                    per_shard_capacity: int):
    """Same contract as ``ops.delta_route``: returns (keys', payload',
    ann' int8, per_owner int32[S]); validity from ``keys != PAD_KEY``."""
    return route_segments(keys, payload, ann, keys != PAD_KEY, owners,
                          num_shards, per_shard_capacity)
