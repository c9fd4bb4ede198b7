"""Public op: stable per-owner bucketing through the delta_route kernel.

On a CUDA tensor :func:`delta_route` launches the kernel
(``csrc/delta_route.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).  :func:`route_deltas` wraps it for a ``DeltaBuffer``;
validity comes from ``keys != PAD_KEY``.
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import PAD_KEY, DeltaBuffer, _segmented
from repro_torch.kernels.delta_route.ref import delta_route_ref

TILE = 1024          # deltas per tile (csrc/delta_route.cu kTile)
MAX_SHARDS = 12288   # per-owner counters in 48 KB of shared memory

launches = 0         # kernel launches since the last reset


def delta_route(keys: torch.Tensor, payload: torch.Tensor, ann: torch.Tensor,
                owners: torch.Tensor, num_shards: int,
                per_shard_capacity: int):
    """keys int32[C] (-1 = padding); payload f32[C, W]; ann int8[C]; owners
    int32[C] (out-of-range = dropped).  Returns (keys', payload', ann',
    per_owner int32[S]): segment s holds owner-s deltas in stable input
    order, ``per_owner`` counts each owner's live deltas."""
    if not keys.is_cuda:
        return delta_route_ref(keys, payload, ann, owners, num_shards,
                               per_shard_capacity)
    if num_shards > MAX_SHARDS:
        raise ValueError(f"delta_route kernel takes at most {MAX_SHARDS} "
                         f"shards, got {num_shards}")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    dev = keys.device
    C, W = payload.shape
    S, cap = num_shards, per_shard_capacity
    ntiles = max(1, -(-C // TILE))
    i32 = dict(dtype=torch.int32, device=dev)
    tile_hist = torch.empty((S * ntiles,), **i32)
    tile_off = torch.empty((S * ntiles,), **i32)
    out_keys = torch.empty((S * cap,), **i32)
    out_payload = torch.empty((S * cap, W), dtype=torch.float32, device=dev)
    out_ann = torch.empty((S * cap,), dtype=torch.int8, device=dev)
    per_owner = torch.empty((S,), **i32)
    p = _build.ptr
    err = lib.delta_route(
        p(keys, torch.int32, "keys"), p(payload, torch.float32, "payload"),
        p(ann, torch.int8, "ann"), p(owners, torch.int32, "owners"),
        C, W, S, cap, tile_hist.data_ptr(), tile_off.data_ptr(),
        out_keys.data_ptr(), out_payload.data_ptr(), out_ann.data_ptr(),
        per_owner.data_ptr(), _build.stream_of(keys))
    _build.check(err, "delta_route")
    launches += 1
    return out_keys, out_payload, out_ann, per_owner


def route_deltas(db: DeltaBuffer, owners: torch.Tensor, num_shards: int,
                 per_shard_capacity: int) -> DeltaBuffer:
    """Bucket ``db`` into per-owner segments (route_by_owner layout)."""
    owners = torch.where(db.keys != PAD_KEY, owners, num_shards)
    keys, payload, ann, per_owner = delta_route(
        db.keys.contiguous(), db.payload.contiguous(), db.ann.contiguous(),
        owners, num_shards, per_shard_capacity)
    return _segmented(keys, payload, ann, per_owner, db.overflowed,
                      per_shard_capacity)
