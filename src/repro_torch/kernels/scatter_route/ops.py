"""Public op: sort-free combine-route through the scatter_route kernel.

On a CUDA tensor :func:`scatter_route` launches the kernel
(``csrc/scatter_route.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).  :func:`scatter_route_deltas` wraps it for a
``DeltaBuffer`` and matches ``core.delta.combine_route_scatter`` slot for
slot (add-merged payloads to rounding, min/max exactly).  The kernel
combines with add, min and max; ``replace`` and the hash scheme raise on
the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import PAD_KEY, DeltaBuffer, _segmented
from repro_torch.kernels.scatter_route.ref import scatter_route_ref

TILE = 1024          # cells per scan tile (csrc/scatter_route.cu kTile)
OPS = {"add": 0, "min": 1, "max": 2}

launches = 0         # kernel launches since the last reset


def scatter_route(keys: torch.Tensor, payload: torch.Tensor,
                  local: torch.Tensor, owners: torch.Tensor, num_shards: int,
                  block_size: int, per_shard_capacity: int,
                  combiner: str = "add"):
    """keys int32[C] (-1 = padding); payload f32[C, W]; local int32[C]
    (key's index inside its owner block); owners int32[C] (out-of-range =
    dropped).  Returns (keys', payload', ann' int8, per_owner int32[S])."""
    if not keys.is_cuda:
        return scatter_route_ref(keys, payload, local, owners, num_shards,
                                 block_size, per_shard_capacity, combiner)
    if combiner not in OPS:
        raise NotImplementedError(
            f"scatter_route kernel combines with add, min and max, not "
            f"{combiner!r}")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    dev = keys.device
    C, W = payload.shape
    S, B, cap = num_shards, block_size, per_shard_capacity
    ntiles = -(-B // TILE)
    i32 = dict(dtype=torch.int32, device=dev)
    slab = torch.empty((S * B * W,), dtype=torch.float32, device=dev)
    occ = torch.empty((S * B,), **i32)
    tile_cnt = torch.empty((S * ntiles,), **i32)
    tile_off = torch.empty((S * ntiles,), **i32)
    out_keys = torch.empty((S * cap,), **i32)
    out_payload = torch.empty((S * cap, W), dtype=torch.float32, device=dev)
    out_ann = torch.empty((S * cap,), dtype=torch.int8, device=dev)
    per_owner = torch.empty((S,), **i32)
    p = _build.ptr
    err = lib.scatter_route(
        p(keys, torch.int32, "keys"), p(payload, torch.float32, "payload"),
        p(local, torch.int32, "local"), p(owners, torch.int32, "owners"),
        C, W, S, B, cap, OPS[combiner], slab.data_ptr(), occ.data_ptr(),
        tile_cnt.data_ptr(), tile_off.data_ptr(), out_keys.data_ptr(),
        out_payload.data_ptr(), out_ann.data_ptr(), per_owner.data_ptr(),
        _build.stream_of(keys))
    _build.check(err, "scatter_route")
    launches += 1
    return out_keys, out_payload, out_ann, per_owner


def scatter_route_deltas(db: DeltaBuffer, owners: torch.Tensor,
                         num_shards: int, per_shard_capacity: int,
                         combiner: str = "add", *, snapshot) -> DeltaBuffer:
    """Combine + route ``db`` into per-owner segments, sort-free: merged
    per key, segments in ascending-key order, overflowing owners keep their
    smallest keys.  ``owners`` must be a function of the key via
    ``snapshot``."""
    if snapshot.scheme != "block":
        # (owner, local) slab addressing is injective only under the block
        # scheme.
        if db.keys.is_cuda:
            raise NotImplementedError(
                "scatter_route kernel needs the block scheme (the hash "
                "scheme is ROADMAP queue 2)")
        from repro_torch.core.delta import combine_route_scatter
        return combine_route_scatter(db, owners, num_shards,
                                     per_shard_capacity, combiner,
                                     snapshot=snapshot)
    S = num_shards
    owners = torch.where(db.keys != PAD_KEY, owners, S)
    local = snapshot.local_index(db.keys)
    keys, payload, ann, per_owner = scatter_route(
        db.keys.contiguous(), db.payload.contiguous(), local, owners, S,
        snapshot.block_size, per_shard_capacity, combiner)
    return _segmented(keys, payload, ann, per_owner, db.overflowed,
                      per_shard_capacity)
