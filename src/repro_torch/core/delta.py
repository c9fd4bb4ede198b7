"""Delta representation for the REX engine (PyTorch).

The paper (§3.3) defines a delta as a pair ``(α, t)``: an annotation α plus
a tuple t, where α ∈ {+(), −(), →(t'), δ(E)}.  A Δᵢ set is a
*fixed-capacity delta buffer*: parallel tensors of keys, payloads and
annotations with a live ``count``.  Slots ≥ count are padding
(key = ``PAD_KEY``) and are ignored by every consumer.

When a stratum would emit more than ``capacity`` deltas, the producer sets
``overflowed`` and the fixpoint loop runs that stratum densely instead.

Types are pinned: keys int32, ann int8, payload float32, count int32.
Torch reductions and ``searchsorted`` return int64 by default, so every
such result is cast back to int32 here; the byte accounting
(``bytes_per_delta=8``) and overflow behaviour depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Annotation codes (paper §3.3, Definition 1).
ANN_INSERT = 0   # +()    : insert tuple
ANN_DELETE = 1   # -()    : delete tuple
ANN_REPLACE = 2  # ->(t') : replace tuple
ANN_ADJUST = 3   # δ(E)   : user-interpreted adjustment (handler-defined)

PAD_KEY = -1
INT32_MAX = 2 ** 31 - 1

_REDUCE = {"min": "amin", "max": "amax"}


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _scatter_minmax(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    how: str) -> torch.Tensor:
    """``base.at[idx].min/max(vals)`` along dim 0 (idx in range)."""
    idx = idx.long()
    if base.dim() == 2:
        idx = idx[:, None].expand(-1, base.shape[1])
    return base.scatter_reduce_(0, idx, vals, _REDUCE[how], include_self=True)


def _last_writer_mask(addr: torch.Tensor, valid: torch.Tensor, size: int
                      ) -> torch.Tensor:
    """True at the LAST valid slot scattering to each address in
    ``[0, size)`` (stable slot order).  A duplicate-index set has no fixed
    winner in torch, so every replace-combining path selects its single
    writer through this mask."""
    iota = torch.arange(addr.shape[0], dtype=torch.int32, device=addr.device)
    win = _scatter_minmax(
        torch.full((size,), -1, dtype=torch.int32, device=addr.device),
        addr, torch.where(valid, iota, -1), "max")
    return valid & (win[addr.clamp(0, size - 1).long()] == iota)


@dataclasses.dataclass(frozen=True)
class DeltaBuffer:
    """Fixed-capacity Δ set: (keys, payload, annotation, count, overflowed).

    keys:       int32[C]      target key of each delta (PAD_KEY when unused)
    payload:    float32[C, P] handler-interpreted value(s)
    ann:        int8[C]       annotation code per delta
    count:      int32[]       number of live slots (<= C)
    overflowed: bool[]        producer wanted to emit > C deltas

    The engine also stacks buffers along a leading shard axis ([S, C]).
    """

    keys: torch.Tensor
    payload: torch.Tensor
    ann: torch.Tensor
    count: torch.Tensor
    overflowed: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    @property
    def payload_width(self) -> int:
        return self.payload.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.count

    @staticmethod
    def empty(capacity: int, payload_width: int = 1, *,
              device) -> "DeltaBuffer":
        return DeltaBuffer(
            keys=torch.full((capacity,), PAD_KEY, dtype=torch.int32,
                            device=device),
            payload=torch.zeros((capacity, payload_width),
                                dtype=torch.float32, device=device),
            ann=torch.zeros((capacity,), dtype=torch.int8, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            overflowed=torch.zeros((), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_dense_mask(mask: torch.Tensor, keys: torch.Tensor,
                        payload: torch.Tensor, capacity: int,
                        ann_code: int = ANN_ADJUST,
                        ann: Optional[torch.Tensor] = None) -> "DeltaBuffer":
        """Compact (mask, keys, payload) into a delta buffer of ``capacity``.

        Keeps ascending positions.  Sets ``overflowed`` if the number of
        true entries exceeds capacity (excess deltas are DROPPED: callers
        must honour ``overflowed`` and redo the stratum densely).  ``ann``
        (int8[N], optional) carries per-delta codes through the compaction;
        without it every slot is stamped ``ann_code``.
        """
        dev = mask.device
        m32 = mask.to(torch.int32)
        total = _i32(m32.sum())
        pos = _i32(torch.cumsum(m32, 0)) - 1
        slot = torch.where(mask & (pos < capacity), pos, capacity).long()
        out_keys = torch.full((capacity + 1,), PAD_KEY, dtype=torch.int32,
                              device=dev)
        out_keys[slot] = keys.to(torch.int32)
        out_payload = torch.zeros((capacity + 1, payload.shape[1]),
                                  dtype=payload.dtype, device=dev)
        out_payload[slot] = payload
        out_ann = torch.full((capacity + 1,), ann_code, dtype=torch.int8,
                             device=dev)
        if ann is not None:
            out_ann[slot] = ann.to(torch.int8)
        return DeltaBuffer(
            keys=out_keys[:capacity], payload=out_payload[:capacity],
            ann=out_ann[:capacity],
            count=torch.clamp(total, max=capacity),
            overflowed=total > capacity)

    def to_dense(self, n_keys: int, combiner: str = "add") -> torch.Tensor:
        """Materialize payload column 0 as a dense vector of size n_keys.

        Uses key occupancy, so it is valid for compacted and for
        segment-strided (post-rehash) buffers.  For ``"replace"`` the LAST
        live slot of each key wins (stable slot order)."""
        mask = self.keys != PAD_KEY
        keys = torch.where(mask, self.keys, n_keys)
        col = self.payload[:, 0]
        dt, dev = self.payload.dtype, self.device
        if combiner == "add":
            out = torch.zeros((n_keys + 1,), dtype=dt, device=dev).index_add_(
                0, keys, torch.where(mask, col, 0.0))
        elif combiner in ("min", "max"):
            fill = float("inf") if combiner == "min" else float("-inf")
            out = _scatter_minmax(
                torch.full((n_keys + 1,), fill, dtype=dt, device=dev), keys,
                torch.where(mask, col, fill), combiner)
        elif combiner == "replace":
            is_winner = _last_writer_mask(keys, mask, n_keys + 1)
            out = torch.zeros((n_keys + 1,), dtype=dt, device=dev).index_add_(
                0, keys, torch.where(is_winner, col, 0.0))
        else:
            raise ValueError(f"unknown combiner {combiner!r}")
        return out[:n_keys]


def concat(a: DeltaBuffer, b: DeltaBuffer, capacity: Optional[int] = None
           ) -> DeltaBuffer:
    """Concatenate two delta buffers; annotation codes travel with their
    deltas."""
    cap = capacity if capacity is not None else a.capacity + b.capacity
    keys = torch.cat([a.keys, b.keys])
    out = DeltaBuffer.from_dense_mask(
        keys != PAD_KEY, keys, torch.cat([a.payload, b.payload]), cap,
        ann=torch.cat([a.ann, b.ann]))
    return dataclasses.replace(
        out, overflowed=out.overflowed | a.overflowed | b.overflowed)


def _place(total_cap: int, slot: torch.Tensor, keys: torch.Tensor,
           payload: torch.Tensor, ann) -> tuple:
    """Write (keys, payload, ann) at ``slot`` into size+1 buffers (slot
    ``total_cap`` is the drop sentinel) and cut the sentinel off."""
    dev = keys.device
    slot = slot.long()
    out_keys = torch.full((total_cap + 1,), PAD_KEY, dtype=torch.int32,
                          device=dev)
    out_keys[slot] = keys
    out_payload = torch.zeros((total_cap + 1, payload.shape[1]),
                              dtype=payload.dtype, device=dev)
    out_payload[slot] = payload
    out_ann = torch.zeros((total_cap + 1,), dtype=torch.int8, device=dev)
    out_ann[slot] = ann
    return out_keys[:total_cap], out_payload[:total_cap], out_ann[:total_cap]


def _segmented(keys: torch.Tensor, payload: torch.Tensor, ann: torch.Tensor,
               per_owner: torch.Tensor, overflowed: torch.Tensor,
               per_shard_capacity: int) -> DeltaBuffer:
    """A routed buffer: count and overflow from the per-owner totals."""
    return DeltaBuffer(
        keys=keys, payload=payload, ann=ann,
        count=_i32(torch.clamp(per_owner, max=per_shard_capacity).sum()),
        overflowed=overflowed | torch.any(per_owner > per_shard_capacity))


def route_segments(keys: torch.Tensor, payload: torch.Tensor,
                   ann: torch.Tensor, live: torch.Tensor, owners: torch.Tensor,
                   num_shards: int, per_shard_capacity: int) -> tuple:
    """Stable per-owner bucketing of raw tensors.

    Slot i, if ``live`` and its owner is in ``[0, num_shards)``, goes to
    ``owner * cap + rank``, rank counting the earlier such slots of the same
    owner (input order); ranks ``>= cap`` are dropped.  Returns (keys',
    payload', ann' int8, per_owner int32[S] live slots per owner).  This is
    the plain version of the ``delta_route`` kernel.
    """
    dev = keys.device
    C = keys.shape[0]
    S, cap = num_shards, per_shard_capacity
    live = live & (owners >= 0) & (owners < S)
    own_s = torch.where(live, owners, S)
    order = torch.argsort(own_s, stable=True)
    sorted_own = own_s[order]
    pos = torch.arange(C, dtype=torch.int32, device=dev)
    group_start = _scatter_minmax(
        torch.full((S + 1,), C, dtype=torch.int32, device=dev), sorted_own,
        pos, "min")
    rank = torch.empty_like(pos)
    rank[order] = pos - group_start[sorted_own.long()]
    slot = torch.where(live & (rank < cap), own_s * cap + rank, S * cap)
    per_owner = torch.zeros((S + 1,), dtype=torch.int32, device=dev
                            ).index_add_(0, own_s, live.to(torch.int32))[:S]
    return (*_place(S * cap, slot, keys, payload, ann.to(torch.int8)),
            per_owner)


def route_by_owner(db: DeltaBuffer, owners: torch.Tensor, num_shards: int,
                   per_shard_capacity: int) -> DeltaBuffer:
    """Group deltas by destination shard into equal-size segments.

    The local half of the paper's ``rehash``: ``num_shards`` contiguous
    segments of ``per_shard_capacity`` slots, segment s holding the deltas
    owned by shard s in stable input order.  Validity comes from ``count``.
    """
    keys, payload, ann, per_owner = route_segments(
        db.keys, db.payload, db.ann, db.valid_mask(), owners, num_shards,
        per_shard_capacity)
    return _segmented(keys, payload, ann, per_owner, db.overflowed,
                      per_shard_capacity)


def combine_route(db: DeltaBuffer, owners: torch.Tensor, num_shards: int,
                  per_shard_capacity: int, combiner: str = "add"
                  ) -> DeltaBuffer:
    """Fused sender-side combiner + rehash routing (one sort, not two).

    Semantically ``route_by_owner(pre_aggregate(db, combiner), owners', S,
    cap)``: merge deltas sharing a key, then group the merged deltas into
    per-destination segments.  One stable sort on the composed int64 key
    ``owner << 32 | key`` (torch has no multi-key sort), one segmented
    reduce in sorted order, and placement at ``owner * cap + rank``.
    Validity comes from ``keys != PAD_KEY``.  Merged slots are stamped
    ``ANN_ADJUST``; dead slots carry ann 0.
    """
    dev = db.device
    C = db.capacity
    S = num_shards
    w = db.payload_width
    mask = db.keys != PAD_KEY
    owners = torch.where(mask & (owners >= 0) & (owners < S), owners, S)
    mask = mask & (owners < S)
    sort_keys = torch.where(mask, db.keys, INT32_MAX)
    composed = (owners.long() << 32) | (sort_keys.long() + 2 ** 31)
    _, order = torch.sort(composed, stable=True)
    sowner = owners[order]
    skeys = sort_keys[order]
    spay = db.payload[order]
    change = (sowner[1:] != sowner[:-1]) | (skeys[1:] != skeys[:-1])
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_head = torch.cat([one, change])
    seg_id = _i32(torch.cumsum(is_head.to(torch.int32), 0)) - 1
    if combiner == "add":
        merged = torch.zeros((C, w), dtype=spay.dtype,
                             device=dev).index_add_(0, seg_id, spay)
    elif combiner in ("min", "max"):
        fill = float("inf") if combiner == "min" else float("-inf")
        merged = _scatter_minmax(
            torch.full((C, w), fill, dtype=spay.dtype, device=dev), seg_id,
            spay, combiner)
    elif combiner == "replace":
        # Last (stable order) wins: only each segment's tail writes.
        is_tail = torch.cat([change, one])
        merged = torch.zeros((C, w), dtype=spay.dtype, device=dev).index_add_(
            0, seg_id, torch.where(is_tail[:, None], spay, 0.0))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    seg_ids = torch.arange(C, dtype=torch.int32, device=dev)
    seg_key = _scatter_minmax(torch.zeros((C,), dtype=torch.int32, device=dev),
                              seg_id, skeys, "max")
    # All members of a segment agree on owner and liveness, so a max
    # scatter recovers them without a duplicate-index set.
    seg_owner = torch.full((C,), S, dtype=torch.int32, device=dev)
    seg_owner[seg_id[is_head].long()] = sowner[is_head]
    live_seg = torch.zeros((C,), dtype=torch.bool, device=dev)
    live_seg[seg_id[is_head].long()] = skeys[is_head] != INT32_MAX
    owner_start = _scatter_minmax(
        torch.full((S + 2,), C, dtype=torch.int32, device=dev),
        seg_owner.clamp(0, S + 1), seg_ids, "min")
    rank = seg_ids - owner_start[seg_owner.clamp(0, S + 1).long()]
    valid = (live_seg & (rank < per_shard_capacity)
             & (seg_owner >= 0) & (seg_owner < S))
    total_cap = S * per_shard_capacity
    slot = torch.where(valid, seg_owner * per_shard_capacity + rank,
                       total_cap)
    keys, payload, ann = _place(
        total_cap, slot, seg_key, merged,
        torch.full((C,), ANN_ADJUST, dtype=torch.int8, device=dev))
    per_owner_segs = torch.zeros((S + 1,), dtype=torch.int32,
                                 device=dev).index_add_(
        0, seg_owner.clamp(0, S), live_seg.to(torch.int32))[:S]
    return _segmented(keys, payload, ann, per_owner_segs, db.overflowed,
                      per_shard_capacity)


def combine_route_scatter(db: DeltaBuffer, owners: torch.Tensor,
                          num_shards: int, per_shard_capacity: int,
                          combiner: str = "add", *, snapshot
                          ) -> DeltaBuffer:
    """Sort-free combine + route: scatter into a dense per-key slab.

    Same contract as :func:`combine_route`.  Payloads are combined into a
    slab addressed by the global key, and each owner's slab cells are then
    compacted into its segment by a prefix sum over occupancy, so
    ascending cell order within an owner is ascending key order.
    ``owners`` must agree across slots sharing a key, and live keys lie in
    ``[0, snapshot.padded_keys)``.
    """
    if snapshot.num_shards != num_shards:
        raise ValueError(
            f"snapshot has {snapshot.num_shards} shards, caller asked for "
            f"{num_shards}")
    keys, payload, ann, per_owner = scatter_segments(
        db.keys, db.payload, owners, num_shards, per_shard_capacity,
        combiner, snapshot.padded_keys,
        snapshot.block_size if snapshot.scheme == "block" else None)
    return _segmented(keys, payload, ann, per_owner, db.overflowed,
                      per_shard_capacity)


def scatter_segments(keys: torch.Tensor, payload: torch.Tensor,
                     owners: torch.Tensor, num_shards: int,
                     per_shard_capacity: int, combiner: str, n_keys: int,
                     block_size: Optional[int]) -> tuple:
    """Slab combine + prefix-sum compaction of raw tensors.

    Live keys (not PAD, in ``[0, n_keys)``, owner in range) are combined
    per key in a slab of ``n_keys`` cells; each owner's occupied cells then
    fill its segment in ascending-key order.  ``block_size`` is set under
    the block scheme (owner s holds cells ``[s*B, (s+1)*B)``) and None
    under the hash scheme (a cell's owner comes from ``owners``).  Returns
    (keys', payload', ann' int8, per_owner int32[S] distinct live keys per
    owner).  This is the plain version of the ``scatter_route`` kernel.
    """
    dev = keys.device
    C, w = payload.shape
    S = num_shards
    N = n_keys
    cap = per_shard_capacity
    dt = payload.dtype
    valid = ((keys != PAD_KEY) & (owners >= 0) & (owners < S)
             & (keys >= 0) & (keys < N))
    addr = torch.where(valid, keys, N)

    occ = None
    if combiner == "add":
        # Occupancy rides the payload scatter as an extra column.
        aug = torch.cat([payload,
                         torch.ones((C, 1), dtype=dt, device=dev)], 1)
        slab_aug = torch.zeros((N + 1, w + 1), dtype=dt, device=dev
                               ).index_add_(0, addr,
                                            torch.where(valid[:, None],
                                                        aug, 0.0))
        slab = slab_aug[:, :w]
        occ = (slab_aug[:N, w] > 0).to(torch.int32)
    elif combiner in ("min", "max"):
        fill = float("inf") if combiner == "min" else float("-inf")
        slab = _scatter_minmax(
            torch.full((N + 1, w), fill, dtype=dt, device=dev), addr,
            torch.where(valid[:, None], payload, fill), combiner)
    elif combiner == "replace":
        is_winner = _last_writer_mask(addr, valid, N + 1)
        slab = torch.zeros((N + 1, w), dtype=dt, device=dev).index_add_(
            0, addr, torch.where(is_winner[:, None], payload, 0.0))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    if occ is None:
        occ = torch.zeros((N + 1,), dtype=torch.int32, device=dev).index_add_(
            0, addr, valid.to(torch.int32))[:N]
    slab = slab[:N]
    live_cell = (occ > 0).to(torch.int32)

    # Each output slot (s, r) gathers the (r+1)-th live cell of owner s by
    # binary search over the owner's occupancy prefix sum.  Only
    # min(cap, cells-per-owner) leading slots can ever fill.
    if block_size is not None:
        B = block_size
        capq = min(cap, B)
        cum = _i32(torch.cumsum(live_cell.reshape(S, B), 1))
        per_owner = cum[:, -1]
        limit = B
    else:
        # Hash scheme: a cell's owner is not a function of its position;
        # recover it from the owners array and count with a one-hot
        # prefix sum.
        capq = min(cap, N)
        cell_owner = _scatter_minmax(
            torch.full((N + 1,), S, dtype=torch.int32, device=dev), addr,
            torch.where(valid, owners, S), "min")[:N]
        onehot = ((cell_owner[:, None]
                   == torch.arange(S, dtype=torch.int32, device=dev)[None, :])
                  & (live_cell[:, None] > 0)).to(torch.int32)
        cum = _i32(torch.cumsum(onehot, 0)).T.contiguous()      # [S, N]
        per_owner = cum[:, -1]
        limit = N
    queries = torch.arange(1, capq + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(cum, queries.expand(S, capq).contiguous(),
                             out_int32=True)
    filled = idx < limit                                      # [S, capq]
    if block_size is not None:
        cell = (torch.arange(S, dtype=torch.int32, device=dev)[:, None] * B
                + idx.clamp(max=B - 1))
    else:
        cell = idx.clamp(max=N - 1)
    seg_keys = torch.where(filled, cell, PAD_KEY)
    seg_payload = torch.where(filled[..., None], slab[cell.long()], 0.0)
    seg_ann = torch.where(filled, ANN_ADJUST, 0).to(torch.int8)
    out_keys = torch.full((S, cap), PAD_KEY, dtype=torch.int32, device=dev)
    out_payload = torch.zeros((S, cap, w), dtype=dt, device=dev)
    out_ann = torch.zeros((S, cap), dtype=torch.int8, device=dev)
    out_keys[:, :capq] = seg_keys
    out_payload[:, :capq] = seg_payload
    out_ann[:, :capq] = seg_ann
    return (out_keys.reshape(S * cap), out_payload.reshape(S * cap, w),
            out_ann.reshape(S * cap), per_owner)


def recount(db: DeltaBuffer) -> DeltaBuffer:
    """Recompute ``count`` from PAD_KEY occupancy along the last axis (after
    the segment swap the receiving shard's segments interleave padding with
    live slots, so the transferred count is meaningless)."""
    return dataclasses.replace(
        db, count=_i32((db.keys != PAD_KEY).sum(-1)))


def valid_mask_by_key(db: DeltaBuffer) -> torch.Tensor:
    """Validity from key occupancy (order-independent, post-rehash safe)."""
    return db.keys != PAD_KEY
