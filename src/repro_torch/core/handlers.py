"""User-defined aggregators (UDAs) and the sender-side combiner.

The paper (§3.3) defines delta handlers (AGGSTATE, AGGRESULT, join-state and
while-state ``update``); on the device the keyed buckets are dense tensors
indexed by key.  An :class:`Aggregator` carries the optimizer-facing
metadata from §5.2: ``composable`` (can be computed in parts and unioned)
and ``multiply`` (the multiplicative-join compensation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.delta import (ANN_ADJUST, INT32_MAX, PAD_KEY,
                                    DeltaBuffer, _i32, _scatter_minmax)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """A UDA: combiner + optimizer metadata.

    combiner
        One of "add" | "min" | "max" | "replace": the scatter combine used
        by delta application.
    identity
        Neutral element of the combiner (0 for sum, +inf for min, ...).
    """

    name: str
    combiner: str
    identity: float
    composable: bool = True
    multiply: Optional[Callable] = None


def pre_aggregate(db: DeltaBuffer, combiner: str) -> DeltaBuffer:
    """Merge deltas sharing a key (sender-side combiner, §5.2).

    Returns a buffer of the same capacity where each live key appears once,
    in ascending key order, reduced in stable slot order.  ``"replace"``
    keeps the last slot of each key.
    """
    dev = db.device
    cap = db.capacity
    w = db.payload_width
    mask = db.keys != PAD_KEY
    sort_keys = torch.where(mask, db.keys, INT32_MAX)
    order = torch.argsort(sort_keys, stable=True)
    skeys = sort_keys[order]
    spay = db.payload[order]
    change = skeys[1:] != skeys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_head = torch.cat([one, change])
    seg_id = _i32(torch.cumsum(is_head.to(torch.int32), 0)) - 1
    if combiner == "add":
        merged = torch.zeros((cap, w), dtype=spay.dtype,
                             device=dev).index_add_(0, seg_id, spay)
    elif combiner in ("min", "max"):
        fill = float("inf") if combiner == "min" else float("-inf")
        merged = _scatter_minmax(
            torch.full((cap, w), fill, dtype=spay.dtype, device=dev), seg_id,
            spay, combiner)
    elif combiner == "replace":
        is_tail = torch.cat([change, one])
        merged = torch.zeros((cap, w), dtype=spay.dtype, device=dev)
        merged[seg_id[is_tail].long()] = spay[is_tail]
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    uniq_keys = torch.zeros((cap,), dtype=torch.int32, device=dev)
    uniq_keys[seg_id[is_head].long()] = skeys[is_head]
    live_seg = torch.zeros((cap,), dtype=torch.bool, device=dev)
    live_seg[seg_id[is_head].long()] = skeys[is_head] != INT32_MAX
    return DeltaBuffer(
        keys=torch.where(live_seg, uniq_keys, PAD_KEY),
        payload=torch.where(live_seg[:, None], merged, 0.0),
        ann=torch.full((cap,), ANN_ADJUST, dtype=torch.int8, device=dev),
        count=_i32(live_seg.sum()),
        overflowed=db.overflowed)


SUM = Aggregator(name="sum", combiner="add", identity=0.0, composable=True,
                 multiply=lambda payload, n: payload * n)
COUNT = Aggregator(name="count", combiner="add", identity=0.0,
                   composable=True, multiply=lambda payload, n: payload * n)
MIN = Aggregator(name="min", combiner="min", identity=float("inf"),
                 composable=True, multiply=lambda payload, n: payload)
MAX = Aggregator(name="max", combiner="max", identity=float("-inf"),
                 composable=True, multiply=lambda payload, n: payload)
LAST = Aggregator(name="last", combiner="replace", identity=0.0,
                  composable=False)
# AVERAGE keeps (sum, count) in payload columns (0, 1); composable (§5.2).
AVERAGE = Aggregator(name="average", combiner="add", identity=0.0,
                     composable=True, multiply=lambda payload, n: payload * n)
# MEDIAN: the paper's example of a NON-composable aggregate.
MEDIAN = Aggregator(name="median", combiner="replace", identity=0.0,
                    composable=False)

BUILTIN_UDAS = {a.name: a for a in
                [SUM, COUNT, MIN, MAX, LAST, AVERAGE, MEDIAN]}
