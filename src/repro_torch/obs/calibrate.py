"""Measured route-cost calibration for ``route_strategy="measured"``.

The ``auto`` dispatcher chooses sort- vs scatter-based combine-route per
capacity rung from a static cost model (``C·log₂C`` vs
``weight·(C + slab)``) whose weight was calibrated for the reference's
backend.  This module replaces the model with measurement: it times what
the engine dispatches, ``ShardedExecutor._route_one`` under the sort and
the scatter strategy, at each rung capacity on the device at hand, and
records the result in a :class:`RouteCostTable` the executor consults
when it builds a stratum.  With ``use_kernels`` on the card, sort is
``handlers.pre_aggregate`` + the ``delta_route`` kernel and scatter is the
``scatter_route`` kernel.

Two ways to build a table:

  * :func:`calibrate_route_table` / :func:`calibrate_executor_table` run
    the measurement (median of ``reps`` calls; CUDA events on the card,
    ``perf_counter`` on the CPU).
  * :meth:`RouteCostTable.from_bench_records` reads timing records
    (dicts with ``C``, ``S``, ``combiner``, ``strategy``, ``value`` in
    seconds); the caller must name the backend they were taken on.

Lookup interpolates in log-capacity space between measured rungs; an
exact match is exact.  Every table is stamped with its backend, ``"cpu"``
or ``"cuda:" + the card's name``, and ``pick`` refuses a table from
another backend unless ``strict=False``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.delta import ANN_ADJUST, DeltaBuffer
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.device import resolve_device


def backend_name(device=None) -> str:
    """``"cpu"`` or ``"cuda:" + the card's name`` for ``device`` (None:
    CUDA where it is available, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(dev)}"


@dataclasses.dataclass(frozen=True)
class RouteCostTable:
    """Measured per-rung costs: capacity -> (sort_s, scatter_s)."""

    backend: str
    combiner: str
    entries: Dict[int, Tuple[float, float]]

    def __post_init__(self):
        if not self.entries:
            raise ValueError("empty route cost table")

    def costs(self, edge_capacity: int) -> Tuple[float, float]:
        """(sort_s, scatter_s) at ``edge_capacity``, log-interpolated
        between the nearest measured rungs (clamped at the ends)."""
        caps = sorted(self.entries)
        c = max(int(edge_capacity), 1)
        if c <= caps[0]:
            return self.entries[caps[0]]
        if c >= caps[-1]:
            return self.entries[caps[-1]]
        for lo, hi in zip(caps, caps[1:]):
            if lo <= c <= hi:
                if c == lo:
                    return self.entries[lo]
                if c == hi:
                    return self.entries[hi]
                f = ((math.log2(c) - math.log2(lo))
                     / (math.log2(hi) - math.log2(lo)))
                slo, plo = self.entries[lo]
                shi, phi = self.entries[hi]
                return (slo + f * (shi - slo), plo + f * (phi - plo))
        raise AssertionError("unreachable")

    def per_tuple_cost(self, edge_capacity: int) -> float:
        """Measured seconds per routed tuple at ``edge_capacity``: the
        cheaper strategy's cost amortized over the rung."""
        sort_s, scatter_s = self.costs(edge_capacity)
        return min(sort_s, scatter_s) / max(int(edge_capacity), 1)

    def median_per_tuple(self) -> float:
        """Median per-tuple routed cost across all measured rungs."""
        vals = sorted(self.per_tuple_cost(c) for c in self.entries)
        return vals[len(vals) // 2]

    def pick(self, edge_capacity: int, strict: bool = True,
             device=None) -> str:
        """Cheaper measured strategy for a rung of ``edge_capacity`` on
        ``device`` (see :func:`backend_name`)."""
        here = backend_name(device)
        if strict and self.backend != here:
            raise ValueError(
                f"route cost table was measured on {self.backend!r} but "
                f"the current backend is {here!r}; recalibrate (or pass "
                "strict=False to override)")
        sort_s, scatter_s = self.costs(edge_capacity)
        return "scatter" if scatter_s < sort_s else "sort"

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_bench_records(cls, records: Iterable[dict], shards: int,
                           combiner: str = "add", *, backend: str
                           ) -> "RouteCostTable":
        """Build a table from timing records matching ``S`` and
        ``combiner``, one (sort, scatter) pair per ``C``.  ``backend``
        names where they were measured: records carry no device."""
        acc: Dict[int, Dict[str, float]] = {}
        for rec in records:
            if rec.get("unit") != "s" or rec.get("combiner") != combiner \
                    or int(rec.get("S", -1)) != shards:
                continue
            strat = rec.get("strategy")
            if strat not in ("sort", "scatter"):
                continue
            acc.setdefault(int(rec["C"]), {})[strat] = float(rec["value"])
        entries = {c: (v["sort"], v["scatter"])
                   for c, v in acc.items() if len(v) == 2}
        if not entries:
            raise ValueError(
                f"no (sort, scatter) record pairs for S={shards}, "
                f"combiner={combiner!r}")
        return cls(backend=backend, combiner=combiner, entries=entries)


def _timed(fn, device: torch.device, warmup: int = 1, reps: int = 3
           ) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after ``warmup``: CUDA
    events around each call on the card, ``perf_counter`` on the CPU."""
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _probe_buffer(rng: np.random.Generator, capacity: int, n_keys: int,
                  payload_width: int, device: torch.device,
                  fill: float = 0.75) -> DeltaBuffer:
    """A buffer of ``capacity`` slots, ``fill`` of them live with random
    keys in [0, n_keys) (the reference's probe, at ``payload_width``)."""
    count = int(capacity * fill)
    keys = np.full(capacity, -1, np.int32)
    keys[:count] = rng.integers(0, n_keys, count)
    pay = rng.normal(size=(capacity, payload_width)).astype(np.float32)
    pay[count:] = 0
    return DeltaBuffer(
        keys=torch.from_numpy(keys).to(device),
        payload=torch.from_numpy(pay).to(device),
        ann=torch.full((capacity,), ANN_ADJUST, dtype=torch.int8,
                       device=device),
        count=torch.tensor(count, dtype=torch.int32, device=device),
        overflowed=torch.zeros((), dtype=torch.bool, device=device))


def calibrate_route_table(snapshot: PartitionSnapshot,
                          capacities: Iterable[int],
                          combiner: str = "add", reps: int = 3,
                          warmup: int = 1, seed: int = 0, *,
                          use_kernels: bool = True, payload_width: int = 1,
                          device=None) -> RouteCostTable:
    """Time the engine's local rehash (``ShardedExecutor._route_one``) under
    the sort and the scatter strategy at each capacity, on ``device``
    (None = CUDA; raises without it), with the slab size and owner scheme
    of ``snapshot``."""
    from repro_torch.core.engine import ShardedExecutor
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    entries: Dict[int, Tuple[float, float]] = {}
    for cap in sorted({max(int(c), 2) for c in capacities}):
        db = _probe_buffer(rng, cap, snapshot.n_keys, payload_width, dev)
        ex = ShardedExecutor(snapshot=snapshot, seg_capacity=cap,
                             edge_capacity=cap, src_capacity=cap,
                             use_kernels=use_kernels)
        entries[cap] = tuple(
            _timed(lambda s=strategy: ex._route_one(db, cap, combiner, s),
                   dev, warmup=warmup, reps=reps)
            for strategy in ("sort", "scatter"))
    return RouteCostTable(backend=backend_name(dev), combiner=combiner,
                          entries=entries)


def calibrate_executor_table(executor, algo,
                             combiner: Optional[str] = None,
                             **kw) -> RouteCostTable:
    """Calibrate exactly the capacity rungs ``executor`` would dispatch
    over for ``algo`` (its ladder's per-rung edge budgets), with the
    executor's ``use_kernels`` and the algorithm's payload width."""
    caps = {t.edge for t in executor.capacity_tiers(algo)}
    comb = combiner or (algo.combiner
                        if algo.combiner in ("add", "min", "max") else "add")
    kw.setdefault("use_kernels", executor.use_kernels)
    kw.setdefault("payload_width", algo.payload_width)
    return calibrate_route_table(executor.snapshot, caps, combiner=comb,
                                 **kw)
