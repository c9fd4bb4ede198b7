"""Stratified fixpoint execution (paper §3.1, §3.4, §4.2).

REX executes recursive queries in *strata*: each stratum applies incoming
deltas to operator state and emits the next Δ set; the engine terminates
*implicitly* (no new deltas) or *explicitly* (a user condition over
consecutive strata, converted to implicit by zeroing the live count).

Here a stratum is one turn of a Python loop.  The stratum vote is the
globally reduced live count, read to the host once per stratum to decide
whether to go on.  Per-stratum statistics are kept in host (CPU) tensors so
they can be reported like the paper's Figure 2 / Figure 11.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

ROUTE_SORT = 0     # stratum rehash ran the sort-based combine-route
ROUTE_SCATTER = 1  # stratum rehash ran the scatter-based combine-route


class StratumStats(NamedTuple):
    delta_counts: torch.Tensor  # int32[max_iters]   |Δᵢ| emitted per stratum
    used_dense: torch.Tensor    # bool[max_iters]    stratum ran densely
    rehash_bytes: torch.Tensor  # float32[max_iters] bytes moved by the rehash
    iterations: torch.Tensor    # int32[]            strata actually executed
    tiers: torch.Tensor         # int32[max_iters]   ladder rung (-1 = dense)
    routes: torch.Tensor        # int32[max_iters]   ROUTE_* (-1 = dense)


class StratumOutcome(NamedTuple):
    """What one stratum reports back to the fixpoint loop (globally
    reduced).  Tensors or Python numbers; the loop reads them to the host."""

    live_count: object    # int32[]  |Δ| still live after this stratum
    used_dense: object    # bool[]   ran the dense body
    rehash_bytes: object  # float32[] bytes the rehash moved
    emitted: object       # int32[]  deltas emitted this stratum
    tier: object = -1     # int32[]  capacity-ladder rung (-1 = dense)
    route: object = -1    # int32[]  ROUTE_SORT / ROUTE_SCATTER (-1 = n.a.)


class FixpointResult(NamedTuple):
    state: object
    stats: StratumStats


def stats_from_outcomes(outcomes: list, max_iters: int) -> StratumStats:
    """Assemble :class:`StratumStats` from per-stratum outcomes.  When more
    than ``max_iters`` outcomes are given the LAST ``max_iters`` are kept
    and ``iterations`` is clipped to ``max_iters``."""
    tail = outcomes[-max_iters:] if max_iters else []

    def col(getter, dtype, fill):
        arr = np.full((max_iters,), fill, dtype)
        for i, o in enumerate(tail):
            arr[i] = getter(o)
        return torch.from_numpy(arr)

    return StratumStats(
        delta_counts=col(lambda o: int(o.emitted), np.int32, 0),
        used_dense=col(lambda o: bool(o.used_dense), np.bool_, False),
        rehash_bytes=col(lambda o: float(o.rehash_bytes), np.float32, 0.0),
        iterations=torch.tensor(min(len(outcomes), max_iters),
                                dtype=torch.int32),
        tiers=col(lambda o: int(o.tier), np.int32, -1),
        routes=col(lambda o: int(o.route), np.int32, -1),
    )


def empty_stats(max_iters: int) -> StratumStats:
    """Stats of a run that executed zero strata (warm resume no-op)."""
    return stats_from_outcomes([], max_iters)


def run_strata(stratum_fn: Callable, state0, live0, max_iters: int,
               tracer=None) -> FixpointResult:
    """Run ``stratum_fn`` until no live deltas remain or ``max_iters``.

    stratum_fn(state, stratum) -> (state', StratumOutcome)
        Owns the whole stratum: density decision, emission, rehash,
        application.  Outcome fields are globally reduced.
    live0
        Globally reduced initial live count (size of Δ₀).
    tracer
        Optional ``repro_torch.obs.Tracer``: the stratum spans the engine
        opened are closed after each stratum's host read, and a
        fixpoint-complete marker follows the loop.  None records nothing.
    """
    state, live, outcomes = state0, int(live0), []
    while len(outcomes) < max_iters and live > 0:
        state, outcome = stratum_fn(state, len(outcomes))
        # One host read per stratum: the outcome's device scalars.
        outcome = StratumOutcome(*(v.item() if torch.is_tensor(v) else v
                                   for v in outcome))
        if tracer is not None:
            tracer.resolve()
        outcomes.append(outcome)
        live = int(outcome.live_count)
    if tracer is not None:
        tracer.fixpoint_probe(len(outcomes), max_iters)
    return FixpointResult(state=state,
                          stats=stats_from_outcomes(outcomes, max_iters))


def merge_stats(a: StratumStats, b: StratumStats) -> StratumStats:
    """Concatenate the per-stratum stats of two consecutive runs."""
    ia, ib = int(a.iterations), int(b.iterations)

    def cat(xa, xb):
        return torch.cat([xa[:ia], xb[:ib]])

    return StratumStats(
        delta_counts=cat(a.delta_counts, b.delta_counts),
        used_dense=cat(a.used_dense, b.used_dense),
        rehash_bytes=cat(a.rehash_bytes, b.rehash_bytes),
        iterations=torch.tensor(ia + ib, dtype=torch.int32),
        tiers=cat(a.tiers, b.tiers),
        routes=cat(a.routes, b.routes),
    )


def with_explicit_condition(stratum_fn: Callable, cond: Callable) -> Callable:
    """Wrap a stratum so that ``cond(new_state, old_state, stratum) -> bool``
    (True = keep iterating) gates the live count: the paper's conversion of
    explicit termination into the implicit fixpoint form."""

    def wrapped(state, stratum):
        new_state, outcome = stratum_fn(state, stratum)
        keep = bool(cond(new_state, state, stratum))
        return new_state, outcome._replace(
            live_count=outcome.live_count if keep else 0)

    return wrapped
