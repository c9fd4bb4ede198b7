"""Delta-based k-means clustering (paper Ex.2, Listing 3, Fig 5).

The mutable set is the point→centroid assignment; the Δᵢ set is the points
that *switched* centroids this stratum (paper Fig 3).  The paper's KMAgg
handler emits, per switched point, an adjustment delta ``(cid, +x, +y, +1)``
for the new centroid and ``(oldCid, −x, −y, −1)`` for the old one: the
centroid's (sum, count) state is maintained incrementally rather than
recomputed.  KMSampleAgg seeds centroids by sampling point coordinates
(``data/points.py``).

Wire model: switched-point deltas are pre-aggregated per centroid (the §5.2
combiner) before the cross-shard reduction; the no-delta mode ships every
point's assignment record every stratum (the MapReduce shuffle the paper
compares against).  Centroids are replicated on every shard (k is small);
the cross-shard combine of the adjustments is a sum over the shard axis.

With ``use_kernels`` the assignment goes through ``kernels/kmeans_assign``
(one launch per stratum over all S·block points); otherwise its plain
torch expression runs.  The byte accounting is computed in 64 bits and
then stored as float32: the reference's int32 product wraps from 67 M
switched points (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.fixpoint import FixpointResult, StratumOutcome, run_strata
from repro_torch.device import resolve_device
from repro_torch.kernels.kmeans_assign import assign, kmeans_assign_ref

BYTES_PER_DELTA = 16          # cid:int32 + x:f32 + y:f32 + count:f32
BYTES_PER_POINT_RECORD = 16   # what a MapReduce shuffle ships per point


class KMState(NamedTuple):
    assign: torch.Tensor   # int32[S, block] current centroid per point
    sums: torch.Tensor     # f32[k, D]       Σ coords per centroid (replicated)
    counts: torch.Tensor   # f32[k]          points per centroid (replicated)


def assign_points(points: torch.Tensor, centroids: torch.Tensor,
                  use_kernels: bool = True) -> torch.Tensor:
    """Nearest centroid per point by ``|p|^2 - 2p.c + |c|^2`` (ties to the
    first k): points f32[..., D], centroids f32[k, D] -> int32[...].  All
    points go through one call."""
    flat = points.reshape(-1, points.shape[-1])
    fn = assign if use_kernels else kmeans_assign_ref
    out, _ = fn(flat.contiguous(), centroids.contiguous())
    return out.reshape(points.shape[:-1])


def centroids_of(state: KMState) -> torch.Tensor:
    return state.sums / torch.clamp(state.counts, min=1.0)[:, None]


# Most points one float32 accumulator cell takes; see _segment_sums.
CELL_POINTS = 1 << 14


def _segment_sums(points: torch.Tensor, assign: torch.Tensor,
                  valid: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """Per shard and centroid (Σ coords, n) over the points that ``valid``
    keeps (every point when it is None): points f32[S, block, D] ->
    f32[S, k, D + 1].

    Each (shard, centroid) row is spread by point index over
    R = ⌈block / CELL_POINTS⌉ cells, summed at the end, so no float32 cell
    takes more than CELL_POINTS points: one cell taking millions of similar
    points stagnates, each add rounding to the sum's coarse ulp with a bias
    (about 1 coordinate unit off a float64 Lloyd at 47.75 M points a
    shard).  Up to CELL_POINTS points a shard R is 1 and the points are
    added in point order, as the reference adds them, so on the CPU the
    sums are bit-identical.  A mask is applied by compacting the kept
    points: the reference sends the others to a dropped row k, which on
    the card would be one address that all their atomics contend for."""
    S, block, D = points.shape
    R = -(-block // CELL_POINTS)
    cell = torch.arange(block, device=points.device) % R
    if valid is None:
        base = torch.arange(S, device=points.device)[:, None] * k
        rows = assign.long().add_(base).mul_(R).add_(cell).reshape(-1)
        data = points.reshape(-1, D)
    else:
        shard, idx = torch.nonzero(valid, as_tuple=True)
        rows = (shard * k + assign[shard, idx].long()) * R + cell[idx]
        data = points[shard, idx]
    sums = torch.zeros((S * k * R, D), dtype=points.dtype,
                       device=points.device).index_add_(0, rows, data)
    counts = torch.bincount(rows, minlength=S * k * R).to(points.dtype)
    return torch.cat([sums, counts[:, None]], 1).view(S, k, R, D + 1).sum(2)


def _on(points: torch.Tensor, valid: Optional[torch.Tensor]
        ) -> Optional[torch.Tensor]:
    return None if valid is None else valid.to(points.device)


def initial_state(points_sharded: torch.Tensor,
                  init_centroids: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  use_kernels: bool = True) -> KMState:
    """Base-case stratum: assign every (valid) point once, build sums."""
    k, D = init_centroids.shape
    valid = _on(points_sharded, valid)
    assign0 = assign_points(points_sharded, init_centroids, use_kernels)
    seg0 = _segment_sums(points_sharded, assign0, valid, k).sum(0)
    return KMState(assign=assign0, sums=seg0[:, :D], counts=seg0[:, D])


def _f32(x) -> torch.Tensor:
    """``x`` (an int64 device scalar or a Python int) as a float32 scalar."""
    return torch.as_tensor(x, dtype=torch.float64).to(torch.float32)


def make_stratum(points_sharded: torch.Tensor, k: int, mode: str = "delta",
                 valid: Optional[torch.Tensor] = None,
                 use_kernels: bool = True):
    """One Lloyd stratum over a (possibly masked) point set.

    ``valid`` masks out dead point slots (a fixed-capacity point array
    whose slots are toggled on insert/remove, so shapes stay static).
    Invalid slots never switch and never contribute to centroid sums."""
    if mode not in ("delta", "nodelta"):
        raise ValueError(mode)
    S, block, D = points_sharded.shape
    valid = _on(points_sharded, valid)
    n_points = S * block if valid is None else int(valid.sum())

    def stratum(state: KMState, stratum_idx):
        cents = centroids_of(state)
        new_assign = assign_points(points_sharded, cents, use_kernels)
        if valid is not None:   # masked slots keep theirs, never switch
            new_assign = torch.where(valid, new_assign, state.assign)
        switched = new_assign != state.assign
        n_switched = switched.sum()

        if mode == "delta":
            # KMAgg: +(x, y, 1) to the new centroid, −(x, y, 1) from the
            # old, pre-aggregated per centroid before the reduction.
            plus = _segment_sums(points_sharded, new_assign, switched, k)
            minus = _segment_sums(points_sharded, state.assign, switched, k)
            adj = (plus - minus).sum(0)
            sums = state.sums + adj[:, :D]
            counts = state.counts + adj[:, D]
            bytes_moved = _f32(2 * n_switched * BYTES_PER_DELTA)
            used_dense = False
        else:
            seg = _segment_sums(points_sharded, new_assign, valid, k).sum(0)
            sums, counts = seg[:, :D], seg[:, D]
            bytes_moved = _f32(n_points * BYTES_PER_POINT_RECORD)
            used_dense = True

        n_switched = n_switched.to(torch.int32)
        return KMState(assign=new_assign, sums=sums, counts=counts), \
            StratumOutcome(live_count=n_switched, used_dense=used_dense,
                           rehash_bytes=bytes_moved, emitted=n_switched)

    return stratum


def run(points_sharded: torch.Tensor, init_centroids: torch.Tensor,
        mode: str = "delta", max_iters: int = 60,
        valid: Optional[torch.Tensor] = None, device=None,
        use_kernels: bool = True) -> tuple[torch.Tensor, FixpointResult]:
    """points_sharded f32[S, block, D]; init_centroids f32[k, D], on
    ``device`` (None = CUDA; raises without it).

    Returns (final centroids, FixpointResult with per-stratum stats)."""
    dev = resolve_device(device)
    points = points_sharded.to(dev)
    init = init_centroids.to(dev)
    k = init.shape[0]
    state0 = initial_state(points, init, valid, use_kernels)
    stratum = make_stratum(points, k, mode, valid, use_kernels)
    res = run_strata(stratum, state0, 1, max_iters)
    return centroids_of(res.state), res


def resume(points_sharded: torch.Tensor, state: KMState, max_iters: int = 60,
           mode: str = "delta", valid: Optional[torch.Tensor] = None,
           device=None, use_kernels: bool = True
           ) -> tuple[torch.Tensor, FixpointResult]:
    """Resume Lloyd iteration from a warm (repaired) KMState; the first
    stratum re-checks every valid point against the given centroids, so
    the live count is zero when the state was already a fixpoint."""
    dev = resolve_device(device)
    points = points_sharded.to(dev)
    state = KMState(*(x.to(dev) for x in state))
    stratum = make_stratum(points, state.sums.shape[0], mode, valid,
                           use_kernels)
    res = run_strata(stratum, state, 1, max_iters)
    return centroids_of(res.state), res


def reference_kmeans(points: torch.Tensor, init_centroids: torch.Tensor,
                     max_iters: int = 60, device=None) -> torch.Tensor:
    """Lloyd-iteration oracle over the flat point set (the reference's, in
    float32): at most ``max_iters`` assignments by ``|p - c|^2``, stop when
    none changes, a centroid with no points keeps its place."""
    dev = resolve_device(device)
    pts = points.to(dev, torch.float32).reshape(-1, points.shape[-1])
    cents = init_centroids.to(dev, torch.float32).clone()
    k = cents.shape[0]
    assign = None
    for _ in range(max_iters):
        d2 = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        new_assign = d2.argmin(1)
        if assign is not None and bool((new_assign == assign).all()):
            break
        assign = new_assign
        sums = torch.zeros_like(cents).index_add_(0, assign, pts)
        counts = torch.bincount(assign, minlength=k)
        filled = counts > 0
        cents[filled] = sums[filled] / counts[filled, None].to(cents.dtype)
    return cents
