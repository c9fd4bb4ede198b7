"""Distributed delta execution: the rehash operator + sharded fixpoint.

The paper's runtime (§4.1–4.2) pushes batched delta messages between
workers according to the partition snapshot.  Here each shard groups its
outgoing deltas by destination into equal-size segments, the segments are
swapped across shards, and the receiver recounts live slots.  The dense
(no-delta / fallback) path exchanges each shard's full contribution vector
instead; the two patterns are the delta/dense duality at the wire level.

Backends: ``shard_map``, where each rank of a ``torch.distributed`` group
(``launch/mesh.py``) computes its own block of shards and the swap is an
``all_to_all_single``, and ``simulated``, the same strata over a one-rank
mesh that holds every shard and whose collectives are identities, so the
swap is an axis transpose.  On the CPU their results are bit-identical.
Algorithms are written against
:class:`DeltaAlgorithm` (five shard-local functions); the engine calls them
once per shard, owns routing, density switching and the fixpoint loop.
Outgoing deltas use GLOBAL keys; the engine routes by the snapshot.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import delta as deltamod
from repro_torch.core.delta import DeltaBuffer, _i32
from repro_torch.core.fixpoint import (ROUTE_SCATTER, ROUTE_SORT,
                                       FixpointResult, StratumOutcome,
                                       run_strata, with_explicit_condition)
from repro_torch.core.partition import PartitionSnapshot


@dataclasses.dataclass(frozen=True)
class DeltaAlgorithm:
    """A REX recursive query lowered to shard-local callables.

    active_fn(state, imm) -> (active[bool; block], est_edges[int32;])
        The Δᵢ set plus the EXACT emission size if run sparsely.
    sparse_emit(state, imm, active, stratum, shard_id)
        -> (state_partial, DeltaBuffer)        O(|Δ|) emission.
    dense_emit(state, imm, stratum, shard_id)
        -> (state_partial, contrib[f32; n_padded_global, payload_width])
    apply_sparse(state_partial, incoming: DeltaBuffer, imm, stratum, shard_id)
        -> (state', next_active_count[int32;])
    apply_dense(state_partial, incoming[f32; block, payload_width], imm,
        stratum, shard_id) -> (state', next_active_count)

    combiner: how concurrent contributions to one key merge.
    emit_factory(src_capacity, edge_capacity) -> sparse_emit-like callable,
    which lets the executor run sparse strata at several capacity rungs.
    nodelta_dense_emit: dense_emit for ``mode="nodelta"``, where every
    stratum is dense (None: dense_emit); it may round differently, as the
    reference's compiled loop does there.
    """

    active_fn: Callable
    sparse_emit: Callable
    dense_emit: Callable
    apply_sparse: Callable
    apply_dense: Callable
    combiner: str = "add"
    payload_width: int = 1
    bytes_per_delta: int = 8  # int32 key + f32 payload
    emit_factory: Optional[Callable] = None
    nodelta_dense_emit: Optional[Callable] = None

    def dense_identity(self) -> float:
        return {"add": 0.0, "min": float("inf"), "max": float("-inf")}[
            self.combiner]


def _dense_combine(stacked: torch.Tensor, combiner: str, dim: int
                   ) -> torch.Tensor:
    if combiner == "add":
        return torch.sum(stacked, dim=dim)
    if combiner == "min":
        return torch.amin(stacked, dim=dim)
    if combiner == "max":
        return torch.amax(stacked, dim=dim)
    raise ValueError(combiner)


def _take(tree, s: int):
    """Shard ``s`` of a tensor / NamedTuple / dataclass with a leading
    shard axis (views, no copies)."""
    if torch.is_tensor(tree):
        return tree[s]
    if isinstance(tree, tuple):
        parts = [_take(x, s) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _take(getattr(tree, f.name), s)
                             for f in dataclasses.fields(tree)})
    return tree


def _stack(trees: list):
    """Inverse of :func:`_take` over a list of per-shard trees."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, tuple):
        parts = [_stack(list(xs)) for xs in zip(*trees)]
        return (type(first)(*parts) if hasattr(first, "_fields")
                else tuple(parts))
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: _stack([getattr(t, f.name)
                                              for t in trees])
                              for f in dataclasses.fields(first)})
    raise TypeError(type(first))


class CapacityTier(NamedTuple):
    """One rung of the density ladder: the three sparse-stratum budgets."""

    src: int    # active-source compaction slots
    edge: int   # edge-emission slots
    seg: int    # per-destination rehash segment slots


@dataclasses.dataclass(frozen=True)
class ShardedExecutor:
    """Runs a DeltaAlgorithm over a partitioned key space.

    snapshot      partition snapshot routed against (paper §4.1).
    seg_capacity  per-destination segment slots in the sparse rehash.
    edge_capacity stratum edge-slot budget for sparse emission.
    src_capacity  active-source compaction budget.

    Density ladder: with ``ladder_tiers > 1`` (and an algorithm providing
    ``emit_factory``) sparse strata run at ``ladder_tiers`` capacity rungs,
    powers of ``ladder_factor`` below the configured capacities, and each
    stratum dispatches to the SMALLEST rung whose budgets cover the exactly
    predicted emission size; no rung fits -> the dense body.

    Rehash strategy, per rung: ``"sort"`` (fused single-sort
    ``combine_route``), ``"scatter"`` (sort-free ``combine_route_scatter``)
    or ``"auto"``, a static cost model: sort ~ C·log₂C, scatter ~
    ``route_scatter_weight``·(C + slab cells).  A non-composable combiner
    always routes with the sort path.

    ``route_strategy="measured"`` swaps the static model for a measured
    per-rung table (``route_table``, built by ``repro_torch.obs.calibrate``
    from sort and scatter timings on the device at hand); a table from
    another backend is refused.

    ``use_kernels`` (default True) sends the local rehash through the CUDA
    kernels: ``kernels/scatter_route`` for the scatter strategy, and
    ``handlers.pre_aggregate`` then ``kernels/delta_route`` otherwise.  On
    CPU tensors the kernels' plain versions run.  False runs the torch-op
    functions of ``core/delta.py``.

    Observability: an attached ``tracer`` (``repro_torch.obs.Tracer``)
    gets one span per stratum (its outcome, host wall, and on the card the
    device time between two CUDA events), closed after the stratum's host
    read of its live count.  ``tracer=None`` (the default) leaves every
    stratum exactly as it is: no event, no extra synchronisation.

    :meth:`run_resilient` runs the same strata through the fault-tolerant
    driver of ``runtime/recovery.py``.

    ``backend="shard_map"`` runs over a ``torch.distributed`` group:
    ``mesh`` (``launch.mesh.ShardMesh``; None = ``flat_mesh`` over the
    default group, on the inputs' device) gives each rank a contiguous
    block of the shards.  The
    caller hands every rank the same global ``[S, ...]`` state and
    immutable trees; a rank computes its block on ``mesh.device``, swaps
    segments with ``all_to_all_single``, reduces the rung choice, live
    count and emitted count with ``all_reduce``, and every rank returns
    the same global result (the final state all-gathered).  Rank 0's
    ``route_table`` decides the measured routes of every rank.  An
    ``explicit_cond`` reads the all-gathered new and old states, so every
    rank stops where the simulated backend stops.  A ``tracer`` gets one
    span a stratum for the rank's own shards.  :meth:`run_resilient`
    runs on every rank of the group (see there).  ``axis_name`` is
    accepted for parity with the reference's
    executor and read by nothing: a ``torch.distributed`` collective
    addresses its group, not a named axis.
    """

    snapshot: PartitionSnapshot
    seg_capacity: int
    edge_capacity: int
    src_capacity: int
    backend: str = "simulated"     # "simulated" | "shard_map"
    axis_name: str = "shards"      # unused (see above)
    mesh: Optional[object] = dataclasses.field(
        default=None, compare=False)   # launch.mesh.ShardMesh (shard_map)
    ladder_tiers: int = 1          # 1 = ladder off (single sparse rung)
    ladder_factor: int = 4         # capacity ratio between adjacent rungs
    ladder_src_floor: int = 64     # smallest useful src budget
    ladder_edge_floor: int = 256   # smallest useful edge/seg budget
    route_strategy: str = "sort"   # "sort" | "scatter" | "auto" | "measured"
    route_scatter_weight: float = 0.4  # auto model: relative cost of one
    #                                scatter/slab element vs one sort
    #                                compare·log₂C unit (the reference's
    #                                calibration, kept so rungs pick the
    #                                same routes)
    use_kernels: bool = True
    tracer: Optional[object] = dataclasses.field(
        default=None, compare=False)   # repro_torch.obs.Tracer (None = off)
    route_table: Optional[object] = dataclasses.field(
        default=None, compare=False)   # obs.calibrate.RouteCostTable for
    #                                    route_strategy="measured"

    # ------------------------------------------------------------------
    # Density ladder.
    # ------------------------------------------------------------------
    def capacity_tiers(self, algo: DeltaAlgorithm) -> list[CapacityTier]:
        """Ascending capacity rungs for ``algo`` (top = configured budgets)."""
        top = CapacityTier(self.src_capacity, self.edge_capacity,
                           self.seg_capacity)
        if self.ladder_tiers <= 1 or algo.emit_factory is None:
            return [top]
        tiers: list[CapacityTier] = []
        for i in range(self.ladder_tiers - 1, 0, -1):
            d = self.ladder_factor ** i
            t = CapacityTier(
                src=min(max(self.src_capacity // d, self.ladder_src_floor),
                        top.src),
                edge=min(max(self.edge_capacity // d, self.ladder_edge_floor),
                         top.edge),
                seg=min(max(self.seg_capacity // d, self.ladder_edge_floor),
                        top.seg))
            if t != top and (not tiers or t != tiers[-1]):
                tiers.append(t)
        tiers.append(top)
        return tiers

    def _emit_fn(self, algo: DeltaAlgorithm, tier: CapacityTier) -> Callable:
        if (algo.emit_factory is None
                or (tier.src, tier.edge) == (self.src_capacity,
                                             self.edge_capacity)):
            return algo.sparse_emit
        return algo.emit_factory(tier.src, tier.edge)

    # ------------------------------------------------------------------
    # Rehash strategy selection (per capacity rung).
    # ------------------------------------------------------------------
    def pick_route_strategy(self, edge_capacity: int,
                            combiner: Optional[str], device=None,
                            table=None) -> str:
        """Physical combine-route implementation for a rung whose routed
        buffer holds ``edge_capacity`` slots, on ``device`` (which
        "measured" holds its table's backend to); ``table`` None =
        ``route_table``."""
        if self.route_strategy not in ("sort", "scatter", "auto",
                                       "measured"):
            raise ValueError(self.route_strategy)
        if combiner is None:
            return "sort"
        if self.route_strategy == "measured":
            table = self.route_table if table is None else table
            if table is None:
                raise ValueError(
                    "route_strategy='measured' needs a route_table: build "
                    "one with repro_torch.obs.calibrate."
                    "calibrate_executor_table(executor, algo)")
            return table.pick(edge_capacity, device=device)
        if self.route_strategy != "auto":
            return self.route_strategy
        slab = self.snapshot.padded_keys
        if self.snapshot.scheme != "block":
            slab *= self.snapshot.num_shards
        c = max(edge_capacity, 2)
        sort_cost = c * math.log2(c)
        scatter_cost = self.route_scatter_weight * (c + slab)
        return "scatter" if scatter_cost < sort_cost else "sort"

    # ------------------------------------------------------------------
    # Sparse rehash (fused combine + route).
    # ------------------------------------------------------------------
    def _route_one(self, db: DeltaBuffer, seg_capacity: int,
                   combiner: Optional[str], strategy: str = "sort"
                   ) -> DeltaBuffer:
        """Local half of the rehash: one shard's outgoing Δ -> per-owner
        segments."""
        S = self.snapshot.num_shards
        owners = self.snapshot.owner_of(db.keys)
        if strategy == "scatter" and combiner is not None:
            if self.use_kernels:
                from repro_torch.kernels.scatter_route import \
                    scatter_route_deltas
                return scatter_route_deltas(db, owners, S, seg_capacity,
                                            combiner, snapshot=self.snapshot)
            return deltamod.combine_route_scatter(
                db, owners, S, seg_capacity, combiner,
                snapshot=self.snapshot)
        if self.use_kernels:
            from repro_torch.kernels.delta_route import route_deltas
            if combiner is not None:
                # §5.2 pre-aggregation, then the routing kernel: equal to
                # the fused single-sort combine_route.
                from repro_torch.core.handlers import pre_aggregate
                db = pre_aggregate(db, combiner)
                owners = self.snapshot.owner_of(db.keys)
            return route_deltas(db, owners, S, seg_capacity)
        if combiner is not None:
            return deltamod.combine_route(db, owners, S, seg_capacity,
                                          combiner)
        return deltamod.route_by_owner(db, owners, S, seg_capacity)

    def rehash_sparse(self, stacked: DeltaBuffer,
                      seg_capacity: Optional[int] = None,
                      combiner: Optional[str] = None,
                      strategy: str = "sort", mesh=None
                      ) -> tuple[DeltaBuffer, torch.Tensor]:
        """stacked: this rank's [L] outgoing Δ -> (incoming Δ [L, S*cap]
        in source-shard order, routed delta count summed over every rank);
        ``mesh`` None = this executor's.  Each local source's routed
        segments go straight into a send buffer [world, L_dst, L_src, cap]
        ordered by destination rank, so only one shard's routed buffer is
        alive besides it; one ``all_to_all`` each for keys, payload and
        ann.  On the simulated backend (world 1, L = S) the buffer is the
        swapped [dst, src, cap] layout itself and nothing is copied."""
        mesh = self._mesh(stacked.keys) if mesh is None else mesh
        S, L, world = self.snapshot.num_shards, mesh.shards_per_rank, \
            mesh.world
        cap = self.seg_capacity if seg_capacity is None else seg_capacity
        dev = stacked.keys.device
        w = stacked.payload_width
        keys = torch.empty((world, L, L, cap), dtype=torch.int32, device=dev)
        payload = torch.empty((world, L, L, cap, w),
                              dtype=stacked.payload.dtype, device=dev)
        ann = torch.empty((world, L, L, cap), dtype=torch.int8, device=dev)
        votes = torch.zeros((2,), dtype=torch.int32, device=dev)
        for s in range(L):
            routed = self._route_one(_take(stacked, s), cap, combiner,
                                     strategy)
            keys[:, :, s] = routed.keys.view(world, L, cap)
            payload[:, :, s] = routed.payload.view(world, L, cap, w)
            ann[:, :, s] = routed.ann.view(world, L, cap)
            votes[0] += routed.count
            votes[1] += routed.overflowed.to(torch.int32)
        # Received [world_src, L_dst, L_src, cap] -> [L_dst, S_src * cap]
        # (a view at world 1).
        keys, payload, ann = (
            mesh.all_to_all(x).transpose(0, 1)
            .reshape((L, S * cap) + x.shape[4:])
            for x in (keys, payload, ann))
        emitted, overflow = mesh.all_reduce(votes, "sum")
        incoming = deltamod.recount(DeltaBuffer(
            keys=keys, payload=payload, ann=ann, count=None,
            overflowed=(overflow > 0).expand(L)))
        return incoming, emitted

    # ------------------------------------------------------------------
    # Dense rehash: contribution vectors -> combined local blocks.
    # ------------------------------------------------------------------
    def rehash_dense(self, contrib: torch.Tensor, combiner: str, mesh=None
                     ) -> torch.Tensor:
        """contrib: this rank's [L_src, n_padded, W] -> incoming [L_dst,
        block, W], combined over all S sources in source order; ``mesh``
        None = this executor's."""
        mesh = self._mesh(contrib) if mesh is None else mesh
        S, block = self.snapshot.num_shards, self.snapshot.block_size
        L, world, w = mesh.shards_per_rank, mesh.world, contrib.shape[-1]
        send = contrib.reshape(L, world, L, block, w).transpose(0, 1)
        seg = mesh.all_to_all(send)
        return _dense_combine(seg.reshape(S, L, block, w).transpose(0, 1),
                              combiner, dim=1)

    # ------------------------------------------------------------------
    # Stratum assembly.
    # ------------------------------------------------------------------
    def _mesh(self, tree):
        """The mesh the strata run over: on the simulated backend every
        shard in this process on the device of ``tree`` (the caller's
        inputs); on shard_map ``mesh``, or with none given the flat mesh
        over the default group on that device."""
        from repro_torch.launch.mesh import flat_mesh, local_mesh
        if self.backend == "simulated":
            return local_mesh(self.snapshot.num_shards, _device_of(tree))
        if self.backend != "shard_map":
            raise ValueError(self.backend)
        if self.mesh is not None:
            if self.mesh.num_shards != self.snapshot.num_shards:
                raise ValueError(
                    f"the mesh holds {self.mesh.num_shards} shards, the "
                    f"snapshot {self.snapshot.num_shards}")
            return self.mesh
        return flat_mesh(self.snapshot.num_shards, device=_device_of(tree))

    def run(self, algo: DeltaAlgorithm, state0, live0, immutable,
            max_iters: int, mode: str = "delta",
            explicit_cond: Optional[Callable] = None) -> FixpointResult:
        """state0 / immutable carry a leading [S] shard axis on both
        backends (shard_map takes each rank's block of it)."""
        if mode not in ("delta", "nodelta"):
            raise ValueError(mode)
        mesh = self._mesh(immutable)
        state, immutable = _local(state0, mesh), _local(immutable, mesh)
        stratum_fn = self._stratum(algo, immutable, mode, mesh,
                                   explicit_cond)
        if self.tracer is not None:
            # Anchor the timeline here, so the first span excludes host
            # setup.
            self.tracer.mark_shards(self.snapshot.num_shards)
        res = run_strata(stratum_fn, state, live0, max_iters,
                         tracer=self.tracer)
        return res._replace(state=_gathered(res.state, mesh))

    def live_count(self, algo: DeltaAlgorithm, state, immutable
                   ) -> torch.Tensor:
        """Globally reduced |Δ₀| of ``state``: the seed live count for
        :meth:`resume`."""
        mesh = self._mesh(immutable)
        state, immutable = _local(state, mesh), _local(immutable, mesh)
        count = _i32(sum(
            algo.active_fn(_take(state, i), _take(immutable, i))
            [0].to(torch.int32).sum() for i in range(_n_local(state))))
        return mesh.all_reduce(count, "sum")

    def resume(self, algo: DeltaAlgorithm, warm_state, immutable,
               max_iters: int, mode: str = "delta",
               explicit_cond: Optional[Callable] = None) -> FixpointResult:
        """Re-enter the fixpoint from a previously converged (then
        repaired) state; Δ₀ is derived from ``active_fn``."""
        live0 = self.live_count(algo, warm_state, immutable)
        return self.run(algo, warm_state, live0, immutable, max_iters,
                        mode=mode, explicit_cond=explicit_cond)

    def make_stratum_fn(self, algo: DeltaAlgorithm, immutable,
                        mode: str = "delta",
                        explicit_cond: Optional[Callable] = None):
        """One-stratum function (state, idx) -> (state', outcome) over the
        global state, the same body :meth:`run` loops over (on shard_map
        each call computes the rank's block and all-gathers the result)."""
        mesh = self._mesh(immutable)
        fn = self._stratum(algo, _local(immutable, mesh), mode, mesh,
                           explicit_cond)

        def one(state, idx):
            new_state, outcome = fn(_local(state, mesh), idx)
            return _gathered(new_state, mesh), outcome

        return one

    # ------------------------------------------------------------------
    # Fault-tolerant elastic execution (runtime/recovery.py driver).
    # ------------------------------------------------------------------
    def run_resilient(self, algo: DeltaAlgorithm, state0, live0, immutable,
                      max_iters: int, mode: str = "delta",
                      explicit_cond: Optional[Callable] = None, *,
                      ckpt_root: str, fault_plan=None, policy=None,
                      latency_model=None, remake=None, metrics=None,
                      retry=None, budget=None, tracer=None):
        """``run`` with fault tolerance and elasticity: stratum-sliced
        execution that keeps a per-stratum replica chain of changed-entry
        deltas (paper §4.1), rebuilds a failed shard from replicas and
        resumes warm, migrates state and in-flight route buffers to a
        fresh partition snapshot on rescale, and speculatively re-issues
        straggling shards against their replica.

        A failure-free resilient run equals :meth:`run`, stats included.
        Returns a ``runtime.recovery.ResilientResult``; ``metrics``
        carries the Fig 12 work/byte accounting and every recovery event.
        See :class:`repro_torch.runtime.recovery.ResilientDriver`.

        ``ckpt_root`` must be a dedicated directory: the replica chain
        owns it and DELETES any existing contents at query start.

        On ``backend="shard_map"`` every rank calls this with the same
        arguments and runs the same driver: each stratum computes the
        rank's block and all-gathers the state (:meth:`make_stratum_fn`),
        so every rank replicates, restores and rescales the global state
        in its own replica chain, ``ckpt_root/rank{r}``.  The decisions
        the driver takes from a wall clock (measured latencies, and so
        speculation and straggle handling) are rank 0's, broadcast; the
        result equals the simulated backend's.  A rescale to a shard
        count that does not split over the ranks raises.
        """
        from repro_torch.runtime.recovery import ResilientDriver
        if self.backend == "shard_map":
            ckpt_root = os.path.join(
                ckpt_root, f"rank{self._mesh(immutable).rank}")
        driver = ResilientDriver(
            self, algo, state0, live0, immutable, max_iters, mode=mode,
            explicit_cond=explicit_cond, ckpt_root=ckpt_root,
            fault_plan=fault_plan, policy=policy,
            latency_model=latency_model, remake=remake, metrics=metrics,
            retry=retry, budget=budget, tracer=tracer)
        return driver.run()

    def resume_resilient(self, algo: DeltaAlgorithm, warm_state, immutable,
                         max_iters: int, mode: str = "delta",
                         explicit_cond: Optional[Callable] = None,
                         **resilient_kw):
        """:meth:`resume` (warm re-entry, Δ₀ from ``active_fn``) through
        the fault-tolerant driver."""
        live0 = self.live_count(algo, warm_state, immutable)
        return self.run_resilient(algo, warm_state, live0, immutable,
                                  max_iters, mode=mode,
                                  explicit_cond=explicit_cond,
                                  **resilient_kw)

    # ---- the stratum body, on either backend ------------------------------
    def _stratum(self, algo: DeltaAlgorithm, immutable, mode, mesh,
                 explicit_cond: Optional[Callable] = None):
        """(state, idx) -> (state', outcome) over ``mesh``'s block of the
        shards (all S on the simulated backend): ``state`` and
        ``immutable`` hold that block, and the outcome's values are
        reduced over every rank."""
        from repro_torch.launch.mesh import local_shards
        S = self.snapshot.num_shards
        tiers = self.capacity_tiers(algo)
        first = local_shards(mesh).start
        shards = range(_n_local(immutable))
        imm = [_take(immutable, i) for i in shards]
        tracer = self.tracer
        device = _device_of(immutable)
        # Sender-side combiner (§5.2) fused into the route.
        combiner = (algo.combiner
                    if algo.combiner in ("add", "min", "max") else None)
        table = self.route_table
        if self.route_strategy == "measured":
            table = mesh.broadcast_object(table)   # every rank routes alike
        reduced = mesh.all_reduce

        def apply_all(apply_fn, partial, incoming, stratum):
            outs = [apply_fn(_take(partial, i), _take(incoming, i), imm[i],
                             stratum, first + i) for i in shards]
            return (_stack([o[0] for o in outs]),
                    _i32(sum(o[1] for o in outs)))

        def make_sparse_body(tier: CapacityTier, tier_idx: int):
            emit_fn = self._emit_fn(algo, tier)
            strategy = self.pick_route_strategy(tier.edge, combiner, device,
                                                table)
            route_code = ROUTE_SCATTER if strategy == "scatter" \
                else ROUTE_SORT

            def sparse_body(state, stratum, active):
                parts = [emit_fn(_take(state, i), imm[i], active[i], stratum,
                                 first + i) for i in shards]
                partial = _stack([p[0] for p in parts])
                outgoing = _stack([p[1] for p in parts])
                del parts
                kw = dict(seg_capacity=tier.seg, combiner=combiner,
                          strategy=strategy)
                incoming, emitted = self.rehash_sparse(outgoing, mesh=mesh,
                                                       **kw)
                del outgoing
                new_state, live = apply_all(algo.apply_sparse, partial,
                                            incoming, stratum)
                return new_state, StratumOutcome(
                    live_count=reduced(live, "sum"), used_dense=False,
                    rehash_bytes=emitted.to(torch.float32)
                    * algo.bytes_per_delta,
                    emitted=emitted, tier=tier_idx, route=route_code)

            return sparse_body

        dense_emit = (algo.nodelta_dense_emit if mode == "nodelta"
                      and algo.nodelta_dense_emit is not None
                      else algo.dense_emit)

        def dense_body(state, stratum, active):
            parts = [dense_emit(_take(state, i), imm[i], stratum, first + i)
                     for i in shards]
            partial = _stack([p[0] for p in parts])
            contrib = torch.stack([p[1] for p in parts])
            del parts
            incoming = self.rehash_dense(contrib, algo.combiner, mesh)
            n_padded = contrib.shape[1]
            del contrib
            new_state, live = apply_all(algo.apply_dense, partial, incoming,
                                        stratum)
            emitted, live = reduced(torch.stack(
                [_i32(active.to(torch.int32).sum()), live]), "sum")
            return new_state, StratumOutcome(
                live_count=live, used_dense=True,
                rehash_bytes=_f32(S * n_padded * algo.payload_width * 4),
                emitted=emitted, tier=-1, route=-1)

        bodies = [make_sparse_body(t, i) for i, t in enumerate(tiers)]

        def stratum(state, stratum_idx):
            found = [algo.active_fn(_take(state, i), imm[i]) for i in shards]
            active = torch.stack([f[0] for f in found])
            if mode == "nodelta":
                return dense_body(state, stratum_idx, active)
            # Smallest rung whose budgets cover the exact predicted sizes;
            # one host read of (max sources, max edges) per stratum, the
            # same on every rank.  The seg budget is guarded too: one
            # shard's emission can land entirely in one destination
            # segment.
            max_src, max_edges = reduced(torch.stack([
                active.to(torch.int32).sum(1).max(),
                torch.stack([f[1] for f in found]).max().to(torch.int32),
            ]), "max").tolist()
            branch = sum(1 for t in tiers
                         if not (max_src <= t.src
                                 and max_edges <= min(t.edge, t.seg)))
            if branch == len(tiers):
                return dense_body(state, stratum_idx, active)
            return bodies[branch](state, stratum_idx, active)

        fn = stratum
        if tracer is not None:
            def fn(state, stratum_idx):
                tracer.stratum_begin(device)
                new_state, outcome = stratum(state, stratum_idx)
                tracer.stratum_probe(stratum_idx, outcome)
                return new_state, outcome

        if explicit_cond is None:
            return fn

        def cond(new, old, i):
            # Over the global states, so every rank decides alike, and as
            # the simulated backend decides.
            return explicit_cond(_gathered(new, mesh), _gathered(old, mesh),
                                 i)

        return with_explicit_condition(fn, cond)


def _n_local(tree) -> int:
    """The length of ``tree``'s leading shard axis."""
    return _first_tensor(tree).shape[0]


def _map(tree, fn):
    """``fn`` over every tensor of a tensor / NamedTuple / dataclass."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        parts = [_map(x, fn) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _map(getattr(tree, f.name), fn)
                             for f in dataclasses.fields(tree)})
    return tree


def _local(tree, mesh):
    """This rank's block of a global [S, ...] tree, on its device (a view
    of the whole tree on the simulated backend)."""
    from repro_torch.launch.mesh import local_shards
    r = local_shards(mesh)
    return _map(tree, lambda t: t[r.start:r.stop].to(mesh.device))


def _gathered(tree, mesh):
    """Every rank's block of ``tree`` concatenated into the global tree."""
    return _map(tree, mesh.all_gather)


def _first_tensor(tree) -> torch.Tensor:
    if torch.is_tensor(tree):
        return tree
    parts = (tree if isinstance(tree, tuple) else
             [getattr(tree, f.name) for f in dataclasses.fields(tree)])
    return _first_tensor(next(p for p in parts
                              if torch.is_tensor(p) or isinstance(p, tuple)
                              or dataclasses.is_dataclass(p)))


def _device_of(tree) -> torch.device:
    """The device of the first tensor in ``tree``."""
    return _first_tensor(tree).device


def _f32(x) -> float:
    """``x`` rounded to float32 (the reference keeps rehash bytes in f32)."""
    return torch.tensor(x, dtype=torch.float32).item()
