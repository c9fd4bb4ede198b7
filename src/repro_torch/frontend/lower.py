"""Lowering: optimized logical plan → the five ``DeltaAlgorithm`` callables.

``compile_program`` runs the full frontend pipeline

    Program ──planner──▶ plan IR ──optimizer──▶ optimized IR ──lower──▶
    CompiledProgram (DeltaAlgorithm factory + initial state + value view)

and the resulting algorithm plugs into ``core/engine.py:ShardedExecutor``
unchanged — compiled programs inherit the capacity ladder (``emit_factory``),
route_strategy dispatch (and with it the scatter_route and delta_route
kernels), the resilient driver and observability for free.

The generic recursive state is the pair ``(store, sent)``:

  * ``store`` — the aggregation-head relation (one f32 per vertex), seeded
    from the combiner identity, then the ``:=`` initializer / ground facts;
  * ``sent`` — the *value* each vertex last propagated, in value space
    (``value = view(store)`` when the program defines a view, else the
    store itself).

Per combiner the stratum semantics follow the handwritten algorithms
exactly (and are tested bit-identical to them):

  * ``add`` — a vertex is active when ``|value − sent|`` exceeds the
    program threshold; the emitted term is evaluated on the *retained
    delta* ``value − sent`` (sound because we require the term to be
    homogeneous-linear in the recursive relation: ``T(a) − T(b) = T(a−b)``);
    receivers fold with ``+``; dense strata re-derive and REPLACE.
  * ``min`` / ``max`` (idempotent) — active when the value improved since
    last send; the term is evaluated on the value itself and folded with
    minimum/maximum; superseded deltas simply lose the fold (paper §6).

The shard-local relational steps route through ``core/operators.py`` Table
ops (``applyFunction`` for the view and the rule term, ``select`` for the
Δ-activity predicate); emission reuses ``algorithms/emission.py`` like
every handwritten algorithm does.  With ``use_kernels`` the sparse apply
folds through ``kernels/delta_scatter`` (the incoming buffer's global keys,
``key_base`` the shard's first key) and the dense body pushes through
``kernels/edge_propagate`` over a ragged CSC that each ``make_algorithm``
caches afresh per shard and graph; otherwise the torch-op functions of
``emission.py`` run.

Rounding inside the strata.  The reference compiles its strata, and its
compiler (XLA on the CPU) contracts a multiply that feeds an add or a
subtract into one fused multiply-add, while ``values`` runs outside the
strata and rounds each step.  So the five callables evaluate the view and
the rule term through :func:`evaluate_contracted`, which follows the
compiler's choices as read from the reference's output
(``tests/test_torch_frontend_fma.py``): a constant-only subtree is one
float32 constant; ``a * b + c``, ``c + a * b``, ``a * b - c`` and
``c - a * b`` round once (computed in float64, where a float32 product is
exact, then rounded to float32, as ``algorithms/pagerank.current_pr``
does); ``a * b - c * d`` fuses the left product, and ``a * b + c * d`` the
one that reads the recursive relation; in the nodelta strata a product of
deg() and constants alone rounds by itself (the compiler hoists it out of
the loop).  :meth:`CompiledProgram.values` evaluates step by step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.algorithms import emission
from repro_torch.core import operators
from repro_torch.core import plan as P
from repro_torch.core.delta import DeltaBuffer, _i32
from repro_torch.core.engine import DeltaAlgorithm, ShardedExecutor
from repro_torch.core.fixpoint import FixpointResult
from repro_torch.core.optimizer import CostModel, optimize
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.frontend import expr as E
from repro_torch.frontend.planner import GraphStats, plan_program
from repro_torch.frontend.rules import FrontendError, Program
from repro_torch.kernels.edge_propagate import CSCCache, edge_propagate

_IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf")}


def _as_col(val, like: torch.Tensor) -> torch.Tensor:
    """Coerce a scalar term result (constant-only rule) to a column; leave
    tensor results untouched so the compiled arithmetic stays
    token-identical to the handwritten algorithms."""
    if getattr(val, "shape", None) == like.shape:
        return val
    return torch.broadcast_to(
        torch.as_tensor(val, dtype=like.dtype, device=like.device),
        like.shape).clone()


def _const_only(expr: E.Expr) -> bool:
    return not E.refs(expr)


def _invariant(expr: E.Expr) -> bool:
    """Reads deg() and constants alone: the same in every stratum."""
    return {r.rel for r in E.refs(expr)} <= {"deg"}


def _wide(x):
    """``x`` in float64 (a float32 tensor or product is exact there)."""
    return x.double() if torch.is_tensor(x) else x


def evaluate_contracted(expr: E.Expr, env, hoisted: bool = False):
    """:func:`expr.evaluate` under the contraction rule of the reference's
    compiled strata (module docstring).

    A constant-only subtree folds in Python floats and rounds to float32
    once.  A ``+`` or ``-`` node with a product operand rounds once, the
    product and the sum taken in float64.  With two products, ``-`` fuses
    its left one, and ``+`` the one that reads the recursive relation
    (else its left one).  ``hoisted``: a product of deg() and constants
    alone rounds by itself, as it does where the reference's compiler
    hoists it out of the fixpoint loop (the nodelta strata)."""
    if _const_only(expr):
        return float(np.float32(E.evaluate(expr, {})))
    if not isinstance(expr, E.BinOp):
        return E.evaluate(expr, env)
    lhs, rhs = expr.lhs, expr.rhs

    def fusable(e):
        return (isinstance(e, E.BinOp) and e.op == "*"
                and not _const_only(e) and not (hoisted and _invariant(e)))

    if expr.op in ("+", "-") and (fusable(lhs) or fusable(rhs)):
        right = not fusable(lhs) or (
            expr.op == "+" and fusable(rhs) and _invariant(lhs)
            and not _invariant(rhs))
        prod, other = (rhs, lhs) if right else (lhs, rhs)
        sign = -1.0 if right and expr.op == "-" else 1.0
        a, b, c = (evaluate_contracted(e, env, hoisted)
                   for e in (prod.lhs, prod.rhs, other))
        like = next(x for x in (a, b, c) if torch.is_tensor(x))
        ab = _wide(a) * _wide(b) * sign
        return (ab - _wide(c) if expr.op == "-" and not right
                else ab + _wide(c)).to(like.dtype)
    return E._OPS[expr.op](evaluate_contracted(lhs, env, hoisted),
                           evaluate_contracted(rhs, env, hoisted))


@dataclasses.dataclass(frozen=True)
class LoweredSpec:
    """Everything lowering needs, extracted from the *optimized* plan."""

    combiner: str                 # add | min | max
    threshold: float              # add-combiner convergence threshold
    head: str                     # aggregation-head relation (the store)
    value_rel: str                # relation the rule term references
    term: E.Expr                  # scalar rule term (in value space)
    view: Optional[E.Expr]        # value = view(store), None = identity


def _extract_spec(program: Program, optimized: P.PlanNode) -> LoweredSpec:
    if optimized.op != "fixpoint":
        raise FrontendError("optimized plan root must be a fixpoint node")
    rule = program.rules[0]
    combiner = optimized.combiner
    if combiner not in ("add", "min", "max"):
        raise FrontendError(f"fixpoint combiner {combiner!r} is not lowerable")

    view_expr = None
    view_rel = None
    term_expr = None
    for node in P.walk(optimized):
        if node.op != "udf" or node.expr is None:
            continue
        if node.name.startswith("view:"):
            view_expr, view_rel = node.expr, node.name[len("view:"):]
        elif node.name == "term":
            term_expr = node.expr
    if term_expr is None:
        raise FrontendError("optimized plan lost the rule-term UDF")

    value_rel = view_rel if view_expr is not None else rule.head

    # --- semantic validation (what this lowering can and cannot express) ---
    if view_expr is not None and combiner in P.IDEMPOTENT_COMBINERS:
        raise NotImplementedError(
            f"a value view over an idempotent ({combiner}) head is not "
            "supported: min/max propagate the store itself")
    bad = {r.rel for r in E.refs(term_expr)} - {value_rel, "deg"}
    if bad:
        raise FrontendError(
            f"rule term may only reference {value_rel!r} and deg(); "
            f"got {sorted(bad)}")
    if combiner == "add" and E.degree_in(term_expr, {value_rel}) != 1:
        raise FrontendError(
            f"add-aggregation term must be homogeneous-linear in "
            f"{value_rel!r} (T(a) - T(b) = T(a - b)) for the delta rewrite "
            "to be sound; rewrite constants into a view "
            "(e.g. PageRank: acc(v) add= rank(u)/deg(u), "
            "rank(v) = 0.15 + 0.85 * acc(v))")
    if view_expr is not None:
        bad = {r.rel for r in E.refs(view_expr)} - {rule.head}
        if bad:
            raise FrontendError(
                f"view may only reference the aggregation head "
                f"{rule.head!r}; got {sorted(bad)}")
    for init in program.inits:
        if init.rel != rule.head:
            raise FrontendError(
                f"initializer for {init.rel!r} does not seed the "
                f"aggregation head {rule.head!r}")
        bad = {r.rel for r in E.refs(init.expr)} - {"id"}
        if bad:
            raise FrontendError(
                f"initializer may only reference id(); got {sorted(bad)}")
    for fact in program.facts:
        if fact.rel != rule.head:
            raise FrontendError(
                f"fact for {fact.rel!r} does not seed the aggregation "
                f"head {rule.head!r}")
        if fact.key < 0:
            raise FrontendError(f"fact key must be non-negative: {fact.key}")

    return LoweredSpec(combiner=combiner, threshold=program.threshold,
                       head=rule.head, value_rel=value_rel, term=term_expr,
                       view=view_expr)


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """A rule program carried through plan → optimize → lower."""

    program: Program
    logical: P.Fixpoint           # planner output (pre-optimization)
    optimized: P.PlanNode         # optimizer output (what lowering consumed)
    spec: LoweredSpec

    @property
    def combiner(self) -> str:
        return self.spec.combiner

    # ------------------------------------------------------------------
    # Value view (store space -> user-visible value space).
    # ------------------------------------------------------------------
    def _view_of(self, store: torch.Tensor) -> torch.Tensor:
        """The view inside the strata (contracted; module docstring)."""
        spec = self.spec
        if spec.view is None:
            return store
        tbl = operators.apply_function(
            operators.Table.from_columns(store=store),
            lambda s: {"cur": evaluate_contracted(spec.view, {spec.head: s})},
            ("store",))
        return tbl.column("cur")

    def values(self, state) -> torch.Tensor:
        """User-visible per-vertex values from an executor state (the view
        evaluated step by step)."""
        store = state[0]
        if self.spec.view is None:
            return store.reshape(-1)
        return E.evaluate(self.spec.view,
                          {self.spec.head: store}).reshape(-1)

    # ------------------------------------------------------------------
    # Initial state.
    # ------------------------------------------------------------------
    def initial_state(self, snapshot: PartitionSnapshot, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(store, sent) on ``device`` (None = CUDA; raises without it).  A
        fact at a key of no shard (``>= S * block``) is dropped, as the
        reference's out-of-bounds set is."""
        dev = resolve_device(device)
        S, block = snapshot.num_shards, snapshot.block_size
        fill = _IDENTITY[self.spec.combiner]
        store = torch.full((S, block), fill, dtype=torch.float32,
                           device=dev)
        init = self.program.init_for(self.spec.head)
        if init is not None:
            ids = torch.arange(S * block, dtype=torch.float32,
                               device=dev).reshape(S, block)
            store = _as_col(E.evaluate(init.expr, {"id": ids}), store)
        for fact in self.program.facts_for(self.spec.head):
            if fact.key < S * block:
                store[fact.key // block, fact.key % block] = fact.value
        sent = torch.full((S, block), fill, dtype=torch.float32, device=dev)
        return store, sent

    # ------------------------------------------------------------------
    # DeltaAlgorithm emission.
    # ------------------------------------------------------------------
    def make_algorithm(self, snapshot: PartitionSnapshot,
                       src_capacity: int = 1024, edge_capacity: int = 16384,
                       use_kernels: bool = True) -> DeltaAlgorithm:
        spec = self.spec
        block = snapshot.block_size
        n_padded = snapshot.padded_keys
        combiner = spec.combiner
        threshold = spec.threshold
        fill = _IDENTITY[combiner]
        view_of = self._view_of
        csc = CSCCache(n_padded)   # ragged CSC per shard, kept per graph

        if combiner == "add":
            def activity(t):
                return torch.abs(t.column("cur") - t.column("sent")) \
                    > threshold
        elif combiner == "min":
            def activity(t):
                return t.column("cur") < t.column("sent")
        else:
            def activity(t):
                return t.column("cur") > t.column("sent")

        def active_mask(cur, sent):
            tbl = operators.Table.from_columns(cur=cur, sent=sent)
            return operators.select(tbl, activity).valid

        def next_count(store, sent):
            return _i32(active_mask(view_of(store), sent).sum())

        # The out-degree column only for a term that reads deg(): eager
        # torch would launch its clamp and cast in every stratum.
        uses_deg = any(r.rel == "deg" for r in E.refs(spec.term))

        def term_payload(value_col, graph: CSRGraph, hoisted=False):
            cols = {"value": value_col}
            if uses_deg:
                cols["deg"] = torch.clamp(graph.out_degree, min=1).to(
                    value_col.dtype)
            tbl = operators.apply_function(
                operators.Table.from_columns(**cols),
                lambda v, d=None: {"payload": _as_col(
                    evaluate_contracted(spec.term,
                                        {spec.value_rel: v, "deg": d},
                                        hoisted), v)},
                tuple(cols))
            return tbl.column("payload")

        def active_fn(state, graph: CSRGraph):
            store, sent = state
            active = active_mask(view_of(store), sent)
            est_edges = _i32(torch.where(active, graph.out_degree, 0).sum())
            return active, est_edges

        def make_sparse_emit(src_cap: int, edge_cap: int):
            def sparse_emit(state, graph: CSRGraph, active, stratum,
                            shard_id):
                store, sent = state
                cur = view_of(store)
                # add: emit the retained delta (cur − sent) through the
                # (homogeneous-linear) term; idempotent: emit the value.
                value_col = cur - sent if combiner == "add" else cur
                payload = torch.where(active, term_payload(value_col, graph),
                                      fill)
                out = emission.emit_over_edges(graph, active, payload,
                                               src_cap, edge_cap)
                new_sent = torch.where(active, cur, sent)
                return (store, new_sent), out
            return sparse_emit

        def make_dense_emit(hoisted: bool):
            def dense_emit(state, graph: CSRGraph, stratum, shard_id):
                store, sent = state
                cur = view_of(store)
                payload = term_payload(cur, graph, hoisted)
                if use_kernels:
                    contrib = edge_propagate(
                        payload, csc.get(shard_id, graph), combiner)
                else:
                    dst, pay = emission.dense_push(graph, payload)
                    contrib = emission.fold(
                        pay.new_full((n_padded, 1), fill), dst,
                        pay[:, None], combiner)[:, 0]
                return (store, cur), contrib[:, None]
            return dense_emit

        def fold_sparse(store, incoming: DeltaBuffer, shard_id):
            if not use_kernels:
                inc = emission.scatter_local(incoming, shard_id, block,
                                             combiner)
                if combiner == "add":
                    return store + inc
                return (torch.minimum if combiner == "min"
                        else torch.maximum)(store, inc)
            from repro_torch.kernels.delta_scatter import delta_scatter
            keys = incoming.keys.contiguous()
            if combiner == "add":
                # Fold into a zero block, then store + inc: the reference's
                # order of operations, so sums round the same way.
                inc = delta_scatter(store.new_zeros((block, 1)), keys,
                                    incoming.payload.contiguous(),
                                    key_base=shard_id * block)
                return store + inc[:, 0]
            return delta_scatter(store[:, None].contiguous(), keys,
                                 incoming.payload[:, :1].contiguous(),
                                 combiner, key_base=shard_id * block)[:, 0]

        def apply_sparse(state, incoming: DeltaBuffer, graph: CSRGraph,
                         stratum, shard_id):
            store, sent = state
            store = fold_sparse(store, incoming, shard_id)
            return (store, sent), next_count(store, sent)

        def apply_dense(state, incoming: torch.Tensor, graph: CSRGraph,
                        stratum, shard_id):
            store, sent = state
            if combiner == "add":   # dense strata re-derive: REPLACE
                store = incoming[:, 0]
            elif combiner == "min":
                store = torch.minimum(store, incoming[:, 0])
            else:
                store = torch.maximum(store, incoming[:, 0])
            return (store, sent), next_count(store, sent)

        return DeltaAlgorithm(
            active_fn=active_fn,
            sparse_emit=make_sparse_emit(src_capacity, edge_capacity),
            dense_emit=make_dense_emit(False), apply_sparse=apply_sparse,
            apply_dense=apply_dense, combiner=combiner, payload_width=1,
            bytes_per_delta=8, emit_factory=make_sparse_emit,
            # The nodelta stratum is the reference's loop body itself, so
            # its compiler hoists the term's deg()-only products.
            nodelta_dense_emit=make_dense_emit(True))

    # ------------------------------------------------------------------
    # End-to-end driver (mirrors algorithms/*.run).
    # ------------------------------------------------------------------
    def run(self, graph_sharded: CSRGraph, snapshot: PartitionSnapshot,
            mode: str = "delta", max_iters: int = 64,
            executor: Optional[ShardedExecutor] = None,
            src_capacity: int = 1024, edge_capacity: int = 16384,
            ladder_tiers: int = 1, route_strategy: str = "sort",
            device=None, use_kernels: bool = True
            ) -> Tuple[torch.Tensor, FixpointResult]:
        """Run the program on ``device`` (None = CUDA; raises without it);
        returns (values [padded_keys], FixpointResult)."""
        dev = resolve_device(device)
        graph = graph_sharded.to(dev)
        algo = self.make_algorithm(snapshot, src_capacity, edge_capacity,
                                   use_kernels=use_kernels)
        if executor is None:
            executor = ShardedExecutor(
                snapshot=snapshot, seg_capacity=edge_capacity,
                edge_capacity=edge_capacity, src_capacity=src_capacity,
                ladder_tiers=ladder_tiers, route_strategy=route_strategy,
                use_kernels=use_kernels)
        state0 = self.initial_state(snapshot, dev)
        live0 = executor.live_count(algo, state0, graph)
        res = executor.run(algo, state0, live0, graph, max_iters, mode=mode)
        return self.values(res.state), res


def compile_program(program: Program, stats: Optional[GraphStats] = None,
                    cost_model: Optional[CostModel] = None,
                    preagg_reduction: float = 0.1) -> CompiledProgram:
    """Plan, optimize and lower a rule program."""
    logical = plan_program(program, stats=stats, cost_model=cost_model)
    optimized = optimize(logical, preagg_reduction=preagg_reduction,
                         cost_model=cost_model)
    spec = _extract_spec(program, optimized)
    return CompiledProgram(program=program, logical=logical,
                           optimized=optimized, spec=spec)
