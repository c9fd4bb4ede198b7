"""Cost-based optimizer (paper §5) — IR-to-IR rewrites over core/plan.py.

Implements the three optimizer contributions as rewrite passes the frontend
compiler (repro_torch.frontend) runs over every plan:

  1. **UDF/join interleaving by rank** (§5.1, after Hellerstein &
     Stonebraker's predicate migration): expensive predicates over the same
     relation are applied in increasing rank = cost_per_tuple / (1 −
     selectivity); interleavings with joins are enumerated branch-and-bound
     under the resource-vector overlap model.  :func:`interleave_udf_joins`
     applies this as a tree rewrite wherever a chain of *independent*
     (non-``pinned``) UDFs surrounds a join.
  2. **UDA pre-aggregation pushdown** (§5.2): a composable UDA's combiner is
     pushed below rehash and joins (below any join if composable; only below
     key–FK joins otherwise), at most one pre-aggregation per UDA, maximally
     pushed.  Multiplicative joins are compensated with the ``multiply``
     UDF by inserting the opposite side's count(*).
  3. **Recursive cost estimation** (§5.3 + §6): fixpoint nodes re-run their
     simulated-iteration estimate after the child subplans were rewritten,
     taking the delta-retraction decay path for idempotent combiners.

Per-tuple cost constants live in :class:`CostModel`.  The defaults are the
hand-calibrated static values; :meth:`CostModel.from_route_table` derives
the routed-tuple cost from a *measured* ``obs/calibrate.py:RouteCostTable``
instead, so plan costing and the executor's rung dispatch
(``route_strategy="measured"``) share one calibration source.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import plan as _plan
from repro_torch.core.plan import (PlanNode, plan_runtime, preagg, rehash,
                                   sequential_combine, total_resource,
                                   runtime_of)


# ---------------------------------------------------------------------------
# Cost model: static constants or measured calibration.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-tuple cost constants consulted by the rewrite passes (and by the
    frontend planner when building nodes)."""

    rehash_net_per_tuple: float = 2e-8
    join_cpu_per_tuple: float = 5e-9
    agg_cpu_per_tuple: float = 4e-9
    scan_disk_per_tuple: float = 1e-8
    source: str = "static"

    @classmethod
    def from_route_table(cls, table, **overrides) -> "CostModel":
        """Derive the routed-tuple network cost from a measured
        :class:`repro_torch.obs.calibrate.RouteCostTable` (median over its
        rungs of the cheaper strategy's per-tuple cost); everything not
        measured keeps the static default.  The table's backend (``"cpu"``
        or ``"cuda:<card>"``) stamps ``source``."""
        kw = dict(rehash_net_per_tuple=table.median_per_tuple(),
                  source=f"measured:{table.backend}")
        kw.update(overrides)
        return cls(**kw)


DEFAULT_COST_MODEL = CostModel()


# ---------------------------------------------------------------------------
# §5.1 — rank ordering of expensive UDFs.
# ---------------------------------------------------------------------------

def order_udfs_by_rank(udfs: Sequence[PlanNode]) -> List[PlanNode]:
    """Optimal application order of independent expensive predicates over one
    relation: increasing rank (cheap or highly selective first)."""
    return sorted(udfs, key=lambda u: u.rank())


def apply_udf_chain(base: PlanNode, udfs: Sequence[PlanNode]) -> PlanNode:
    """Rebuild a select/UDF chain over ``base`` with recomputed stats."""
    node = base
    for u in udfs:
        card_in = node.out_cardinality
        cpu = card_in * u.cost_per_tuple * (0.8 if u.deterministic else 1.0)
        node = u.clone(children=(node,),
                       out_cardinality=card_in * u.selectivity,
                       resource=(cpu, 0.0, 0.0))
    return node


def best_udf_join_interleaving(base: PlanNode, udfs: Sequence[PlanNode],
                               join_builder, join_positions: int
                               ) -> Tuple[PlanNode, float]:
    """Enumerate where the join sits within the rank-ordered UDF chain.

    The rank ordering fixes the relative order of the UDFs (provably optimal
    for same-relation predicates); the remaining freedom — which prefix runs
    before the join — is linear, so we scan all split points with
    branch-and-bound on the overlap-model runtime.

    join_builder(node) -> PlanNode wrapping ``node`` in the join.
    """
    ordered = order_udfs_by_rank(udfs)
    best_plan, best_cost = None, float("inf")
    for split in range(len(ordered) + 1):
        pre, post = ordered[:split], ordered[split:]
        node = apply_udf_chain(base, pre)
        node = join_builder(node)
        node = apply_udf_chain(node, post)
        cost = plan_runtime(node)
        if cost < best_cost - 1e-15:
            best_plan, best_cost = node, cost
        elif cost > best_cost * 4:  # bound: later splits only defer more work
            pass
    return best_plan, best_cost


def interleave_udf_joins(node: PlanNode,
                         cost_model: Optional[CostModel] = None) -> PlanNode:
    """IR rewrite (§5.1): wherever a chain of independent UDFs sits around a
    join — some directly above it, some on its probe (left) input — re-split
    the rank-ordered chain across the join at the cheapest point.

    ``pinned`` UDFs (frontend-semantic nodes like the recursive value view
    or the rule term, whose outputs feed each other) are never reordered;
    a pinned node terminates the chain walk on both sides.
    """
    cm = cost_model or DEFAULT_COST_MODEL
    new_children = tuple(interleave_udf_joins(c, cm) for c in node.children)
    if new_children != tuple(node.children):
        node = node.clone(children=new_children)

    above: List[PlanNode] = []
    cur = node
    while (cur.op == "udf" and not cur.pinned and len(cur.children) == 1):
        above.append(cur)
        cur = cur.children[0]
    if cur.op != "join":
        return node
    join_node = cur
    below: List[PlanNode] = []
    lc = join_node.children[0]
    while lc.op == "udf" and not lc.pinned and len(lc.children) == 1:
        below.append(lc)
        lc = lc.children[0]
    udfs = above + below
    if not udfs:
        return node
    base, right = lc, join_node.children[1]

    def join_builder(n: PlanNode) -> PlanNode:
        card_left = n.out_cardinality
        if join_node.key_fk_join:
            card = card_left * join_node.selectivity
        else:
            card = (card_left * max(right.out_cardinality, 1.0)
                    * join_node.selectivity)
        cpu = (card_left + right.out_cardinality) * cm.join_cpu_per_tuple
        return join_node.clone(children=(n, right), out_cardinality=card,
                               resource=(cpu, 0.0, 0.0))

    best, cost = best_udf_join_interleaving(base, udfs, join_builder, 1)
    # Strictly-better guard keeps the pass idempotent (re-running on an
    # already-optimal chain is a no-op, not a cosmetic reshuffle).
    if best is not None and cost < plan_runtime(node) - 1e-15:
        return best
    return node


# ---------------------------------------------------------------------------
# §5.2 — pre-aggregation pushdown.
# ---------------------------------------------------------------------------

def push_preaggregation(node: PlanNode, reduction: float = 0.1,
                        cost_model: Optional[CostModel] = None) -> PlanNode:
    """Push one combiner per UDA maximally below rehash / eligible joins.

    Rules (paper §5.2):
      * composable UDA           → may cross any join and any rehash;
      * non-composable UDA       → may cross a key–FK join only;
      * non-composable, non-FK   → no pushdown;
      * at most ONE pre-aggregation per UDA, maximally pushed;
      * crossing a non-FK join with a cardinality-dependent UDA requires a
        ``multiply`` compensation (caller sets has_multiply).
    """
    cm = cost_model or DEFAULT_COST_MODEL
    if node.op != "groupby":
        return node.clone(children=tuple(
            push_preaggregation(c, reduction, cm) for c in node.children))

    child = node.children[0]
    # Descend while crossing is legal, tracking the deepest legal spot.
    path: List[PlanNode] = []
    cur = child
    while True:
        if cur.op == "preagg":
            # Already pushed (at most one pre-aggregation per UDA): the
            # rewrite is idempotent.
            return node
        if cur.op == "rehash":
            path.append(cur)
            cur = cur.children[0]
            continue
        if cur.op == "join":
            legal = node.composable or cur.key_fk_join
            needs_mult = (not cur.key_fk_join) and node.composable
            if legal and (not needs_mult or node.has_multiply):
                path.append(cur)
                cur = cur.children[0]   # push down the probe (left) side
                continue
        break
    if not path:
        return node  # nothing to cross — pre-agg would be a no-op locally

    combined = preagg(cur, node.uda_name or "sum", reduction,
                      cpu_per_tuple=cm.agg_cpu_per_tuple,
                      combiner=node.combiner)
    # Rebuild the crossed spine above the combiner.
    rebuilt = combined
    for spine in reversed(path):
        new_children = (rebuilt,) + tuple(spine.children[1:])
        card = rebuilt.out_cardinality
        if spine.op == "rehash":
            res = (0.0, 0.0, card * cm.rehash_net_per_tuple)
            rebuilt = spine.clone(children=new_children, out_cardinality=card,
                                  resource=res)
        else:  # join
            if spine.key_fk_join:
                card_out = card * spine.selectivity
            else:
                right = spine.children[1].out_cardinality
                card_out = card * max(right, 1.0) * spine.selectivity
            cpu = (card + spine.children[1].out_cardinality) \
                * cm.join_cpu_per_tuple
            rebuilt = spine.clone(children=new_children,
                                  out_cardinality=card_out,
                                  resource=(cpu, 0.0, 0.0))
    return node.clone(children=(rebuilt,))


# ---------------------------------------------------------------------------
# §5.3 — recursive cost estimation.
# ---------------------------------------------------------------------------

def estimate_recursive_cost(base_cost: float, base_card: float,
                            step_cost_fn, step_card_fn,
                            max_iters: int = 64) -> Tuple[float, float, int]:
    """Simulated-iteration estimator with the paper's monotone caps.

    step_cost_fn(card_in) -> cost of one recursive stratum
    step_card_fn(card_in) -> estimated Δ cardinality emitted by the stratum

    Divergence guard: per-step cost and cardinality are capped at the
    previous step's values (convergence focus + fixpoint dedup), so a bad
    hint (e.g. ×2 growth) cannot explode the estimate.
    Returns (total_cost, final_cardinality, iterations_estimated).
    """
    total = base_cost
    card = base_card
    prev_cost = float("inf")
    iters = 0
    for i in range(max_iters):
        if card < 1.0:
            break
        cost = step_cost_fn(card)
        new_card = step_card_fn(card)
        # Monotone caps (paper §5.3).
        cost = min(cost, prev_cost)
        new_card = min(new_card, card)
        total += cost
        prev_cost = cost
        card = new_card
        iters += 1
    return total, card, iters


def refresh_fixpoint_estimates(node: PlanNode) -> PlanNode:
    """Re-run every fixpoint node's simulated-iteration estimate bottom-up,
    so rewrites below it (pre-agg pushdown, interleaving) are reflected in
    its per-stratum cost — and the idempotent delta-retraction decay
    (paper §6) is applied from the fixpoint's combiner annotation."""
    new_children = tuple(refresh_fixpoint_estimates(c)
                         for c in node.children)
    if node.op == "fixpoint":
        return _plan.fixpoint(new_children[0], new_children[1],
                              max_iters=node.max_iters or 64,
                              combiner=node.combiner)
    if new_children != tuple(node.children):
        return node.clone(children=new_children)
    return node


# ---------------------------------------------------------------------------
# Whole-plan entry point.
# ---------------------------------------------------------------------------

def optimize(node: PlanNode, preagg_reduction: float = 0.1,
             cost_model: Optional[CostModel] = None) -> PlanNode:
    """The compilation rewrite pipeline: UDF/join interleaving by rank,
    pre-aggregation pushdown, fixpoint cost refresh.  Idempotent:
    ``optimize(optimize(p)) == optimize(p)``."""
    cm = cost_model or DEFAULT_COST_MODEL
    out = interleave_udf_joins(node, cm)
    out = push_preaggregation(out, reduction=preagg_reduction, cost_model=cm)
    out = refresh_fixpoint_estimates(out)
    return out


def worst_case_node_cost(per_node_costs: Sequence[float]) -> float:
    """Many-node estimation (paper §5): the stratum completes when the
    slowest shard finishes — the engine models completion as the max."""
    return max(per_node_costs)
