"""Planner: rule :class:`Program` → typed logical-plan IR (core/plan.py).

One recursive aggregation rule becomes the canonical REX plan shape:

    fixpoint[combiner]
    ├── scan(head)                                  # base facts / inits
    └── group_aggregate[combiner, by dst]           # fold into head state
        └── rehash(dst)                             # ship deltas to owners
            └── project(dst, val)
                └── udf[term]                       # scalar rule term
                    └── join(Δhead ⋈ edge)          # key–fk, fan-out = deg
                        ├── udf[view]               # optional value view
                        │   └── select[active]      # |Δ| under threshold gate
                        │       └── scan(Δhead)
                        └── scan(edge)

The frontend-semantic UDF nodes (``view:*`` and ``term``) are *pinned*: the
optimizer's rank-based interleaving must not float them across the join —
the view feeds the term, and both define what the program computes.  The
optimizer still rewrites everything else: pre-aggregation pushes below the
rehash (sender-side combining, paper §5.2), and the fixpoint estimate picks
the delta-retraction path for idempotent combiners (§6).

Statistics come from :class:`GraphStats` (defaults model the paper's mid-size
graphs) and the cost coefficients from ``optimizer.CostModel`` — pass one
built via ``CostModel.from_route_table`` to cost plans with *measured*
per-tuple route costs (obs/calibrate.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import plan as P
from repro_torch.core.optimizer import DEFAULT_COST_MODEL, CostModel
from repro_torch.frontend.rules import FrontendError, Program

#: CPU seconds per tuple for a scalar arithmetic UDF (a handful of flops).
_SCALAR_UDF_COST = 2e-9


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Planner statistics for the (single) edge input."""

    n_vertices: float = 1e5
    avg_degree: float = 16.0
    #: expected fraction of vertices active per stratum (|Δ| / |V|).
    delta_fraction: float = 0.25


def plan_program(program: Program, stats: Optional[GraphStats] = None,
                 cost_model: Optional[CostModel] = None) -> P.Fixpoint:
    """Build the logical plan for ``program`` (one recursive rule)."""
    stats = stats or GraphStats()
    cm = cost_model or DEFAULT_COST_MODEL
    if len(program.rules) != 1:
        raise NotImplementedError(
            f"planner supports exactly one recursive rule, got "
            f"{len(program.rules)} (multi-rule stratification is not "
            "implemented)")
    rule = program.rules[0]
    view = program.view_for(rule.head)

    V = stats.n_vertices
    E = V * stats.avg_degree

    base = P.scan(rule.head, V, disk_per_tuple=cm.scan_disk_per_tuple,
                  schema=(rule.dst, "val"))

    delta = P.scan(f"delta:{rule.head}", V,
                   disk_per_tuple=cm.scan_disk_per_tuple,
                   schema=(rule.src, "val"))
    active = P.select(delta, name="active",
                      selectivity=stats.delta_fraction,
                      expr=program.threshold)
    probe: P.PlanNode = active
    if view is not None:
        probe = P.udf(probe, name=f"view:{view.rel}",
                      cost_per_tuple=_SCALAR_UDF_COST, expr=view.expr,
                      pinned=True, schema=(rule.src, "val"))
    edges = P.scan(rule.edge, E, disk_per_tuple=cm.scan_disk_per_tuple,
                   schema=(rule.src, rule.dst))
    joined = P.join(probe, edges, selectivity=stats.avg_degree, key_fk=True,
                    cpu_per_tuple=cm.join_cpu_per_tuple)
    termed = P.udf(joined, name="term", cost_per_tuple=_SCALAR_UDF_COST,
                   expr=rule.term, pinned=True)
    shaped = P.project(termed, (rule.dst, "val"))
    shipped = P.rehash(shaped, net_per_tuple=cm.rehash_net_per_tuple)
    folded = P.group_aggregate(shipped, key=rule.dst, combiner=rule.agg,
                               n_groups=V,
                               cpu_per_tuple=cm.agg_cpu_per_tuple)
    return P.fixpoint(base, folded, max_iters=64, combiner=rule.agg)
