"""Typed logical-plan IR for RQL-style queries (paper §3.2, §5).

A plan is a DAG of typed operator nodes — scan / select / project / apply
(UDF) / join / group-aggregate / pre-aggregate / rehash / fixpoint — each
carrying an output *schema* (column names), an optional *combiner*
annotation (``add``/``min``/``max`` for aggregation and fixpoint nodes) and
the per-operator cost metadata the optimizer works on.  The frontend
(repro_torch.frontend) builds these plans from rule programs; the optimizer
(core/optimizer.py) rewrites them IR-to-IR (UDF/join interleaving by rank,
pre-aggregation pushdown, fixpoint cost refresh); the lowering pass
(frontend/lower.py) emits ``DeltaAlgorithm`` callables from the optimized
plan via core/operators.py Table ops.  A copy of the reference package's
``core/plan.py``: the port imports nothing of it.

Costs follow the paper's model: per-operator (cpu, disk, net) *resource
vectors* (§5 "Accounting for CPU-I/O overlap") — combining two concurrent
subplans costs the max over each resource lane, not the sum.

Recursive cost (§5.3 + §6): :func:`fixpoint` runs a simulated-iteration
estimate at construction.  A monotone-``add`` accumulator conservatively
assumes the Δ set does not shrink (every stratum re-touches the full
frontier); an *idempotent* combiner (``min``/``max``) takes the
delta-retraction path — superseded deltas retract, so |Δᵢ| decays
geometrically and the estimate both converges earlier and costs less.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

ResourceVector = Tuple[float, float, float]  # (cpu, disk, net) seconds

Schema = Tuple[str, ...]                     # output column names

#: Combiners with idempotent merge (x ⊕ x = x): their delta semantics allow
#: retraction of superseded contributions (paper §6), unlike ``add``.
IDEMPOTENT_COMBINERS = frozenset({"min", "max"})

#: uda_name -> combiner annotation, for plans built via :func:`groupby`.
_UDA_COMBINERS = {"sum": "add", "count": "add", "add": "add",
                  "min": "min", "max": "max"}


def overlap_combine(a: ResourceVector, b: ResourceVector) -> ResourceVector:
    """Paper §5: two pipelined subplans overlap; each resource lane is
    additive (both plans consume it), but the *runtime* is bounded by the
    busiest lane — see :func:`runtime_of`.  Combination is lane-wise sum."""
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sequential_combine(a: ResourceVector, b: ResourceVector) -> ResourceVector:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def runtime_of(v: ResourceVector, pipelined: bool = True) -> float:
    """Pipelined runtime = max lane (full overlap, §5's extreme case);
    non-pipelined = sum of lanes."""
    return max(v) if pipelined else sum(v)


@dataclasses.dataclass
class PlanNode:
    op: str                               # scan|select|project|udf|join|
    #                                       groupby|rehash|preagg|fixpoint
    children: Sequence["PlanNode"] = ()
    # --- statistics / calibration --------------------------------------
    out_cardinality: float = 0.0          # estimated output rows
    selectivity: float = 1.0              # rows_out / rows_in   (select/udf)
    cost_per_tuple: float = 0.0           # cpu seconds per input row (udf)
    resource: ResourceVector = (0.0, 0.0, 0.0)
    # --- typing ----------------------------------------------------------
    schema: Schema = ()                   # output column names (may be ())
    combiner: Optional[str] = None        # groupby/preagg/fixpoint: add|min|max
    # --- semantic flags --------------------------------------------------
    name: str = ""
    uda_name: Optional[str] = None        # groupby/preagg: which aggregator
    composable: bool = True               # §5.2 — can pre-agg cross any join
    key_fk_join: bool = False             # join on key–foreign-key?
    has_multiply: bool = False            # §5.2 multiplicative compensation
    deterministic: bool = True            # UDF caching eligibility (§5.1)
    volatile: bool = False
    cost_hint: Optional[Callable[[float], float]] = None  # §5.1 "big-O" hints
    expr: Optional[object] = None         # frontend scalar expression payload
    pinned: bool = False                  # frontend-semantic UDF: optimizer
    #                                       must not reorder it across joins
    max_iters: int = 0                    # fixpoint: iteration budget
    estimated_iterations: int = 0         # fixpoint: simulated-iteration count

    def __post_init__(self):
        self.children = tuple(self.children)
        self._validate()

    def _validate(self) -> None:  # typed subclasses override
        pass

    def rank(self) -> float:
        """Predicate-migration rank (paper §5.1, after [13]):
        cost-per-tuple / (1 - selectivity).  Lower rank ⇒ apply earlier:
        cheap predicates and highly selective predicates come first."""
        drop = 1.0 - min(self.selectivity, 1.0 - 1e-9)
        return self.cost_per_tuple / drop

    def clone(self, **overrides) -> "PlanNode":
        return dataclasses.replace(self, **overrides)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass
class Scan(PlanNode):
    def _validate(self):
        _require(self.op == "scan" and not self.children,
                 "scan is a leaf node")


@dataclasses.dataclass
class Select(PlanNode):
    def _validate(self):
        _require(self.op == "select" and len(self.children) == 1,
                 "select takes one child")
        if not self.schema:
            self.schema = self.children[0].schema


@dataclasses.dataclass
class Project(PlanNode):
    def _validate(self):
        _require(self.op == "project" and len(self.children) == 1,
                 "project takes one child")
        child_schema = self.children[0].schema
        if child_schema:
            missing = [c for c in self.schema if c not in child_schema]
            _require(not missing,
                     f"project columns {missing} not in child schema "
                     f"{child_schema}")


@dataclasses.dataclass
class Apply(PlanNode):
    """applyFunction / expensive-predicate node (op kept as ``udf`` for
    compatibility with rank-based interleaving)."""

    def _validate(self):
        _require(self.op == "udf" and len(self.children) == 1,
                 "apply/udf takes one child")
        if not self.schema:
            self.schema = self.children[0].schema


@dataclasses.dataclass
class Join(PlanNode):
    def _validate(self):
        _require(self.op == "join" and len(self.children) == 2,
                 "join takes two children")
        if not self.schema:
            self.schema = tuple(self.children[0].schema) + tuple(
                c for c in self.children[1].schema
                if c not in self.children[0].schema)


@dataclasses.dataclass
class Rehash(PlanNode):
    def _validate(self):
        _require(self.op == "rehash" and len(self.children) == 1,
                 "rehash takes one child")
        if not self.schema:
            self.schema = self.children[0].schema


@dataclasses.dataclass
class GroupAggregate(PlanNode):
    def _validate(self):
        _require(self.op == "groupby" and len(self.children) == 1,
                 "group-aggregate takes one child")
        _require(self.combiner in (None, "add", "min", "max"),
                 f"unknown combiner {self.combiner!r}")


@dataclasses.dataclass
class PreAggregate(PlanNode):
    def _validate(self):
        _require(self.op == "preagg" and len(self.children) == 1,
                 "pre-aggregate takes one child")
        if not self.schema:
            self.schema = self.children[0].schema


@dataclasses.dataclass
class Fixpoint(PlanNode):
    def _validate(self):
        _require(self.op == "fixpoint" and len(self.children) == 2,
                 "fixpoint takes (base, recursive) children")
        _require(self.combiner in (None, "add", "min", "max"),
                 f"unknown combiner {self.combiner!r}")

    @property
    def base(self) -> PlanNode:
        return self.children[0]

    @property
    def recursive(self) -> PlanNode:
        return self.children[1]

    @property
    def idempotent(self) -> bool:
        return self.combiner in IDEMPOTENT_COMBINERS


# ---------------------------------------------------------------------------
# Constructors (stats + resource vectors computed here).
# ---------------------------------------------------------------------------

def scan(name: str, cardinality: float, disk_per_tuple: float = 1e-8,
         schema: Schema = ()) -> Scan:
    return Scan(op="scan", name=name, out_cardinality=cardinality,
                resource=(0.0, cardinality * disk_per_tuple, 0.0),
                schema=tuple(schema))


def select(child: PlanNode, name: str = "", selectivity: float = 1.0,
           cost_per_tuple: float = 1e-9,
           expr: Optional[object] = None) -> Select:
    card_in = child.out_cardinality
    return Select(op="select", children=(child,), name=name,
                  selectivity=selectivity, cost_per_tuple=cost_per_tuple,
                  out_cardinality=card_in * selectivity,
                  resource=(card_in * cost_per_tuple, 0.0, 0.0), expr=expr)


def project(child: PlanNode, schema: Schema) -> Project:
    return Project(op="project", children=(child,), schema=tuple(schema),
                   out_cardinality=child.out_cardinality)


def udf(child: PlanNode, name: str, cost_per_tuple: float,
        selectivity: float = 1.0, deterministic: bool = True,
        cost_hint: Optional[Callable[[float], float]] = None,
        expr: Optional[object] = None, pinned: bool = False,
        schema: Schema = ()) -> Apply:
    card_in = child.out_cardinality
    per_tuple = cost_per_tuple
    if cost_hint is not None:
        # §5.1: the hint gives the shape; calibration fixes the coefficient.
        per_tuple = cost_per_tuple * cost_hint(card_in) / max(cost_hint(1.0),
                                                              1e-12)
    cpu = card_in * per_tuple
    if deterministic:
        # §5.1 caching: deterministic UDFs hit the cache for repeated values.
        # Model a calibrated 20% repeat rate.
        cpu *= 0.8
    return Apply(op="udf", children=(child,), name=name,
                 selectivity=selectivity, cost_per_tuple=per_tuple,
                 out_cardinality=card_in * selectivity,
                 resource=(cpu, 0.0, 0.0), deterministic=deterministic,
                 cost_hint=cost_hint, expr=expr, pinned=pinned,
                 schema=tuple(schema))


apply = udf  # typed-IR alias: applyFunction node


def rehash(child: PlanNode, net_per_tuple: float = 2e-8) -> Rehash:
    card = child.out_cardinality
    return Rehash(op="rehash", children=(child,), out_cardinality=card,
                  resource=(0.0, 0.0, card * net_per_tuple))


def join(left: PlanNode, right: PlanNode, selectivity: float = 1.0,
         key_fk: bool = False, cpu_per_tuple: float = 5e-9,
         schema: Schema = ()) -> Join:
    card = left.out_cardinality * max(right.out_cardinality, 1.0) * selectivity
    if key_fk:
        card = left.out_cardinality * selectivity
    cpu = (left.out_cardinality + right.out_cardinality) * cpu_per_tuple
    return Join(op="join", children=(left, right), selectivity=selectivity,
                out_cardinality=card, resource=(cpu, 0.0, 0.0),
                key_fk_join=key_fk, schema=tuple(schema))


def groupby(child: PlanNode, uda_name: str, n_groups: float,
            composable: bool = True, has_multiply: bool = False,
            cpu_per_tuple: float = 4e-9) -> GroupAggregate:
    return GroupAggregate(
        op="groupby", children=(child,), uda_name=uda_name,
        out_cardinality=n_groups, composable=composable,
        has_multiply=has_multiply,
        combiner=_UDA_COMBINERS.get(uda_name),
        resource=(child.out_cardinality * cpu_per_tuple, 0.0, 0.0))


def group_aggregate(child: PlanNode, key: str, combiner: str,
                    n_groups: float, composable: bool = True,
                    cpu_per_tuple: float = 4e-9) -> GroupAggregate:
    """Typed group-aggregate: group ``child`` rows by column ``key`` folding
    values with ``combiner`` (add|min|max)."""
    uda = {"add": "sum"}.get(combiner, combiner)
    return GroupAggregate(
        op="groupby", children=(child,), uda_name=uda, combiner=combiner,
        name=f"by:{key}", out_cardinality=n_groups, composable=True,
        schema=(key, "val"),
        resource=(child.out_cardinality * cpu_per_tuple, 0.0, 0.0))


def preagg(child: PlanNode, uda_name: str, reduction: float,
           cpu_per_tuple: float = 4e-9,
           combiner: Optional[str] = None) -> PreAggregate:
    """Combiner node (§5.2): shrinks cardinality by ``reduction`` before a
    rehash/join at the cost of one local aggregation pass."""
    return PreAggregate(
        op="preagg", children=(child,), uda_name=uda_name,
        combiner=combiner or _UDA_COMBINERS.get(uda_name),
        out_cardinality=child.out_cardinality * reduction,
        resource=(child.out_cardinality * cpu_per_tuple, 0.0, 0.0))


# ---------------------------------------------------------------------------
# Fixpoint construction + simulated-iteration cost estimate (§5.3, §6).
# ---------------------------------------------------------------------------

def _scale(v: ResourceVector, f: float) -> ResourceVector:
    return (v[0] * f, v[1] * f, v[2] * f)


def estimate_fixpoint(base: PlanNode, recursive: PlanNode, max_iters: int,
                      combiner: Optional[str],
                      step_selectivity: float = 1.0,
                      retraction_decay: float = 0.5
                      ) -> Tuple[ResourceVector, int]:
    """Simulated-iteration estimate of the strata BEYOND the first.

    Each stratum's cost is the recursive subplan scaled by |Δᵢ|/|Δ₀|.  For a
    monotone ``add`` accumulator there is no retraction: contributions only
    pile up, so the conservative §5.3 assumption is a non-shrinking frontier
    (|Δᵢ₊₁| = |Δᵢ| · step_selectivity, capped at 1.0) and the estimate runs
    the full ``max_iters``.  An idempotent combiner (min/max) takes the §6
    delta-retraction path: a delta superseded by a better value retracts,
    so the frontier decays at least geometrically
    (|Δᵢ₊₁| = |Δᵢ| · min(step_selectivity, retraction_decay)) and the
    simulation stops as soon as the frontier empties.

    Returns ``(extra_resource, iterations)`` where ``extra_resource``
    excludes the base scan and the first stratum (both already counted by
    :func:`total_resource` over the fixpoint's children).
    """
    step = total_resource(recursive)
    card0 = max(base.out_cardinality, 0.0)
    if combiner in IDEMPOTENT_COMBINERS:
        decay = min(step_selectivity, retraction_decay)
    else:
        decay = min(step_selectivity, 1.0)
    extra = (0.0, 0.0, 0.0)
    card = card0
    iters = 0
    for i in range(max_iters):
        if card < 1.0:
            break
        if i > 0:  # first stratum is already in total_resource(recursive)
            extra = sequential_combine(extra,
                                       _scale(step, card / max(card0, 1.0)))
        card *= decay
        iters += 1
    return extra, iters


def fixpoint(base: PlanNode, recursive: PlanNode, max_iters: int = 64,
             combiner: Optional[str] = None, step_selectivity: float = 1.0,
             retraction_decay: float = 0.5) -> Fixpoint:
    extra, iters = estimate_fixpoint(base, recursive, max_iters, combiner,
                                     step_selectivity, retraction_decay)
    return Fixpoint(op="fixpoint", children=(base, recursive),
                    out_cardinality=base.out_cardinality,
                    combiner=combiner, max_iters=max_iters,
                    estimated_iterations=iters, resource=extra,
                    schema=base.schema, name=f"fixpoint[{max_iters}]")


# ---------------------------------------------------------------------------
# Whole-plan aggregation.
# ---------------------------------------------------------------------------

def total_resource(node: PlanNode) -> ResourceVector:
    acc = node.resource
    for c in node.children:
        acc = sequential_combine(acc, total_resource(c))
    return acc


def plan_runtime(node: PlanNode, pipelined: bool = True) -> float:
    return runtime_of(total_resource(node), pipelined=pipelined)


def walk(node: PlanNode):
    """Pre-order traversal of a plan tree."""
    yield node
    for c in node.children:
        yield from walk(c)
