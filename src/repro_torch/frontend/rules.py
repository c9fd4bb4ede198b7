"""Rule-program AST + builder API (frontend layer).

A :class:`Program` is a small Datalog-ish recursive program over one binary
edge relation: base facts / all-vertex initializers seed a recursive head
relation, one aggregation rule (``add``/``min``/``max`` head) propagates a
scalar UDF term along edges, and an optional *view* maps the aggregation
state to the user-visible value (PageRank's ``rank = 0.15 + 0.85·acc``).

Statement forms (text grammar in frontend/parser.py):

    program pagerank.                          # name
    threshold 0.001.                           # convergence threshold (add)
    input edge(u, v).                          # EDB declaration
    label(v) := id(v).                         # all-vertex initializer
    dist(0) := 0.0.                            # ground fact at key 0
    rank(v) = 0.15 + 0.85 * acc(v).            # view over the agg head
    acc(v) add= rank(u) / deg(u) :- edge(u, v).  # recursive aggregation rule

Everything is a frozen dataclass: programs compare structurally, so
``parse(p.to_text()) == p`` is exact (constants render via ``repr`` which
round-trips floats losslessly).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.frontend import expr as E

AGGREGATORS = ("add", "min", "max")


class FrontendError(ValueError):
    """Invalid or unsupported rule program."""


@dataclasses.dataclass(frozen=True)
class InputDecl:
    name: str
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Fact:
    """Ground base fact: ``rel(key) := value.``"""

    rel: str
    key: int
    value: float


@dataclasses.dataclass(frozen=True)
class InitRule:
    """All-vertex initializer: ``rel(v) := expr.`` (builtins + consts)."""

    rel: str
    var: str
    expr: E.Expr


@dataclasses.dataclass(frozen=True)
class View:
    """Value view over the aggregation head: ``rel(v) = expr.``"""

    rel: str
    var: str
    expr: E.Expr


@dataclasses.dataclass(frozen=True)
class RecursiveRule:
    """``head(dst) agg= term :- edge(src, dst).``"""

    head: str
    var: str          # the head/destination variable
    agg: str          # add | min | max
    term: E.Expr      # scalar UDF over src-variable references
    edge: str
    src: str
    dst: str


@dataclasses.dataclass(frozen=True)
class Program:
    name: str = "program"
    threshold: float = 1e-3
    inputs: Tuple[InputDecl, ...] = ()
    inits: Tuple[InitRule, ...] = ()
    facts: Tuple[Fact, ...] = ()
    views: Tuple[View, ...] = ()
    rules: Tuple[RecursiveRule, ...] = ()

    # -- introspection helpers -------------------------------------------
    def input_named(self, name: str) -> Optional[InputDecl]:
        for i in self.inputs:
            if i.name == name:
                return i
        return None

    def view_for(self, rel: str) -> Optional[View]:
        for v in self.views:
            if E.refs(v.expr) and any(r.rel == rel for r in E.refs(v.expr)):
                return v
        return None

    def init_for(self, rel: str) -> Optional[InitRule]:
        for i in self.inits:
            if i.rel == rel:
                return i
        return None

    def facts_for(self, rel: str) -> Tuple[Fact, ...]:
        return tuple(f for f in self.facts if f.rel == rel)

    # -- rendering --------------------------------------------------------
    def to_text(self) -> str:
        lines: List[str] = [f"program {self.name}.",
                            f"threshold {self.threshold!r}."]
        for i in self.inputs:
            lines.append(f"input {i.name}({', '.join(i.fields)}).")
        for r in self.inits:
            lines.append(f"{r.rel}({r.var}) := {E.to_text(r.expr)}.")
        for f in self.facts:
            lines.append(f"{f.rel}({f.key}) := {f.value!r}.")
        for v in self.views:
            lines.append(f"{v.rel}({v.var}) = {E.to_text(v.expr)}.")
        for r in self.rules:
            lines.append(f"{r.head}({r.var}) {r.agg}= {E.to_text(r.term)} "
                         f":- {r.edge}({r.src}, {r.dst}).")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Builder.
# ---------------------------------------------------------------------------

def _normalize(expr: E.Expr, default_var: str, context: str) -> E.Expr:
    """Fill in ``var=None`` references and validate variable usage."""
    def fix(r: E.Ref) -> E.Expr:
        var = r.var or default_var
        if var != default_var:
            raise FrontendError(
                f"{context}: reference {r.rel}({var}) uses variable "
                f"{var!r}; only {default_var!r} is in scope")
        return E.Ref(r.rel, var)
    return E.transform(expr, fix)


class ProgramBuilder:
    """Chainable builder mirroring the text grammar one statement per call."""

    def __init__(self, name: str = "program"):
        self._name = name
        self._threshold = 1e-3
        self._inputs: List[InputDecl] = []
        self._inits: List[InitRule] = []
        self._facts: List[Fact] = []
        self._views: List[View] = []
        self._rules: List[RecursiveRule] = []

    def input(self, name: str, *fields: str) -> "ProgramBuilder":
        self._inputs.append(InputDecl(name, tuple(fields)))
        return self

    def threshold(self, value: float) -> "ProgramBuilder":
        self._threshold = float(value)
        return self

    def fact(self, rel: str, key: int, value: float) -> "ProgramBuilder":
        self._facts.append(Fact(rel, int(key), float(value)))
        return self

    def init(self, rel: str, expr, var: str = "v") -> "ProgramBuilder":
        self._inits.append(InitRule(rel, var, E.wrap(expr)))
        return self

    def view(self, rel: str, expr, var: str = "v") -> "ProgramBuilder":
        self._views.append(View(rel, var, E.wrap(expr)))
        return self

    def rule(self, head: str, agg: str, term,
             edge: Optional[Tuple[str, str, str]] = None,
             var: str = "v", src: str = "u") -> "ProgramBuilder":
        if edge is None:
            binary = [i for i in self._inputs if len(i.fields) == 2]
            if not binary:
                raise FrontendError(
                    "rule() needs an edge: declare a binary input first or "
                    "pass edge=(name, src, dst)")
            edge = (binary[0].name, src, var)
        name, esrc, edst = edge
        self._rules.append(RecursiveRule(
            head=head, var=edst, agg=agg, term=E.wrap(term),
            edge=name, src=esrc, dst=edst))
        return self

    def build(self) -> Program:
        if self._threshold <= 0:
            raise FrontendError("threshold must be positive")
        inits = tuple(InitRule(r.rel, r.var,
                               _normalize(r.expr, r.var, f"init {r.rel}"))
                      for r in self._inits)
        views = tuple(View(v.rel, v.var,
                           _normalize(v.expr, v.var, f"view {v.rel}"))
                      for v in self._views)
        rules = []
        for r in self._rules:
            if r.agg not in AGGREGATORS:
                raise FrontendError(
                    f"unknown aggregator {r.agg!r} (use one of "
                    f"{'/'.join(AGGREGATORS)})")
            decl = None
            for i in self._inputs:
                if i.name == r.edge:
                    decl = i
            if decl is None or len(decl.fields) != 2:
                raise FrontendError(
                    f"rule over {r.edge!r}: no binary input of that name "
                    "is declared")
            rules.append(RecursiveRule(
                head=r.head, var=r.var, agg=r.agg,
                term=_normalize(r.term, r.src, f"rule {r.head}"),
                edge=r.edge, src=r.src, dst=r.dst))
        seen: Dict[str, str] = {}
        for kind, rels in (("init", [i.rel for i in inits]),
                           ("view", [v.rel for v in views])):
            for rel in rels:
                if rel in seen:
                    raise FrontendError(
                        f"{rel!r} defined by both {seen[rel]} and {kind}")
                seen[rel] = kind
        return Program(name=self._name, threshold=self._threshold,
                       inputs=tuple(self._inputs), inits=inits,
                       facts=tuple(self._facts), views=views,
                       rules=tuple(rules))
