"""Canonical rule programs: the paper's benchmark algorithms as rules.

Each program comes in two equivalent forms — a builder-API function and a
text constant — and compiles (plan → optimize → lower) to a DeltaAlgorithm
property-tested *bit-identical* to the handwritten ``algorithms/`` version.

PageRank needs the two-relation formulation: the aggregation head ``acc``
accumulates pure mass and the damping constants live in a *view*, keeping
the add-rule term homogeneous-linear so the delta rewrite is sound (and the
lowered arithmetic token-identical to ``algorithms/pagerank.py``).

Reachability has NO handwritten counterpart — it exists purely as rules and
exercises the whole pipeline with zero engine changes.
"""
from __future__ import annotations

from repro_torch.frontend import expr as E
from repro_torch.frontend.rules import Program, ProgramBuilder

PAGERANK_TEXT = """\
program pagerank.
threshold 0.001.
input edge(u, v).
rank(v) = 0.15 + 0.85 * acc(v).
acc(v) add= rank(u) / deg(u) :- edge(u, v).
"""

SSSP_TEXT = """\
program sssp.
input edge(u, v).
dist(0) := 0.0.
dist(v) min= dist(u) + 1.0 :- edge(u, v).
"""

CC_TEXT = """\
program cc.
input edge(u, v).
label(v) := id(v).
label(v) min= label(u) :- edge(u, v).
"""

REACHABILITY_TEXT = """\
program reachability.
input edge(u, v).
reach(0) := 1.0.
reach(v) max= reach(u) :- edge(u, v).
"""


def pagerank_program(threshold: float = 1e-3) -> Program:
    return (ProgramBuilder("pagerank")
            .threshold(threshold)
            .input("edge", "u", "v")
            .view("rank", 0.15 + 0.85 * E.ref("acc"), var="v")
            .rule("acc", "add", E.ref("rank") / E.deg(), var="v", src="u")
            .build())


def sssp_program(source: int = 0) -> Program:
    return (ProgramBuilder("sssp")
            .input("edge", "u", "v")
            .fact("dist", source, 0.0)
            .rule("dist", "min", E.ref("dist") + 1.0, var="v", src="u")
            .build())


def cc_program() -> Program:
    return (ProgramBuilder("cc")
            .input("edge", "u", "v")
            .init("label", E.vid(), var="v")
            .rule("label", "min", E.ref("label"), var="v", src="u")
            .build())


def reachability_program(source: int = 0) -> Program:
    return (ProgramBuilder("reachability")
            .input("edge", "u", "v")
            .fact("reach", source, 1.0)
            .rule("reach", "max", E.ref("reach"), var="v", src="u")
            .build())
