"""Declarative recursive-rule frontend (Datalog-ish programs → engine).

Pipeline: rules (builder API or text) → typed logical-plan IR
(core/plan.py) → optimizer rewrites (core/optimizer.py) → lowering to
``DeltaAlgorithm`` callables (frontend/lower.py) executed by the unchanged
``ShardedExecutor`` and the port's CUDA kernels.  The pure-Python modules
are copies of the reference package's; the port imports nothing of it.
"""
from repro_torch.frontend.expr import BinOp, Const, Expr, Ref, deg, ref, vid
from repro_torch.frontend.lower import (CompiledProgram, LoweredSpec,
                                        compile_program)
from repro_torch.frontend.parser import ParseError, parse_program
from repro_torch.frontend.planner import GraphStats, plan_program
from repro_torch.frontend.programs import (CC_TEXT, PAGERANK_TEXT,
                                           REACHABILITY_TEXT, SSSP_TEXT,
                                           cc_program, pagerank_program,
                                           reachability_program,
                                           sssp_program)
from repro_torch.frontend.rules import (AGGREGATORS, Fact, FrontendError,
                                        InitRule, InputDecl, Program,
                                        ProgramBuilder, RecursiveRule, View)

__all__ = [
    "AGGREGATORS", "BinOp", "CC_TEXT", "CompiledProgram", "Const", "Expr",
    "Fact", "FrontendError", "GraphStats", "InitRule", "InputDecl",
    "LoweredSpec", "PAGERANK_TEXT", "ParseError", "Program",
    "ProgramBuilder", "REACHABILITY_TEXT", "RecursiveRule", "Ref",
    "SSSP_TEXT", "View", "cc_program", "compile_program", "deg",
    "pagerank_program", "parse_program", "plan_program",
    "reachability_program", "ref", "sssp_program", "vid",
]
