"""The port's rule frontend, plan IR and optimizer against the reference's.

The same programs go through both packages: text renders and parses the
same, builders and lowering refuse the same programs with the same
exception class and message, and the logical and optimised plans of the
four canned programs walk to the same (op, name, cardinality, resource)
tuples.  Then the reference's optimiser-rewrite tests on the port's plan
IR, and ``CostModel.from_route_table`` over the port's route table.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from repro import frontend as JF
from repro.core import optimizer as JO
from repro.core import plan as JP
from repro.frontend import expr as JE

from repro_torch import frontend as TF
from repro_torch.core import optimizer as TO
from repro_torch.core import plan as TP
from repro_torch.frontend import expr as TE
from repro_torch.obs.calibrate import RouteCostTable

CANNED = ("pagerank_program", "sssp_program", "cc_program",
          "reachability_program")
TEXTS = ("PAGERANK_TEXT", "SSSP_TEXT", "CC_TEXT", "REACHABILITY_TEXT")


def random_tree(rng, rels, var="u", depth=0):
    """A package-free expression: ("c", x) | ("r", rel, var) | (op, l, r)."""
    roll = rng.integers(0, 3 if depth < 3 else 2)
    if roll == 0:
        return ("c", float(np.round(rng.uniform(-4, 4), 3)))
    if roll == 1:
        return ("r", str(rng.choice(rels)), var)
    return (str(rng.choice(["+", "-", "*", "/"])),
            random_tree(rng, rels, var, depth + 1),
            random_tree(rng, rels, var, depth + 1))


def to_expr(E, tree):
    if tree[0] == "c":
        return E.Const(tree[1])
    if tree[0] == "r":
        return E.Ref(tree[1], tree[2])
    return E.BinOp(tree[0], to_expr(E, tree[1]), to_expr(E, tree[2]))


def plan_tuples(plan, P):
    return [(n.op, n.name, n.out_cardinality, n.resource, n.combiner,
             n.estimated_iterations) for n in P.walk(plan)]


# ---------------------------------------------------------------------------
# Parse / build / render.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder,text", list(zip(CANNED, TEXTS)))
def test_canonical_programs(builder, text):
    prog = getattr(TF, builder)()
    assert TF.parse_program(getattr(TF, text)) == prog
    assert TF.parse_program(prog.to_text()) == prog
    assert getattr(TF, text) == getattr(JF, text)
    assert prog.to_text() == getattr(JF, builder)().to_text()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10 ** 6),
       agg=st.sampled_from(["add", "min", "max"]),
       threshold=st.floats(min_value=1e-6, max_value=10.0))
def test_random_programs_render_alike_and_round_trip(seed, agg, threshold):
    def build(F, E):
        rng = np.random.default_rng(seed)
        b = F.ProgramBuilder(f"p{seed}").threshold(threshold)
        b.input("edge", "u", "v")
        if rng.integers(0, 2):
            b.init("head", to_expr(E, random_tree(rng, ["id"], var="v")),
                   var="v")
        for _ in range(rng.integers(0, 3)):
            b.fact("head", int(rng.integers(0, 100)),
                   float(np.round(rng.uniform(-9, 9), 3)))
        b.rule("head", agg, to_expr(E, random_tree(rng, ["head", "deg"])),
               var="v", src="u")
        return b.build()

    prog = build(TF, TE)
    assert TF.parse_program(prog.to_text()) == prog
    assert prog.to_text() == build(JF, JE).to_text()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_expr_tree_round_trips(seed):
    tree = random_tree(np.random.default_rng(seed), ["x", "deg"])
    e = to_expr(TE, tree)
    prog = (TF.ProgramBuilder("t").input("edge", "u", "v")
            .rule("x", "add", e, var="v", src="u").build())
    assert TF.parse_program(prog.to_text()).rules[0].term == e
    assert TE.to_text(e) == JE.to_text(to_expr(JE, tree))
    x = np.array([1.5, -2.25, 0.0, 7.0], np.float32)
    d = np.array([3.0, 1.0, 2.0, 5.0], np.float32)
    got = outcome(lambda: TE.evaluate(e, {"x": torch.from_numpy(x),
                                          "deg": torch.from_numpy(d)}))
    want = outcome(lambda: JE.evaluate(to_expr(JE, tree),
                                       {"x": jnp.asarray(x),
                                        "deg": jnp.asarray(d)}))
    assert type(got) is type(want)
    if isinstance(got, str):    # both raised (a constant divided by 0.0)
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def outcome(fn):
    """``fn()`` as a float32 array, or its exception's class name."""
    try:
        out = fn()
    except ArithmeticError as e:
        return type(e).__name__
    return np.asarray(out, np.float32) * np.ones(4, np.float32)


def test_comments_and_whitespace():
    text = ("# header comment\nprogram   demo.\n"
            "input edge(u, v).  # trailing\n"
            "x(v) min= x(u) :- edge(u, v).\n")
    prog = TF.parse_program(text)
    assert prog.name == "demo" and prog.rules[0].agg == "min"


def raised(fn):
    """(exception class name, message) of ``fn()``, which must raise."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the class is what we compare
        return type(e).__name__, str(e)
    raise AssertionError("did not raise")


@pytest.mark.parametrize("text", [
    "program p. @!?",
    "x(v) foo= x(u) :- edge(u, v).",
    "input edge(u, v). x(w) min= x(u) :- edge(u, v).",
    "threshold 0.0.\ninput edge(u, v).",
])
def test_parse_errors_match(text):
    got = raised(lambda: TF.parse_program(text))
    assert got == raised(lambda: JF.parse_program(text))
    assert got[0] in ("ParseError", "FrontendError")


def _bad_builders(F, E):
    return [
        lambda: F.ProgramBuilder("p").rule("x", "add", E.ref("x")).build(),
        lambda: (F.ProgramBuilder("p").input("edge", "u", "v")
                 .rule("x", "avg", E.ref("x")).build()),
        lambda: (F.ProgramBuilder("p").input("edge", "u", "v")
                 .rule("x", "add", E.ref("x", "v")).build()),
        lambda: (F.ProgramBuilder("p").threshold(-1.0)
                 .input("edge", "u", "v").rule("x", "min", E.ref("x"))
                 .build()),
    ]


@pytest.mark.parametrize("i", range(4))
def test_builder_validation_matches(i):
    got = raised(_bad_builders(TF, TE)[i])
    assert got == raised(_bad_builders(JF, JE)[i])
    assert got[0] == "FrontendError"


def _bad_programs(F, E):
    def b():
        return F.ProgramBuilder("bad").input("edge", "u", "v")
    return [
        b().rule("x", "add", E.ref("x") * E.ref("x")).build(),
        b().rule("x", "add", 0.15 + 0.85 * E.ref("x")).build(),
        b().view("y", 2.0 * E.ref("x")).rule("x", "min", E.ref("y")).build(),
        b().rule("x", "min", E.ref("x")).rule("y", "min", E.ref("y")).build(),
        b().rule("x", "min", E.ref("mystery")).build(),
        b().init("z", E.vid()).rule("x", "min", E.ref("x")).build(),
        b().init("x", E.ref("w")).rule("x", "min", E.ref("x")).build(),
        b().fact("x", -1, 0.0).rule("x", "min", E.ref("x")).build(),
        b().fact("z", 1, 0.0).rule("x", "min", E.ref("x")).build(),
    ]


@pytest.mark.parametrize("i", range(9))
def test_lowering_validation_matches(i):
    got = raised(lambda: TF.compile_program(_bad_programs(TF, TE)[i]))
    assert got == raised(lambda: JF.compile_program(_bad_programs(JF, JE)[i]))
    assert got[0] in ("FrontendError", "NotImplementedError")


# ---------------------------------------------------------------------------
# Plans and the optimizer.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", CANNED)
@pytest.mark.parametrize("stats", [None, (1e6, 4.0, 0.05)])
def test_plans_match_reference(builder, stats):
    tstats = TF.GraphStats(*stats) if stats else None
    jstats = JF.GraphStats(*stats) if stats else None
    tcp = TF.compile_program(getattr(TF, builder)(), stats=tstats)
    jcp = JF.compile_program(getattr(JF, builder)(), stats=jstats)
    assert plan_tuples(tcp.logical, TP) == plan_tuples(jcp.logical, JP)
    assert plan_tuples(tcp.optimized, TP) == plan_tuples(jcp.optimized, JP)
    assert TP.plan_runtime(tcp.optimized) == JP.plan_runtime(jcp.optimized)
    assert TE.to_text(tcp.spec.term) == JE.to_text(jcp.spec.term)
    assert (tcp.spec.combiner, tcp.spec.threshold, tcp.spec.head,
            tcp.spec.value_rel) == (jcp.spec.combiner, jcp.spec.threshold,
                                    jcp.spec.head, jcp.spec.value_rel)


def test_plan_shape():
    plan = TF.plan_program(TF.pagerank_program())
    assert plan.op == "fixpoint" and plan.combiner == "add"
    ops = [n.op for n in TP.walk(plan)]
    for op in ("scan", "select", "udf", "join", "project", "rehash",
               "groupby"):
        assert op in ops
    names = [n.name for n in TP.walk(plan) if n.op == "udf"]
    assert "view:rank" in names and "term" in names


def test_optimizer_pushes_preagg_below_rehash_idempotently():
    raw = TF.plan_program(TF.pagerank_program())
    opt = TO.optimize(raw)
    seq = [n.op for n in TP.walk(opt)]
    assert seq.index("rehash") < seq.index("preagg")
    assert TP.total_resource(opt)[2] < 0.2 * TP.total_resource(raw)[2]
    assert TP.plan_runtime(opt) <= TP.plan_runtime(raw)
    assert TO.optimize(opt) == opt
    names = [n.name for n in TP.walk(opt) if n.op == "udf"]
    assert names.index("term") < names.index("view:rank")


def test_fixpoint_idempotent_takes_retraction_path():
    base = TP.scan("r", 1e5)
    rec = TP.rehash(TP.scan("delta", 1e5))
    fp = {c: TP.fixpoint(base, rec, max_iters=64, combiner=c)
          for c in ("add", "min", "max")}
    assert fp["min"].estimated_iterations < fp["add"].estimated_iterations
    assert fp["max"].estimated_iterations == fp["min"].estimated_iterations
    assert TP.plan_runtime(fp["min"]) < TP.plan_runtime(fp["add"])
    assert fp["add"].estimated_iterations == 64


def _rewrites(P, O):
    """The reference's optimiser-rewrite cases, built in one package:
    name -> rewritten plan."""
    sel = P.PlanNode(op="udf", name="sel", cost_per_tuple=1e-9,
                     selectivity=0.01)
    exp = P.PlanNode(op="udf", name="exp", cost_per_tuple=1e-5,
                     selectivity=0.9)
    interleaved, _ = O.best_udf_join_interleaving(
        P.scan("R", 1e6), [sel, exp],
        lambda n: P.join(n, P.scan("S", 1e5), selectivity=1e-6), 1)
    chain = P.udf(P.udf(P.join(P.udf(P.scan("R", 1e6), "a", 1e-6, 0.5),
                               P.scan("S", 1e3), key_fk=True), "b", 1e-9,
                        0.1), "c", 1e-7, 0.9)
    return {
        "interleaving": interleaved,
        "interleave_rewrite": O.interleave_udf_joins(chain),
        "preagg_composable": O.push_preaggregation(
            P.groupby(P.rehash(P.scan("R", 1e6)), "sum", n_groups=100),
            reduction=0.1),
        "preagg_blocked": O.push_preaggregation(P.groupby(
            P.join(P.scan("R", 1e6), P.scan("S", 1e3), key_fk=False),
            "median", n_groups=10, composable=False)),
        "preagg_fk": O.push_preaggregation(P.groupby(
            P.join(P.scan("R", 1e6), P.scan("S", 1e3), key_fk=True),
            "median", n_groups=10, composable=False)),
        "whole": O.optimize(P.groupby(P.rehash(P.udf(P.scan("R", 1e6), "f",
                                                     1e-8)), "sum",
                                      n_groups=10)),
    }


@pytest.mark.parametrize("case", ["interleaving", "interleave_rewrite",
                                  "preagg_composable", "preagg_blocked",
                                  "preagg_fk", "whole"])
def test_optimizer_rewrites_match_reference(case):
    got = _rewrites(TP, TO)[case]
    assert plan_tuples(got, TP) == plan_tuples(_rewrites(JP, JO)[case], JP)
    if case == "interleaving":   # the selective UDF runs below the join
        join = next(n for n in TP.walk(got) if n.op == "join")
        assert "sel" in [n.name for n in TP.walk(join.children[0])]
        assert "exp" not in [n.name for n in TP.walk(join)]
    if case == "preagg_composable":
        rh = next(n for n in TP.walk(got) if n.op == "rehash")
        assert rh.children[0].op == "preagg"


def test_recursive_estimation_and_costs():
    for O in (TO, JO):
        total, card, iters = O.estimate_recursive_cost(
            1.0, 1000.0, lambda c: c * 1e-3, lambda c: c * 2.0,
            max_iters=50)
        assert iters == 50 and card <= 1000.0
    assert TO.estimate_recursive_cost(
        1.0, 1000.0, lambda c: c * 1e-3, lambda c: c * 0.5) == \
        JO.estimate_recursive_cost(1.0, 1000.0, lambda c: c * 1e-3,
                                   lambda c: c * 0.5)
    assert TP.runtime_of((3.0, 1.0, 2.0)) == 3.0
    assert TP.runtime_of((3.0, 1.0, 2.0), pipelined=False) == 6.0
    assert TO.worst_case_node_cost([1.0, 5.0, 2.0]) == 5.0
    order = TO.order_udfs_by_rank([
        TP.PlanNode(op="udf", name="pricey", cost_per_tuple=1e-6,
                    selectivity=0.9),
        TP.PlanNode(op="udf", name="cheap", cost_per_tuple=1e-9,
                    selectivity=0.9),
        TP.PlanNode(op="udf", name="sel", cost_per_tuple=1e-6,
                    selectivity=0.01)])
    assert [u.name for u in order] == ["cheap", "sel", "pricey"]


@pytest.mark.parametrize("backend", ["cpu", "cuda:NVIDIA H100 80GB HBM3"])
def test_cost_model_from_route_table(backend):
    table = RouteCostTable(backend=backend, combiner="add",
                           entries={1024: (1.024e-4, 2e-4),
                                    4096: (8e-4, 4.096e-4)})
    cm = TO.CostModel.from_route_table(table)
    assert cm.rehash_net_per_tuple == pytest.approx(table.median_per_tuple())
    assert cm.source == f"measured:{backend}"
    assert TO.CostModel().source == "static"
    plan = TF.plan_program(TF.pagerank_program(), cost_model=cm)
    rh = next(n for n in TP.walk(plan) if n.op == "rehash")
    assert rh.resource[2] == pytest.approx(
        rh.out_cardinality * cm.rehash_net_per_tuple)
    jcm = JO.CostModel(rehash_net_per_tuple=cm.rehash_net_per_tuple,
                       source=cm.source)
    jplan = JF.plan_program(JF.pagerank_program(), cost_model=jcm)
    assert plan_tuples(plan, TP) == plan_tuples(jplan, JP)
