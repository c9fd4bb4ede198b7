"""Fused multiply-adds in compiled programs: the port against the
reference's compiled programs.

The reference's compiler contracts a multiply that feeds an add or a
subtract inside its strata; the port's ``frontend/lower.py`` follows its
choices through ``evaluate_contracted``.  Each program here has one shape
that the four canonical programs lack: a min term ``a * b + c`` (min must
be exact), a view with a constant product, a view ``c - a * b``, terms
``c - a * b``, ``a * b - c``, ``a * b ± c * d`` (which product fuses), a
product of deg() and a constant (fused in the delta strata, rounded alone
in the nodelta strata, where the reference's compiler hoists it out of the
loop), and a product by a power of two.  Same graph and settings as
``test_torch_frontend_lower.py``: 512 vertices, 4 shards, edge capacity
1024, route sort, ladder 1, kernels off.  Every stratum statistic is
exact, min values are exact, and added floats are within 1 ulp.
"""
import gc

import numpy as np
import pytest

import jax

from repro import frontend as JFe
from repro.core import fixpoint as JF
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr

from repro_torch import convert
from repro_torch import frontend as TFe
from repro_torch.data.graphs import CSRGraph
from torch_threads import one_torch_thread  # noqa: F401

N, S = 512, 4
KW = dict(edge_capacity=1024, src_capacity=128, route_strategy="sort",
          ladder_tiers=1, max_iters=60)

_VIEW = ("program p.\nthreshold 0.001.\ninput edge(u, v).\n"
         "rank(v) = {}.\nacc(v) add= rank(u) / deg(u) :- edge(u, v).\n")
_MIN = "program s.\ninput edge(u, v).\n{}\nd(v) min= {} :- edge(u, v).\n"
_SRC, _IDS = "d(0) := 0.0.", "d(v) := id(v)."
PROGRAMS = {
    "min_ab_plus_c": _MIN.format(_SRC, "d(u) * 1.1 + 1.3"),
    "min_c_plus_ab": _MIN.format(_SRC, "1.3 + 1.1 * d(u)"),
    "view_const_product": _VIEW.format("0.15 + 0.5 * 1.7 * acc(v)"),
    "view_c_minus_ab": _VIEW.format("0.3 - 0.85 * acc(v)"),
    "c_minus_ab": _MIN.format(_IDS, "3.7 - d(u) * 0.3"),
    "ab_minus_c": _MIN.format(_SRC, "d(u) * 1.1 - 0.7"),
    "ab_plus_cd": _MIN.format(_SRC, "d(u) * 1.1 + deg(u) * 0.7"),
    "cd_plus_ab": _MIN.format(_SRC, "deg(u) * 0.7 + d(u) * 1.1"),
    "ab_minus_cd": _MIN.format(_IDS, "deg(u) * 3.7 - d(u) * 0.3"),
    "deg_product_plus_c": _MIN.format(_SRC, "deg(u) * 0.7 + d(u)"),
    "power_of_two": _MIN.format(_SRC, "d(u) * 2.0 + 1.3"),
}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def setup():
    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    jg = j_shard_csr(indptr, indices, S)
    jsnap = JSnapshot(n_keys=N, num_shards=S)
    return dict(jg=jg, jsnap=jsnap, snap=convert.snapshot(jsnap),
                tg=convert.to_torch(CSRGraph, jg, "cpu"))


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 steps between ``a`` and ``b`` (equal
    infinities count 0)."""
    same = a == b
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.where(same, 0, np.abs(ia - ib)).max())


@pytest.mark.parametrize("mode", ["delta", "nodelta"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_contraction_matches_reference(setup, name, mode):
    text = PROGRAMS[name]
    jcp = JFe.compile_program(JFe.parse_program(text))
    jvals, jres = jcp.run(setup["jg"], setup["jsnap"], mode=mode, **KW)
    tcp = TFe.compile_program(TFe.parse_program(text))
    vals, res = tcp.run(setup["tg"], setup["snap"], mode=mode, device="cpu",
                        use_kernels=False, **KW)
    for f in JF.StratumStats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres.stats, f)),
                                      getattr(res.stats, f).numpy(),
                                      err_msg=f)
    assert int(res.stats.iterations) > 1
    want = [np.asarray(jvals)] + [np.asarray(x) for x in jres.state]
    got = [vals.numpy()] + [x.numpy() for x in res.state]
    for w, g in zip(want, got):
        if tcp.combiner == "add":
            assert ulps(w, g) <= 1
        else:
            np.testing.assert_array_equal(w, g)
