"""Compiled rule programs in the port against the port's handwritten
algorithms and against the reference's compiled programs.

Same graph and snapshot on both sides (512 vertices, 4 shards, an edge
capacity below the per-shard edge count, so the runs reach dense strata and
several sparse rungs).  PageRank, SSSP and CC, each in delta mode under the
``sort``, ``scatter`` and ``auto`` routes and in nodelta mode, at ladders
of 1 and 4 rungs, with the port's kernels on (their plain versions run on
the CPU) and off: values, the state and every per-stratum statistic must
be equal, bit for bit (PageRank's float adds included: the port keeps the
reference's order and its fused view, so they come out equal).  The
engine-level cases are in ``test_torch_frontend_engine.py``.
"""
import gc

import numpy as np
import pytest

import jax
import torch

from repro import frontend as JFe
from repro.core import fixpoint as JF
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr

from repro_torch import convert
from repro_torch import frontend as TFe
from repro_torch.algorithms import connected_components as TC
from repro_torch.algorithms import pagerank as TP
from repro_torch.algorithms import sssp as TS
from repro_torch.data.graphs import CSRGraph
from torch_threads import one_torch_thread  # noqa: F401

N, S = 512, 4
CAP = dict(edge_capacity=1024, src_capacity=128)
# name -> (program builder name, handwritten module, its kwargs, max_iters)
PROGRAMS = {
    "pagerank": ("pagerank_program", TP, {}, 60),
    "sssp": ("sssp_program", TS, dict(source=0), 80),
    "cc": ("cc_program", TC, {}, 80),
}
CASES = ([("delta", route, ladder) for ladder in (1, 4)
          for route in ("sort", "scatter", "auto")]
         + [("nodelta", "sort", ladder) for ladder in (1, 4)])


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


def assert_stats_equal(want, got):
    """Every per-stratum statistic of FixpointResult ``got`` equals
    ``want``'s (a reference or port result)."""
    for f in JF.StratumStats._fields:
        a = np.asarray(getattr(want.stats, f))
        b = getattr(got.stats, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("mode,route,ladder", CASES)
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_compiled_matches_handwritten_and_reference(setup, name, mode,
                                                    route, ladder):
    builder, hand, hand_kw, iters = PROGRAMS[name]
    kw = dict(mode=mode, max_iters=iters, route_strategy=route,
              ladder_tiers=ladder, **CAP)
    jcp = JFe.compile_program(getattr(JFe, builder)())
    jvals, jres = jcp.run(setup["jg"], setup["jsnap"], **kw)
    jvals = np.asarray(jvals)
    tcp = TFe.compile_program(getattr(TFe, builder)())
    for use_kernels in (True, False):
        vals, res = tcp.run(setup["tg"], setup["snap"], device="cpu",
                            use_kernels=use_kernels, **kw)
        hvals, hres = hand.run(setup["tg"], setup["snap"], device="cpu",
                               use_kernels=use_kernels, **hand_kw, **kw)
        assert_stats_equal(jres, res)
        assert_stats_equal(hres, res)
        np.testing.assert_array_equal(hvals.numpy(), vals.numpy())
        for a, b in zip(hres.state, res.state):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(jvals, vals.numpy())
        for a, b in zip(jres.state, res.state):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    it = int(res.stats.iterations)
    tiers = set(res.stats.tiers[:it].tolist())
    if mode == "nodelta":
        assert tiers == {-1}
    elif ladder == 4:
        assert len(tiers - {-1}) >= 2     # the ladder dispatched


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_types_are_pinned(setup, name):
    builder, _, _, _ = PROGRAMS[name]
    cp = TFe.compile_program(getattr(TFe, builder)())
    vals, res = cp.run(setup["tg"], setup["snap"], device="cpu", max_iters=2,
                       **CAP)
    store, sent = cp.initial_state(setup["snap"], "cpu")
    assert vals.dtype == store.dtype == sent.dtype == torch.float32
    assert vals.shape == (setup["snap"].padded_keys,)
    assert res.stats.delta_counts.dtype == torch.int32

