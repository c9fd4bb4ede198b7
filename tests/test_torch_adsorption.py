"""The port's adsorption against the reference's.

Same graph, snapshot, seeds and settings (4 shards, ladder of 4 rungs, an
edge capacity that reaches a dense stratum and several sparse rungs, 4
labels), under ``sort``, ``auto`` and ``nodelta``, with the port's kernels
on (their plain versions run on the CPU) and off.  Iterations, every
per-stratum statistic and the values must be equal.
"""
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.algorithms import adsorption as JA
from repro.algorithms import emission as JE
from repro.core.delta import DeltaBuffer as JDeltaBuffer
from repro.core import fixpoint as JF
from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.data.graphs import make_powerlaw_graph, shard_csr as j_shard_csr

from repro_torch import convert
from repro_torch.algorithms import adsorption as TA
from repro_torch.algorithms import emission as TE
from repro_torch.core.delta import DeltaBuffer
from repro_torch.data.graphs import CSRGraph
from torch_threads import one_torch_thread  # noqa: F401

N, S, L = 1024, 4, 4
CAP = dict(edge_capacity=2048, src_capacity=256, ladder_tiers=4)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()
    gc.collect()


def make_seeds(padded: int, n: int, every: int = 3) -> np.ndarray:
    seeds = np.zeros((padded, L), np.float32)
    v = np.arange(0, n, every)
    seeds[v, v % L] = 1.0
    return seeds


@pytest.fixture(scope="module")
def setup():
    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    jg = j_shard_csr(indptr, indices, S)
    jsnap = JSnapshot(n_keys=N, num_shards=S)
    return dict(jg=jg, jsnap=jsnap, tg=convert.to_torch(CSRGraph, jg, "cpu"),
                snap=convert.snapshot(jsnap),
                seeds=make_seeds(jsnap.padded_keys, N), ref_runs={})


def _reference(setup, mode, route):
    key = (mode, route)
    if key not in setup["ref_runs"]:
        from repro.core.engine import ShardedExecutor as JEx
        ex = JEx(snapshot=setup["jsnap"], seg_capacity=CAP["edge_capacity"],
                 edge_capacity=CAP["edge_capacity"],
                 src_capacity=CAP["src_capacity"],
                 ladder_tiers=CAP["ladder_tiers"], route_strategy=route)
        setup["ref_runs"][key] = JA.run(
            setup["jg"], setup["jsnap"], jnp.asarray(setup["seeds"]),
            mode=mode, threshold=1e-3, max_iters=60, executor=ex, **CAP)
    return setup["ref_runs"][key]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mode,route", [("delta", "sort"), ("delta", "auto"),
                                        ("nodelta", "sort")])
def test_adsorption_parity(setup, mode, route, use_kernels):
    jvec, jres = _reference(setup, mode, route)
    vec, res = TA.run(setup["tg"], setup["snap"], setup["seeds"], mode=mode,
                      threshold=1e-3, max_iters=60, route_strategy=route,
                      device="cpu", use_kernels=use_kernels, **CAP)
    for f in JF.StratumStats._fields:
        a, b = np.asarray(getattr(jres.stats, f)), getattr(res.stats,
                                                           f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(jvec), vec.numpy())
    for f in TA.AdsorptionState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres.state, f)),
                                      getattr(res.state, f).numpy(),
                                      err_msg=f)
    it = int(res.stats.iterations)
    tiers = set(res.stats.tiers[:it].tolist())
    if mode == "delta":
        # The settings reach a dense stratum and at least two sparse rungs.
        assert -1 in tiers and len(tiers - {-1}) >= 2


def test_executor_nodelta_matches_reference(setup):
    """An algorithm from make_algorithm run through the executor in
    nodelta mode rounds its dense body as adsorption.run does."""
    from repro_torch.core.engine import ShardedExecutor
    jvec, _ = _reference(setup, "nodelta", "sort")
    snap = setup["snap"]
    algo = TA.make_algorithm(snap, L, 1e-3, CAP["src_capacity"],
                             CAP["edge_capacity"])
    ex = ShardedExecutor(snapshot=snap, seg_capacity=CAP["edge_capacity"],
                         edge_capacity=CAP["edge_capacity"],
                         src_capacity=CAP["src_capacity"],
                         ladder_tiers=CAP["ladder_tiers"])
    res = ex.run(algo, TA.initial_state(snap, setup["seeds"], "cpu"),
                 snap.padded_keys, setup["tg"], 60, mode="nodelta")
    np.testing.assert_array_equal(
        np.asarray(jvec), TA.current_vec(res.state).reshape(-1, L).numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_delta_close_to_nodelta(setup, use_kernels):
    """tests/test_algorithms.py's bound, on the port."""
    kw = dict(threshold=1e-4, max_iters=60, device="cpu",
              use_kernels=use_kernels, **CAP)
    v_d, _ = TA.run(setup["tg"], setup["snap"], setup["seeds"], mode="delta",
                    **kw)
    v_n, _ = TA.run(setup["tg"], setup["snap"], setup["seeds"],
                    mode="nodelta", **kw)
    assert v_d.shape == (setup["snap"].padded_keys, L)
    assert float((v_d - v_n).abs().max()) < 5e-2


def test_vector_emission_helpers_match_reference(setup):
    rng = np.random.default_rng(3)
    jg, tg = setup["jg"], setup["tg"]
    j0 = jax.tree.map(lambda x: x[1], jg)
    t0 = CSRGraph(tg.indptr[1], tg.indices[1], tg.out_degree[1])
    B = t0.n_src
    active = rng.random(B) < 0.3
    payload = rng.normal(size=(B, L)).astype(np.float32)
    jout = JE.emit_over_edges_vec(j0, jnp.asarray(active),
                                  jnp.asarray(payload), 128, 1024)
    tout = TE.emit_over_edges_vec(t0, torch.from_numpy(active),
                                  torch.from_numpy(payload), 128, 1024)
    for f in ("keys", "payload", "ann", "count", "overflowed"):
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)),
                                      getattr(tout, f).numpy(), err_msg=f)
    # Incoming buffer of shard 1: keys in and out of its block, padding.
    block = setup["snap"].block_size
    keys = rng.integers(-1, 4 * block, 600).astype(np.int32)
    pay = rng.normal(size=(600, L)).astype(np.float32)
    jdb = JDeltaBuffer(keys=jnp.asarray(keys), payload=jnp.asarray(pay),
                       ann=jnp.zeros(600, jnp.int8),
                       count=jnp.int32(600), overflowed=jnp.bool_(False))
    tdb = convert.to_torch(DeltaBuffer, jdb, "cpu")
    np.testing.assert_array_equal(
        np.asarray(JE.scatter_local_vec(jdb, jnp.int32(1), block)),
        TE.scatter_local_vec(tdb, 1, block).numpy())


def test_state_conversion_and_types(setup):
    snap = setup["snap"]
    jst = JA.initial_state(setup["jsnap"], jnp.asarray(setup["seeds"]))
    tst = convert.to_torch(TA.AdsorptionState, jst, "cpu")
    ref = TA.initial_state(snap, setup["seeds"], "cpu")
    for f in TA.AdsorptionState._fields:
        assert getattr(tst, f).dtype == torch.float32
        assert torch.equal(getattr(tst, f), getattr(ref, f))
    back = convert.to_numpy(tst)
    np.testing.assert_array_equal(back["seed"], np.asarray(jst.seed))
    algo = TA.make_algorithm(snap, L)
    assert algo.payload_width == L and algo.bytes_per_delta == 4 + 4 * L
