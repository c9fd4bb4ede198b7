"""One algorithm object, two graphs: the dense body pushes over the graph
it is handed.

PageRank, SSSP and CC keep each shard's ragged CSC (edge_propagate's
layout) between strata.  A view reuses one ``DeltaAlgorithm`` while each
refresh hands the engine a rebuilt graph of the same shapes, so the CSC
must follow the graph: an algorithm that ran ``nodelta`` on graph A and
then runs on graph B must give exactly what a fresh algorithm gives on B.
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import connected_components as TC
from repro_torch.algorithms import pagerank as TP
from repro_torch.algorithms import sssp as TS
from repro_torch.core.engine import ShardedExecutor
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
from repro_torch.kernels import edge_propagate as ep

N, S, CAP = 512, 4, 4096


def two_graphs():
    """Graphs A and B: N vertices, S shards, equal shapes, other edges."""
    csrs = [make_powerlaw_graph(N, 6.0, seed=seed) for seed in (0, 1)]
    nnz = max(int(np.diff(ip[::N // S]).max()) for ip, _ in csrs)
    return [shard_csr(ip, ix, S, nnz_capacity=nnz, device="cpu")
            for ip, ix in csrs]


ALGOS = {
    "pagerank": (lambda snap: TP.make_algorithm(snap, 1e-3, snap.block_size,
                                                CAP),
                 lambda snap: TP.initial_state(snap, "cpu"),
                 lambda snap: snap.padded_keys),
    "sssp": (lambda snap: TS.make_algorithm(snap, snap.block_size, CAP),
             lambda snap: TS.initial_state(snap, 0, "cpu"),
             lambda snap: 1),
    "connected_components": (
        lambda snap: TC.make_algorithm(snap, snap.block_size, CAP),
        lambda snap: TC.initial_state(snap, "cpu"),
        lambda snap: snap.padded_keys),
}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_algorithm_reused_on_another_graph_equals_a_fresh_one(name):
    make, state0, live0 = ALGOS[name]
    snap = PartitionSnapshot(n_keys=N, num_shards=S)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=CAP, edge_capacity=CAP,
                         src_capacity=snap.block_size)
    graph_a, graph_b = two_graphs()
    assert graph_a.indices.shape == graph_b.indices.shape
    assert not torch.equal(graph_a.indices, graph_b.indices)

    def run(algo, graph):
        return ex.run(algo, state0(snap), live0(snap), graph, 40,
                      mode="nodelta")

    algo = make(snap)
    on_a = run(algo, graph_a)
    reused = run(algo, graph_b)
    fresh = run(make(snap), graph_b)
    assert not all(torch.equal(a, b) for a, b in zip(on_a.state,
                                                     fresh.state))
    for got, want in zip(reused.state, fresh.state):
        assert torch.equal(got, want)
    for field in fresh.stats._fields:
        assert torch.equal(getattr(reused.stats, field),
                           getattr(fresh.stats, field))


def test_csc_cache_rebuilds_when_and_only_when_the_graph_changes():
    graph_a, graph_b = two_graphs()
    cache = ep.CSCCache(N)
    g0 = type(graph_a)(graph_a.indptr[0], graph_a.indices[0],
                       graph_a.out_degree[0])
    first = cache.get(0, g0)
    assert cache.get(0, g0) is first                       # same graph
    assert cache.get(0, type(g0)(*(t.clone() for t in (
        g0.indptr, g0.indices, g0.out_degree)))) is not first  # a copy
    other = type(graph_b)(graph_b.indptr[0], graph_b.indices[0],
                          graph_b.out_degree[0])
    rebuilt = cache.get(0, other)
    want = ep.build_csc(other, N)
    for f in ("indptr", "src", "weight", "heavy"):
        assert torch.equal(getattr(rebuilt, f), getattr(want, f))
    # An in-place edit of the same tensors is a change too.
    edited = cache.get(0, other)
    other.indices[0] = (int(other.indices[0]) + 1) % N
    assert cache.get(0, other) is not edited
