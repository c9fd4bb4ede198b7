"""The port's multi-process launch on the CPU: the twins of the three
slow cases of ``tests/test_distributed.py``.

* ``python -m repro_torch.launch.distributed --selftest`` forms a gloo
  group of 2 worker processes on the CPU: each reports its rank, world,
  backend, device and contiguous block of the flat mesh's 4 shards, and
  one all_gather of the process ids.
* A REAL SIGKILL of a protocol worker mid-fixpoint (SSSP, 1,024
  vertices, 4 shards, 4 workers): the lease table detects the loss, the
  replica chain rebuilds the lost shard, a replacement process reseeds
  the ring, and the final state and stats equal the port's failure-free
  run and ``repro``'s ``run`` exactly.
* ``initialize_from_env`` forms a world of one from unset variables.
* ``python -m repro_torch.runtime.chaos --real``: a seeded schedule
  delivered as real signals still ends bit-identical to the failure-free
  run.

Every subprocess has a hard timeout; the in-process cluster is shut down
in a ``finally``, and each of its waits is bounded (``HealthConfig``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _run(*args):
    out = subprocess.run([sys.executable, "-m", *args], env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-2000:]
    return out.stdout


def test_selftest_cli_over_gloo():
    rep = json.loads(_run("repro_torch.launch.distributed", "--selftest",
                          "--workers", "2", "--backend", "gloo",
                          "--device", "cpu"))
    assert rep["collective_ok"] is True
    assert rep["backend"] == "gloo" and rep["num_shards"] == 4
    assert rep["devices"] == {"0": "cpu", "1": "cpu"}
    assert rep["ownership"] == {"0": [0, 1], "1": [2, 3]}


def test_initialize_from_env_forms_the_flat_mesh():
    """Unset variables: a world of one on a free local port, owning every
    shard; several processes without a coordinator: refused."""
    import torch.distributed as dist

    from repro_torch.launch.distributed import initialize_from_env
    mesh, mine = initialize_from_env(4, env={}, backend="gloo",
                                     device="cpu")
    try:
        assert (mesh.rank, mesh.world, mine) == (0, 1, [0, 1, 2, 3])
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="REPRO_COORDINATOR"):
        initialize_from_env(4, env={"REPRO_NUM_PROCESSES": "2"},
                            backend="gloo", device="cpu")


def test_real_sigkill_recovery_parity(tmp_path):
    from repro_torch.algorithms import sssp
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
    from repro_torch.launch.distributed import (Cluster,
                                                DistributedResilientDriver)
    from repro_torch.runtime.health import HealthConfig

    S, n = 4, 1024
    indptr, indices = make_powerlaw_graph(n, 8.0, 2.1, 0)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    cap = max(16384, 4 * n)

    def remake(new_snap):
        a = sssp.make_algorithm(new_snap, src_capacity=new_snap.block_size,
                                edge_capacity=cap)
        e = ShardedExecutor(snapshot=new_snap, seg_capacity=cap,
                            edge_capacity=cap,
                            src_capacity=new_snap.block_size,
                            ladder_tiers=4, route_strategy="auto")
        return e, a, shard_csr(indptr, indices, new_snap.num_shards,
                               device="cpu")

    ex, algo, g = remake(snap)
    state0 = sssp.initial_state(snap, 0, "cpu")
    ref = ex.run(algo, state0, 1, g, 80)

    cfg = HealthConfig(lease_ttl=1.0, straggle_after=0.3,
                       heartbeat_interval=0.05, ack_timeout=0.5,
                       ready_timeout=60.0)
    cluster = Cluster(str(tmp_path / "cluster"), S, num_shards=S,
                      config=cfg, detect="lease")
    killed = []

    def hook(drv):
        if not killed and drv.stratum >= 2:
            killed.append(drv.stratum)
            cluster.kill(1)

    try:
        cluster.start()
        ex2, algo2, _ = remake(snap)
        drv = DistributedResilientDriver(
            ex2, algo2, state0, 1, g, 80, ckpt_root=str(tmp_path / "chain"),
            cluster=cluster, remake=remake, chaos_hook=hook)
        res = drv.run()
    finally:
        cluster.shutdown()
    assert all(not p.alive() for p in cluster.procs.values())

    assert killed, "fixpoint converged before the kill stratum"
    assert res.metrics["final_num_shards"] == S
    for a, b in zip(ref.state, res.result.state):
        assert torch.equal(a, b)
    for f in ref.stats._fields:
        assert torch.equal(getattr(ref.stats, f),
                           getattr(res.result.stats, f)), f
    # The kill was DETECTED (lease deadline), not announced.
    dets = res.metrics["worker_detections"]
    assert [d["worker"] for d in dets] == [1]
    assert dets[0]["detection_s"] > 0
    names = [e["event"] for e in res.metrics["events"]]
    assert "worker_dead" in names and "failure" in names
    assert "worker_replaced" in names and "recovery" in names
    assert res.metrics["recoveries"] >= 1
    # Real ack arrival walls replaced the measured per-shard latencies.
    assert res.metrics["acks_collected"] > 0
    assert res.metrics["ack_timeouts"] >= 1      # the dead worker's
    assert all(len(row) == S for row in drv.measured.latencies)

    # ... and the reference's failure-free run.
    import jax.numpy as jnp
    from repro.algorithms import sssp as r_sssp
    from repro.core.engine import ShardedExecutor as RExecutor
    from repro.core.partition import PartitionSnapshot as RSnapshot
    from repro.data.graphs import shard_csr as r_shard_csr
    rsnap = RSnapshot(n_keys=n, num_shards=S)
    rex = RExecutor(snapshot=rsnap, seg_capacity=cap, edge_capacity=cap,
                    src_capacity=rsnap.block_size, ladder_tiers=4,
                    route_strategy="auto")
    want = rex.run(r_sssp.make_algorithm(rsnap, src_capacity=rsnap.block_size,
                                         edge_capacity=cap),
                   r_sssp.initial_state(rsnap, 0), 1,
                   r_shard_csr(indptr, indices, S), 80)
    np.testing.assert_array_equal(
        np.asarray(jnp.stack(want.state, -1)),
        torch.stack(res.result.state, -1).numpy())
    for f in want.stats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want.stats, f)),
                                      getattr(res.result.stats, f).numpy(),
                                      err_msg=f)


def test_chaos_real_cli_parity():
    summary = json.loads(_run(
        "repro_torch.runtime.chaos", "--seed", "0", "--events", "2",
        "--quick", "--nodes", "1024", "--real", "--device", "cpu"))
    assert summary["mode"] == "real" and summary["device"] == "cpu"
    assert summary["identical"] is True
    assert summary["signals_fired"], "no real signals were delivered"
