"""The shard_map backend over torch.distributed, on the CPU over gloo.

``world`` processes (2, then 4) each run every case twice, on the port's
simulated backend and on ``backend="shard_map"``, and write what they found
to a JSON file; the tests read those files.  At 512 vertices and 8 shards,
PageRank (delta, nodelta, delta with the torch-op path, traced with a
measured route table and an explicit condition, and stopped by a condition
that reads the state), SSSP, CC and adsorption must equal the simulated
backend bit for bit on every rank: values, state and every per-stratum
statistic.  Compiled PageRank, SSSP and CC on the shard_map backend must
equal the handwritten runs there, and graph views (SSSP, PageRank) on
shard_map must equal simulated views through a cold run and warm repairs.
Resilient SSSP and PageRank (shard 3 lost at half the strata) on
shard_map must equal the shard_map ``run`` and the simulated
``run_resilient``: state, stats, and metrics but the walls.
The twins of the reference's ``test_shard_map_identical_to_simulated``,
``test_ladder_bit_identical_shard_map``, ``test_bit_identical_shard_map``,
``test_resilient_shard_map_bit_identical``
and ``test_resume_shard_map_bit_identical_to_simulated`` (which fails on
jax 0.9.0, so the port's own simulated backend is the oracle of the view
cases).

Each rank also keeps its shard_map answers to PageRank (delta, nodelta),
SSSP, CC, adsorption and resilient SSSP, and the test process holds them
to ``repro``'s simulated backend on the same graph and executor settings
(resilient SSSP: ``run_resilient`` with the same failure): every stats
column exactly, SSSP and CC values exactly, float adds within 1 ulp.

The harness spawns the ranks with ``init_method=file://`` (no ports),
gives each spawn a hard timeout and kills every rank when it passes.  The
mesh helpers' unit tests run in the test process.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N, S = 512, 8
SPAWN_TIMEOUT_S = 120
# The executor both backends get: a ladder of three rungs under "auto"
# (sort on the small rungs, scatter on the top one) and a top rung small
# enough that the first strata fall back to the dense body.
EX = dict(seg_capacity=384, edge_capacity=384, src_capacity=48,
          ladder_tiers=3, ladder_src_floor=8, ladder_edge_floor=32,
          route_strategy="auto")
CASES = ["pagerank_delta", "pagerank_nodelta", "pagerank_torch_ops",
         "pagerank_traced_measured_cond", "pagerank_state_cond", "sssp",
         "cc", "adsorption", "stratum_fn", "rules_pagerank", "rules_sssp",
         "rules_cc", "view_sssp", "view_pagerank", "resilient_sssp",
         "resilient_pagerank"]
# The cases whose shard_map answers are also held to ``repro``, with the
# ulps their values may differ by (float adds: 1).
ANCHORED = {"pagerank_delta": 1, "pagerank_nodelta": 1, "sssp": 0, "cc": 0,
            "adsorption": 1, "resilient_sssp": 0}
# The resilient cases' failure: shard 3 lost at half the failure-free
# strata (``tests/test_resilient.py``'s shard_map case).
FAILED_SHARD = 3
SEEDS = (0, 5, 77, 300)   # adsorption's labelled vertices


# ---------------------------------------------------------------------------
# The rank's side.
# ---------------------------------------------------------------------------

def _same(a, b, what: str) -> list:
    """Mismatch messages between two results (tensors, trees, stats)."""
    if torch.is_tensor(a):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape:
            return [f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"]
        if not np.array_equal(a, b, equal_nan=True):
            return [f"{what}: {int((a != b).sum())} entries differ"]
        return []
    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        return [m for n, x, y in zip(names, a, b)
                for m in _same(x, y, f"{what}.{n}")]
    if isinstance(a, np.ndarray):
        return _same(torch.from_numpy(a), torch.from_numpy(np.asarray(b)),
                     what)
    return [] if a == b else [f"{what}: {a!r} vs {b!r}"]


def _rank_cases(rank: int, world: int, out_dir: str) -> dict:
    from repro_torch import frontend as F
    from repro_torch.algorithms import adsorption, connected_components
    from repro_torch.algorithms import pagerank, sssp
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
    from repro_torch.incremental import EdgeDelete, EdgeInsert, ViewManager
    from repro_torch.launch.mesh import flat_mesh
    from repro_torch.obs import Tracer
    from repro_torch.obs.calibrate import RouteCostTable
    from repro_torch.runtime import FaultPlan

    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    snap = PartitionSnapshot(n_keys=N, num_shards=S)
    g = shard_csr(indptr, indices, S, device="cpu")
    mesh = flat_mesh(S, device="cpu")
    assert mesh.world == world and mesh.rank == rank
    run_kw = dict(edge_capacity=EX["edge_capacity"],
                  src_capacity=EX["src_capacity"], device="cpu")

    def executors(**kw):
        kw = {**EX, **kw}
        return (ShardedExecutor(snapshot=snap, **kw),
                ShardedExecutor(snapshot=snap, backend="shard_map",
                                mesh=mesh, **kw))

    def twin(fn, **kw):
        """fn(executor) on both backends -> mismatches, shard_map result."""
        sim, smap = executors(**kw)
        a, b = fn(sim), fn(smap)
        return _same(a, b, "result"), b

    def keep(name, result):
        """Save a shard_map (values, FixpointResult) for the test process."""
        values, res = result
        np.savez(Path(out_dir, f"rank{rank}_{name}.npz"),
                 values=values.numpy(),
                 **{f: getattr(res.stats, f).numpy()
                    for f in res.stats._fields})

    def ladder_used(res) -> list:
        it = int(res.stats.iterations)
        tiers = set(res.stats.tiers[:it].tolist())
        return [] if -1 in tiers and len(tiers) >= 3 else [
            f"tiers {sorted(tiers)}: no dense stratum and two rungs"]

    out = {}

    def case(name):
        def deco(fn):
            t0 = time.perf_counter()
            try:
                msgs = fn()
            except Exception as e:  # reported, and the test fails on it
                msgs = [f"{type(e).__name__}: {e}"]
            out[name] = {"mismatches": msgs,
                         "seconds": time.perf_counter() - t0}
        return deco

    @case("pagerank_delta")
    def _():
        msgs, got = twin(lambda ex: pagerank.run(
            g, snap, executor=ex, **run_kw))
        keep("pagerank_delta", got)
        return msgs + ladder_used(got[1])

    @case("pagerank_nodelta")
    def _():
        msgs, got = twin(lambda ex: pagerank.run(g, snap, mode="nodelta",
                                                 executor=ex, **run_kw))
        keep("pagerank_nodelta", got)
        return msgs

    @case("pagerank_torch_ops")
    def _():
        return twin(lambda ex: pagerank.run(
            g, snap, executor=ex, use_kernels=False, threshold=1e-2,
            **run_kw),
            use_kernels=False, route_strategy="sort")[0]

    @case("pagerank_traced_measured_cond")
    def _():
        # Each rank holds its own table; rank 0's decides every rank's
        # routes (rank 0 measured scatter faster, the others sort).
        fast = (1.0, 0.5) if rank == 0 else (0.5, 1.0)
        table = RouteCostTable(backend="cpu", combiner="add",
                               entries={c: fast for c in (8, 32, 96, 384)})
        want = RouteCostTable(backend="cpu", combiner="add",
                              entries={c: (1.0, 0.5) for c in (8, 32, 96,
                                                               384)})
        algo = pagerank.make_algorithm(snap, 1e-3, EX["src_capacity"],
                                       EX["edge_capacity"])
        sim = ShardedExecutor(snapshot=snap, **{
            **EX, "route_strategy": "measured"}, route_table=want)
        tracer = Tracer()
        smap = ShardedExecutor(snapshot=snap, **{
            **EX, "route_strategy": "measured"}, route_table=table,
            backend="shard_map", mesh=mesh, tracer=tracer)
        runs = [ex.run(algo, pagerank.initial_state(snap, "cpu"), N, g, 60,
                       explicit_cond=lambda new, old, i: i < 39)
                for ex in (sim, smap)]
        msgs = _same(runs[0], runs[1], "run")
        it = int(runs[1].stats.iterations)
        spans = [e for e in tracer.events
                 if e["name"].startswith("stratum") and e["ph"] == "X"]
        if it != 40 or len(spans) != it:
            msgs.append(f"{it} strata, {len(spans)} spans")
        if 1 not in runs[1].stats.routes[:it].tolist():
            msgs.append("rank 0's table never routed by scatter")
        return msgs

    @case("pagerank_state_cond")
    def _():
        # Keep going while some vertex's sum still moves by 5e-2: read
        # over every shard this stops the run after 30 strata; a rank
        # that judged only its own shards would stop it after 22 (world
        # 2) or 18 (world 4).
        algo = pagerank.make_algorithm(snap, 1e-3, EX["src_capacity"],
                                       EX["edge_capacity"])

        def moving(new, old, i):
            return bool((new.acc - old.acc).abs().max() > 5e-2)

        runs = [ex.run(algo, pagerank.initial_state(snap, "cpu"), N, g, 60,
                       explicit_cond=moving) for ex in executors()]
        msgs = _same(runs[0], runs[1], "run")
        if int(runs[1].stats.iterations) != 30:
            msgs.append(f"{int(runs[1].stats.iterations)} strata, not 30")
        return msgs

    @case("sssp")
    def _():
        msgs, got = twin(lambda ex: sssp.run(g, snap, source=0,
                                             executor=ex, **run_kw))
        keep("sssp", got)
        return msgs

    @case("cc")
    def _():
        msgs, got = twin(lambda ex: connected_components.run(
            g, snap, executor=ex, **run_kw))
        keep("cc", got)
        return msgs

    @case("adsorption")
    def _():
        msgs, got = twin(lambda ex: adsorption.run(
            g, snap, _seeds(snap.padded_keys), executor=ex, **run_kw))
        keep("adsorption", got)
        return msgs

    @case("stratum_fn")
    def _():
        algo = sssp.make_algorithm(snap, EX["src_capacity"],
                                   EX["edge_capacity"])
        msgs = []
        sim, smap = executors()
        states = [sssp.initial_state(snap, 0, "cpu")] * 2
        for i in range(4):
            steps = [ex.make_stratum_fn(algo, g)(st, i)
                     for ex, st in zip((sim, smap), states)]
            msgs += _same(steps[0], steps[1], f"stratum {i}")
            states = [s[0] for s in steps]
        counts = [ex.live_count(algo, st, g)
                  for ex, st in zip((sim, smap), states)]
        return msgs + _same(counts[0], counts[1], "live_count")

    def rules_case(program, hand, **kw):
        cp = F.compile_program(program)
        _, smap = executors()
        compiled = cp.run(g, snap, executor=smap, max_iters=80, **run_kw)
        handwritten = hand.run(g, snap, executor=smap, max_iters=80,
                               **run_kw, **kw)
        return _same(compiled[0], handwritten[0], "values") + _same(
            compiled[1].stats, handwritten[1].stats, "stats")

    @case("rules_pagerank")
    def _():
        return rules_case(F.pagerank_program(), pagerank)

    @case("rules_sssp")
    def _():
        return rules_case(F.sssp_program(), sssp, source=0)

    @case("rules_cc")
    def _():
        return rules_case(F.cc_program(), connected_components)

    def view_case(algorithm, batches=2, **params):
        views = []
        for extra in ({}, dict(backend="shard_map")):
            mgr = ViewManager(fallback_threshold=1.0)
            views.append(mgr.create_graph_view(
                "v", algorithm, indptr.copy(), indices.copy(), N,
                num_shards=S, device="cpu", max_iters=120,
                edge_capacity=EX["edge_capacity"],
                src_capacity=EX["src_capacity"], resume_edge_capacity=96,
                resume_src_capacity=16, **params, **extra))
        if views[1].rule.resume_executor.mesh.world != world:
            return ["the view's executor has no mesh over the group"]
        msgs = _same(views[0].query(), views[1].query(), "cold")
        rng = np.random.default_rng(0)
        src = np.repeat(np.arange(N), np.diff(indptr))
        edges = [(int(u), int(v)) for u, v in zip(src, indices[:len(src)])
                 if u != v]
        for batch in range(batches):
            muts = [EdgeInsert(int(rng.integers(N)), int(rng.integers(N)))
                    for _ in range(6)]
            muts.append(EdgeDelete(*edges[batch * 7]))
            reports = []
            for v in views:
                v.apply(*muts)
                reports.append(v.refresh(force="repair"))
            if {r.mode for r in reports} != {"repair"}:
                msgs.append(f"batch {batch}: {[r.mode for r in reports]}")
            msgs += _same(views[0].query(), views[1].query(),
                          f"batch {batch}")
            msgs += _same(views[0].last_result.stats,
                          views[1].last_result.stats, f"batch {batch}")
        return msgs

    def resilient_case(mod, state0, live0):
        """``run_resilient`` with one failure on the shard_map backend
        against its ``run`` and against the simulated ``run_resilient``:
        state, stats, and metrics but the walls, bit for bit; each rank's
        replica chain in its own directory."""
        algo = mod.make_algorithm(snap, src_capacity=EX["src_capacity"],
                                  edge_capacity=EX["edge_capacity"])
        sim, smap = executors()
        ref = smap.run(algo, state0, live0, g, 80)
        plan = FaultPlan(fail_at=max(int(ref.stats.iterations) // 2, 1),
                         failed_shard=FAILED_SHARD)
        ckpt = Path(out_dir, f"ckpt_{mod.__name__.rsplit('.', 1)[1]}")
        runs = [ex.run_resilient(algo, state0, live0, g, 80,
                                 ckpt_root=str(ckpt / name), fault_plan=plan)
                for name, ex in ((f"sim{rank}", sim), ("smap", smap))]
        msgs = _same(tuple(ref), tuple(runs[1].result), "vs run")
        msgs += _same(tuple(runs[0].result), tuple(runs[1].result),
                      "vs simulated")
        metrics = [{k: v for k, v in r.metrics.items() if "wall" not in k}
                   for r in runs]
        msgs += [f"metrics[{k!r}] differ" for k in metrics[0]
                 if metrics[0][k] != metrics[1].get(k)]
        if runs[1].metrics["recoveries"] != 1:
            msgs.append(f"{runs[1].metrics['recoveries']} recoveries")
        # shard_map keeps one chain a rank, in ckpt_root/rank{r}.
        chains = os.listdir(ckpt / "smap")
        if f"rank{rank}" not in chains or not all(
                c.startswith("rank") for c in chains):
            msgs.append(f"chain directories {chains}")
        return msgs, runs[1].result

    def rescale_case():
        """A rescale to 4 shards mid-run on shard_map equals the simulated
        driver's; one to 3 shards, which do not split over the ranks,
        raises before any collective."""
        def remaker(**kw):
            def remake(new_snap):
                if kw:
                    kw["mesh"] = flat_mesh(new_snap.num_shards, device="cpu")
                return (ShardedExecutor(snapshot=new_snap, **EX, **kw),
                        sssp.make_algorithm(new_snap, EX["src_capacity"],
                                            EX["edge_capacity"]),
                        shard_csr(indptr, indices, new_snap.num_shards,
                                  device="cpu"))
            return remake

        algo = sssp.make_algorithm(snap, EX["src_capacity"],
                                   EX["edge_capacity"])
        state0 = sssp.initial_state(snap, 0, "cpu")
        sim, smap = executors()
        ckpt = Path(out_dir, "ckpt_rescale")
        runs = [ex.run_resilient(
            algo, state0, 1, g, 80, ckpt_root=str(ckpt / name),
            remake=remake, fault_plan=FaultPlan(rescale_at=2,
                                                new_num_shards=4))
            for name, ex, remake in (
                (f"sim{rank}", sim, remaker()),
                ("smap", smap, remaker(backend="shard_map")))]
        msgs = _same(tuple(runs[0].result), tuple(runs[1].result),
                     "rescaled")
        if runs[1].metrics["final_num_shards"] != 4:
            msgs.append(f"{runs[1].metrics['final_num_shards']} shards")
        try:
            smap.run_resilient(algo, state0, 1, g, 80,
                               ckpt_root=str(ckpt / "odd"),
                               remake=remaker(backend="shard_map"),
                               fault_plan=FaultPlan(rescale_at=2,
                                                    new_num_shards=3))
            msgs.append("a rescale to 3 shards did not raise")
        except ValueError as e:
            if "does not split" not in str(e):
                msgs.append(f"ValueError: {e}")
        return msgs

    @case("resilient_sssp")
    def _():
        msgs, got = resilient_case(sssp, sssp.initial_state(snap, 0, "cpu"),
                                   1)
        keep("resilient_sssp", (got.state.dist.reshape(-1), got))
        return msgs + rescale_case()

    @case("resilient_pagerank")
    def _():
        return resilient_case(pagerank, pagerank.initial_state(snap, "cpu"),
                              snap.padded_keys)[0]

    @case("view_sssp")
    def _():
        return view_case("sssp", source=0)

    @case("view_pagerank")
    def _():
        return view_case("pagerank", threshold=1e-3, batches=1)

    return out


def _seeds(padded_keys: int) -> np.ndarray:
    seeds = np.zeros((padded_keys, len(SEEDS)), np.float32)
    for lab, v in enumerate(SEEDS):
        seeds[v, lab] = 1.0
    return seeds


def _rank_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_shard_group
    torch.set_num_threads(1)
    init_shard_group("gloo", f"file://{init_file}", world_size=world,
                     rank=rank)
    try:
        out = _rank_cases(rank, world, out_dir)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# The harness.
# ---------------------------------------------------------------------------

def spawn(world: int, tmp: Path, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``world`` ranks of this file; -> each rank's findings.  Every
    rank is killed, and the test fails, once ``timeout`` seconds pass."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world),
             str(tmp / "pg_init"), str(tmp)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
        log.close()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = "".join(
        f"\n--- rank {r} (exit {p.returncode}) ---\n"
        + (tmp / f"rank{r}.log").read_text()[-3000:]
        for r, p in enumerate(procs) if p.returncode != 0)
    if tails:
        pytest.fail(f"world {world}: a rank failed or timed out{tails}")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"world{world}")
    return world, spawn(world, tmp), tmp


@pytest.mark.parametrize("case", CASES)
def test_shard_map_equals_simulated(ranks, case):
    world, found, _ = ranks
    for rank, rec in enumerate(found):
        assert rec[case]["mismatches"] == [], (world, rank)


@pytest.fixture(scope="module")
def reference():
    """case -> ``repro``'s (values, FixpointResult) on its simulated
    backend, the ranks' graph and executor settings (run on first use)."""
    import gc

    import tempfile

    import jax
    from repro.algorithms import adsorption, connected_components
    from repro.algorithms import pagerank, sssp
    from repro.core.engine import ShardedExecutor
    from repro.core.partition import PartitionSnapshot
    from repro.data.graphs import make_powerlaw_graph, shard_csr
    from repro.runtime import FaultPlan

    indptr, indices = make_powerlaw_graph(N, avg_degree=8.0, seed=0)
    snap = PartitionSnapshot(n_keys=N, num_shards=S)
    g = shard_csr(indptr, indices, S)
    kw = dict(executor=ShardedExecutor(snapshot=snap, **EX),
              edge_capacity=EX["edge_capacity"],
              src_capacity=EX["src_capacity"])
    runs = {
        "pagerank_delta": lambda: pagerank.run(g, snap, **kw),
        "pagerank_nodelta": lambda: pagerank.run(g, snap, mode="nodelta",
                                                 **kw),
        "sssp": lambda: sssp.run(g, snap, source=0, **kw),
        "cc": lambda: connected_components.run(g, snap, **kw),
        "adsorption": lambda: adsorption.run(
            g, snap, _seeds(snap.padded_keys), **kw),
        "resilient_sssp": lambda: resilient_sssp(get("sssp")[1])}
    done = {}

    def resilient_sssp(run):
        algo = sssp.make_algorithm(snap, src_capacity=EX["src_capacity"],
                                   edge_capacity=EX["edge_capacity"])
        plan = FaultPlan(fail_at=max(int(run.stats.iterations) // 2, 1),
                         failed_shard=FAILED_SHARD)
        with tempfile.TemporaryDirectory() as td:
            rr = kw["executor"].run_resilient(
                algo, sssp.initial_state(snap, 0), 1, g, 80, ckpt_root=td,
                fault_plan=plan)
        assert rr.metrics["recoveries"] == 1
        return rr.result.state.dist.reshape(-1), rr.result

    def get(case):
        if case not in done:
            done[case] = runs[case]()
        return done[case]

    yield get
    done.clear()
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("case", sorted(ANCHORED))
def test_shard_map_equals_reference(ranks, reference, case):
    """Every rank's shard_map answer equals ``repro``'s simulated one."""
    world, _, tmp = ranks
    want_values, want = reference(case)
    want_values = np.asarray(want_values)
    for rank in range(world):
        got = np.load(tmp / f"rank{rank}_{case}.npz")
        for f in want.stats._fields:
            a = np.asarray(getattr(want.stats, f))
            assert a.dtype == got[f].dtype, (world, rank, f)
            np.testing.assert_array_equal(a, got[f],
                                          err_msg=f"{world} {rank} {f}")
        assert got["values"].dtype == want_values.dtype
        if ANCHORED[case]:
            np.testing.assert_array_max_ulp(want_values, got["values"],
                                            maxulp=ANCHORED[case])
        else:
            np.testing.assert_array_equal(want_values, got["values"])


# ---------------------------------------------------------------------------
# Mesh helpers, in this process.
# ---------------------------------------------------------------------------

def _mesh(world, rank, S=8):
    from repro_torch.launch.mesh import ShardMesh
    return ShardMesh(num_shards=S, rank=rank, world=world,
                     device=torch.device("cpu"))


def test_shard_ownership():
    from repro_torch.launch.mesh import (local_mesh, local_shards,
                                         shard_process_indices)
    m = _mesh(4, 1)
    assert shard_process_indices(m) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert local_shards(m) == range(2, 4)
    assert local_shards(m, 3) == range(6, 8)
    assert local_shards(_mesh(1, 0), 0) == range(8)
    # The simulated backend's mesh: every shard here, identity
    # collectives.
    one = local_mesh(8, "cpu")
    t = torch.arange(6.0).view(2, 3).t()
    assert local_shards(one) == range(8) and one.world == 1
    assert one.all_to_all(t) is t and one.all_gather(t) is t
    assert one.all_reduce(t, "sum") is t


def test_flat_mesh_needs_a_group_and_an_even_split(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import (flat_mesh, init_shard_group,
                                         local_shards)
    with pytest.raises(ValueError, match="process group"):
        flat_mesh(8, device="cpu")
    init_shard_group("gloo", f"file://{tmp_path / 'pg'}", world_size=1,
                     rank=0)
    try:
        m = flat_mesh(8, device="cpu")
        assert (m.rank, m.world, local_shards(m)) == (0, 1, range(8))
        dist.destroy_process_group()
        init_shard_group("gloo", f"file://{tmp_path / 'pg2'}",
                         world_size=1, rank=0)
        with pytest.raises(ValueError, match="split evenly"):
            flat_mesh(0, device="cpu")
    finally:
        dist.destroy_process_group()


def test_uneven_split_raises_for_every_world():
    """S % world != 0 raises before any collective (checked on a mesh a
    world of 3 would build)."""
    from repro_torch.launch import mesh as M

    class _Dist:   # a stand-in group of 3 ranks
        @staticmethod
        def is_available():
            return True

        is_initialized = is_available

        @staticmethod
        def get_world_size(group=None):
            return 3

        @staticmethod
        def get_rank(group=None):
            return 0

    real = M.dist
    M.dist = _Dist
    try:
        with pytest.raises(ValueError, match="8 does not split evenly"):
            M.flat_mesh(8, device="cpu")
        assert M.flat_mesh(9, device="cpu").shards_per_rank == 3
    finally:
        M.dist = real


def test_defaults_refuse_the_cpu():
    """Without CUDA the default backend and device raise; nothing falls
    back to the CPU."""
    from repro_torch.launch.mesh import _default_device, init_shard_group
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="gloo"):
        init_shard_group()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _default_device(0)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
