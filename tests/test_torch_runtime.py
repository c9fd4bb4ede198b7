"""The port's runtime building blocks against the reference's.

Retry policies, fault-schedule validation, seeded chaos schedules, the
straggler feed, elastic migration and checkpoints.  Checkpoints share one
on-disk format: each package reads what the other wrote (full and delta
checkpoints, replica chains), and the integrity cases of
``tests/test_chaos.py`` hold on the port's manager.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from repro.core.partition import PartitionSnapshot as JSnapshot
from repro.runtime import chaos as jchaos
from repro.runtime import checkpoint as jckpt
from repro.runtime import elastic as jelastic
from repro.runtime import recovery as jrec
from repro.runtime import retry as jretry
from repro.runtime import straggler as jstrag

from repro_torch import convert
from repro_torch.algorithms.sssp import SPState
from repro_torch.core.delta import PAD_KEY
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.runtime import chaos, elastic
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            CheckpointManager,
                                            atomic_write_json)
from repro_torch.runtime.recovery import (FaultEvent, FaultPlan,
                                          FaultSchedule, ReplicaChain,
                                          as_schedule, pack_state,
                                          unpack_state)
from repro_torch.runtime.retry import (RecoveryExhausted, Retrier,
                                       RetryBudget, RetryPolicy)
from repro_torch.runtime.straggler import (SpeculationPolicy,
                                           StragglerMitigator)
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# Retry policy: deterministic backoff, budgets, timeouts.
# ---------------------------------------------------------------------------

class TestRetry:
    def test_backoff_deterministic_seeded_bounded_and_equal(self):
        p = RetryPolicy(base_delay=0.01, max_delay=1.0, jitter=0.5, seed=7)
        jp = jretry.RetryPolicy(base_delay=0.01, max_delay=1.0, jitter=0.5,
                                seed=7)
        for attempt in range(6):
            d1 = p.backoff("restore:1", attempt)
            assert d1 == p.backoff("restore:1", attempt)
            assert d1 == jp.backoff("restore:1", attempt)
            raw = min(0.01 * 2 ** attempt, 1.0)
            assert raw * 0.5 <= d1 <= raw * 1.5
        assert p.backoff("restore:1", 0) != p.backoff("restore:2", 0)
        q = RetryPolicy(base_delay=0.01, max_delay=1.0, jitter=0.5, seed=8)
        assert p.backoff("restore:1", 3) != q.backoff("restore:1", 3)

    def test_retrier_retries_transient_then_succeeds(self):
        calls = {"n": 0}
        slept = []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        r = Retrier(policy=RetryPolicy(max_attempts=4), sleep=slept.append)
        assert r.call(flaky, op="read") == "ok"
        assert calls["n"] == 3 and len(slept) == 2
        assert [e["kind"] for e in r.events] == ["retry", "retry"]

    def test_exhaustion_kinds_distinguish_local_from_budget(self):
        r = Retrier(policy=RetryPolicy(max_attempts=2),
                    sleep=lambda s: None)
        with pytest.raises(RecoveryExhausted) as ei:
            r.call(lambda: (_ for _ in ()).throw(OSError("x")), op="rd")
        assert ei.value.kind == "attempts"
        b = RetryBudget(max_attempts=1, max_recoveries=1)
        b.draw_attempt("op")
        with pytest.raises(RecoveryExhausted) as ei:
            b.draw_attempt("op")
        assert ei.value.kind == "budget:attempts"
        b.draw_recovery("restore")
        with pytest.raises(RecoveryExhausted) as ei:
            b.draw_recovery("restore")
        assert ei.value.kind == "budget:recoveries"
        assert b.snapshot()["recoveries_used"] == 2

    def test_timeout_reports_but_returns_value(self):
        clock = iter([0.0, 10.0])
        r = Retrier(policy=RetryPolicy(timeout=0.5),
                    clock=lambda: next(clock), sleep=lambda s: None)
        assert r.call(lambda: 42, op="slow", shard=3) == 42
        (ev,) = r.drain_timeouts()
        assert ev["shard"] == 3 and ev["elapsed_s"] == 10.0

    def test_nonretryable_errors_pass_through(self):
        r = Retrier(sleep=lambda s: None)
        with pytest.raises(ZeroDivisionError):
            r.call(lambda: 1 / 0, op="math")
        assert r.events == []

    def test_policy_validation_names_field(self):
        with pytest.raises(ValueError, match="max_attempts"):
            RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError, match="jitter"):
            RetryPolicy(jitter=1.5)


# ---------------------------------------------------------------------------
# Schedule validation and seeded chaos schedules.
# ---------------------------------------------------------------------------

class TestScheduleValidation:
    def test_faultplan_errors_name_field_and_value(self):
        with pytest.raises(ValueError,
                           match=r"FaultPlan\.strategy.*'bogus'"):
            FaultPlan(strategy="bogus")
        with pytest.raises(ValueError, match=r"collide on stratum 3"
                                             r".*FaultSchedule"):
            FaultPlan(fail_at=3, rescale_at=3, new_num_shards=8)
        with pytest.raises(ValueError,
                           match=r"rescale_at.*new_num_shards"):
            FaultPlan(rescale_at=2)
        with pytest.raises(ValueError, match=r"FaultPlan\.fail_at.*-1"):
            FaultPlan(fail_at=-1)

    def test_faultevent_validation(self):
        with pytest.raises(ValueError, match=r"FaultEvent\.kind.*'boom'"):
            FaultEvent(kind="boom", at=0)
        with pytest.raises(ValueError, match=r"slowdown > 1\.0"):
            FaultEvent(kind="straggle", at=0, slowdown=0.5)
        with pytest.raises(ValueError, match="new_num_shards"):
            FaultEvent(kind="rescale", at=0)
        with pytest.raises(ValueError, match=r"FaultEvent\.during"):
            FaultEvent(kind="fail", at=0, during="lunch")

    def test_schedule_ordering_and_anchors(self):
        with pytest.raises(ValueError, match="non-decreasing"):
            FaultSchedule(events=(FaultEvent(kind="fail", at=5),
                                  FaultEvent(kind="fail", at=2)))
        with pytest.raises(ValueError, match="during='recovery'"):
            FaultSchedule(events=(
                FaultEvent(kind="fail", at=2, during="recovery"),))
        with pytest.raises(ValueError, match="during='rescale'"):
            FaultSchedule(events=(
                FaultEvent(kind="fail", at=2, during="rescale"),))

    def test_faultplan_converts_losslessly(self):
        plan = FaultPlan(fail_at=5, failed_shard=2, rescale_at=2,
                         new_num_shards=8, strategy="incremental")
        sched = plan.to_schedule()
        assert [e.kind for e in sched.events] == ["rescale", "fail"]
        assert sched.events[1].shard == 2 and sched.events[1].at == 5
        assert as_schedule(None).events == ()
        assert as_schedule(sched) is sched
        with pytest.raises(ValueError, match="FaultPlan or FaultSchedule"):
            as_schedule("nope")

    @pytest.mark.parametrize("strategy", ["incremental", "restart"])
    @pytest.mark.parametrize("seed", [0, 7, 19, 4242])
    def test_generated_schedules_equal_reference(self, seed, strategy):
        kw = dict(seed=seed, num_shards=4, n_events=4, max_stratum=6,
                  strategy=strategy)
        got = chaos.generate_schedule(chaos.ChaosConfig(**kw))
        want = jchaos.generate_schedule(jchaos.ChaosConfig(**kw))
        assert got.strategy == want.strategy
        assert [dataclasses.asdict(e) for e in got.events] == [
            dataclasses.asdict(e) for e in want.events]
        acc = chaos.acceptance_schedule(num_shards=8, strategy=strategy)
        jacc = jchaos.acceptance_schedule(num_shards=8, strategy=strategy)
        assert [dataclasses.asdict(e) for e in acc.events] == [
            dataclasses.asdict(e) for e in jacc.events]

    def test_chaos_config_validation(self):
        with pytest.raises(ValueError, match="n_events"):
            chaos.ChaosConfig(n_events=0)
        with pytest.raises(ValueError, match="min_shards"):
            chaos.ChaosConfig(min_shards=3, max_shards=2)


class TestLeftForSlice8:
    def test_real_chaos_and_reshard_raise_naming_their_slice(self,
                                                             tmp_path):
        """Slice 8 is ported: the real chaos executor fires nothing on an
        empty schedule and ``--real`` refuses the CPU unless asked
        (``tests/test_torch_launch.py`` runs it); ``reshard_tree`` (slice
        9h) re-commits a tree onto a one-rank gloo mesh, every whole value
        unchanged bit for bit (``tests/test_torch_sharded_lm.py`` moves
        one across meshes of 4 ranks)."""
        inj = chaos.RealChaosInjector(FaultSchedule(), cluster=None)

        class _Driver:
            stratum = 5
        inj(_Driver())
        assert inj.fired == [] and inj.skipped == [] and inj.pending == []
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                chaos.main(["--real", "--quick", "--nodes", "64"])
        import torch.distributed as dist

        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import init_shard_group, make_mesh
        g = torch.Generator().manual_seed(0)
        tree = {"embed": torch.randn(32, 16, generator=g),
                "units": {"wq": torch.randn(2, 16, 8, generator=g)},
                "tail": [torch.randn(16, generator=g).to(torch.bfloat16)]}
        init_shard_group("gloo", f"file://{tmp_path / 'pg'}", world_size=1,
                         rank=0)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
            out = elastic.reshard_tree(tree, mesh, sharding.tree_specs)
            assert sharding.is_dtensor(out["units"]["wq"])
            pairs = [(tree["embed"], out["embed"]),
                     (tree["units"]["wq"], out["units"]["wq"]),
                     (tree["tail"][0], out["tail"][0])]
            again = elastic.reshard_tree(out, mesh, sharding.tree_specs)
            pairs.append((tree["embed"], again["embed"]))
            for want, got in pairs:
                whole = sharding.full(got)
                assert whole.dtype == want.dtype and torch.equal(whole, want)
        finally:
            dist.destroy_process_group()

    def test_chaos_cli_on_the_cpu(self, capsys):
        rc = chaos.main(["--seed", "3", "--events", "2", "--quick",
                         "--nodes", "1024", "--device", "cpu"])
        summary = json.loads(capsys.readouterr().out)
        assert rc == 0 and summary["identical"] is True
        assert summary["faults"] >= 1


# ---------------------------------------------------------------------------
# Straggler feed.
# ---------------------------------------------------------------------------

class TestStraggler:
    def test_note_timeout_promotes_shard_to_straggler(self):
        m = StragglerMitigator(4, SpeculationPolicy(threshold=2.0,
                                                    min_history=1))
        for _ in range(2):
            m.observe_stratum([1.0, 1.0, 1.0, 1.0])
        m.note_timeout(2)
        report = m.observe_stratum([1.0, 1.0, 1.0, 1.0])
        assert [d["shard"] for d in report["speculations"]] == [2]
        report = m.observe_stratum([1.0, 1.0, 1.0, 1.0])
        assert report["speculations"] == []

    def test_reports_equal_reference(self):
        rng = np.random.default_rng(0)
        pol = dict(threshold=2.0, min_history=2)
        m = StragglerMitigator(4, SpeculationPolicy(**pol))
        jm = jstrag.StragglerMitigator(4, jstrag.SpeculationPolicy(**pol))
        for k in range(8):
            lat = rng.uniform(1.0, 2.0, 4).tolist()
            lat[k % 4] *= 5.0
            if k == 5:
                m.note_timeout(1)
                jm.note_timeout(1)
            assert m.observe_stratum(lat) == jm.observe_stratum(lat)
        assert m.saved_time == jm.saved_time


# ---------------------------------------------------------------------------
# Elastic migration.
# ---------------------------------------------------------------------------

class TestElastic:
    @settings(max_examples=10, deadline=None)
    @given(combiner=st.sampled_from(["add", "min", "max", "replace"]),
           n_entries=st.integers(0, 4), seed=st.integers(0, 1 << 16))
    def test_migrate_route_buffers_equals_reference(self, combiner,
                                                    n_entries, seed):
        rng = np.random.default_rng(seed)
        entries = []
        for _ in range(n_entries):
            k = rng.choice(64, size=int(rng.integers(1, 20)),
                           replace=False).astype(np.int32)
            entries.append((k, rng.normal(size=(len(k), 1)).astype(
                np.float32)))
        got = elastic.migrate_route_buffers(
            PartitionSnapshot(n_keys=64, num_shards=8), entries, 1,
            combiner=combiner)
        want = jelastic.migrate_route_buffers(
            JSnapshot(n_keys=64, num_shards=8), entries, 1,
            combiner=combiner)
        for f in ("keys", "payload", "count", "overflowed"):
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          getattr(got, f).numpy(),
                                          err_msg=f)
        live = got.keys != PAD_KEY
        np.testing.assert_array_equal(np.asarray(want.ann)[live.numpy()],
                                      got.ann[live].numpy())

    def test_apply_route_buffer_remap_and_grow(self):
        rng = np.random.default_rng(1)
        snap = PartitionSnapshot(n_keys=60, num_shards=4)
        new = snap.resnapshot(8)
        state = torch.from_numpy(rng.normal(size=(4, snap.block_size, 2))
                                 .astype(np.float32))
        want = jelastic.remap_state(JSnapshot(60, 4), JSnapshot(60, 8),
                                    jnp.asarray(state.numpy()))
        got = elastic.remap_state(snap, new, state)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        snap2, (g2,) = elastic.grow(snap, 8, state)
        assert snap2 == new and torch.equal(g2, got)
        keys = np.array([0, 9, 17, 59], np.int32)
        routed = elastic.migrate_route_buffers(
            new, [(keys, np.ones((4, 2), np.float32))], 2)
        block = np.zeros((new.block_size, 2), np.float32)
        for s in range(8):
            out = elastic.apply_route_buffer(routed, new, s, block)
            owned = [k % new.block_size for k in keys
                     if k // new.block_size == s]
            assert np.all(out[owned] == 1.0)
            assert out.sum() == 2.0 * len(owned)
        assert snap.global_keys(2, 3) == 2 * snap.block_size + 3


# ---------------------------------------------------------------------------
# Checkpoints: one format, read both ways; integrity.
# ---------------------------------------------------------------------------

def _trees(v: float):
    """The same tree in each package's terms: (reference, port)."""
    a = np.arange(5, dtype=np.float32) + v
    c = np.ones((2, 3), np.float32) * v
    d = np.arange(4, dtype=np.int32)
    j = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c)},
         "sp": jrec_state(d)}
    t = {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c)},
         "sp": SPState(dist=torch.from_numpy(d.astype(np.float32)),
                       sent=torch.from_numpy(d.astype(np.float32) + 1))}
    return j, t


def jrec_state(d):
    from repro.algorithms.sssp import SPState as JSPState
    return JSPState(dist=jnp.asarray(d, jnp.float32),
                    sent=jnp.asarray(d, jnp.float32) + 1)


def _equal_trees(j, t):
    np.testing.assert_array_equal(np.asarray(j["a"]), t["a"].numpy())
    np.testing.assert_array_equal(np.asarray(j["b"]["c"]),
                                  t["b"]["c"].numpy())
    for f in ("dist", "sent"):
        np.testing.assert_array_equal(np.asarray(getattr(j["sp"], f)),
                                      getattr(t["sp"], f).numpy())


class TestCheckpointFormat:
    def test_port_reads_reference_and_back(self, tmp_path):
        jt, tt = _trees(1.5)
        jm = jckpt.CheckpointManager(str(tmp_path / "j"), num_nodes=4)
        jm.save_full(1, 7, jt)
        jm.save_delta(1, 8, np.arange(3, dtype=np.int32),
                      np.ones((3, 2), np.float32), meta={"k": 1})
        tm = CheckpointManager(str(tmp_path / "j"), num_nodes=4)
        got, step = tm.load_full(1, _trees(0.0)[1])
        assert step == 7
        assert isinstance(got["sp"], SPState) and got["a"].dtype == \
            torch.float32
        _equal_trees(jt, got)
        (s, k, p, meta), = tm.replay_deltas(1, since_step=7,
                                            from_replica=True,
                                            with_meta=True)
        assert s == 8 and meta == {"k": 1} and k.tolist() == [0, 1, 2]

        tm2 = CheckpointManager(str(tmp_path / "t"), num_nodes=4)
        tm2.save_full(2, 3, tt)
        tm2.save_delta(2, 4, np.arange(2, dtype=np.int32),
                       np.full((2, 1), 2.0, np.float32))
        jm2 = jckpt.CheckpointManager(str(tmp_path / "t"), num_nodes=4)
        back, step = jm2.load_full(2, _trees(0.0)[0], from_replica=True)
        assert step == 3
        _equal_trees(back, tt)
        (s, k, p), = jm2.replay_deltas(2, since_step=3)
        assert s == 4 and p.tolist() == [[2.0], [2.0]]
        assert sorted(os.listdir(tmp_path / "t" / "node2")) == [
            "MANIFEST.json", "delta_00000004_of2.npz",
            "full_00000003_of2.npz"]

    def test_replica_chains_restore_across_packages(self, tmp_path):
        rng = np.random.default_rng(2)
        snap, jsnap = PartitionSnapshot(64, 4), JSnapshot(64, 4)
        packed = rng.normal(size=(4, 16, 2)).astype(np.float32)
        for writer, wsnap, reader, rsnap in (
                (jrec.ReplicaChain, jsnap, ReplicaChain, snap),
                (ReplicaChain, snap, jrec.ReplicaChain, jsnap)):
            root = str(tmp_path / writer.__module__)
            w = writer(root, wsnap, 2)
            w.open_epoch()
            w.baseline(packed)
            cur = packed.copy()
            for _ in range(3):
                cur[:, rng.choice(16, 5, replace=False)] = rng.normal(
                    size=(4, 5, 2)).astype(np.float32)
                w.append(cur)
            w.wipe(1)
            r = reader(root, rsnap, 2, fresh=False)
            r.open_epoch()
            r.prev = cur
            np.testing.assert_array_equal(np.asarray(r.restore_shard(1)),
                                          cur[1])

    def test_pack_unpack_round_trip(self):
        st = SPState(dist=torch.arange(8.0).reshape(2, 4),
                     sent=torch.full((2, 4), float("inf")))
        packed = pack_state(st)
        assert packed.shape == (2, 4, 2) and packed.dtype == np.float32
        back = unpack_state(st, packed * 2)
        assert isinstance(back, SPState)
        assert torch.equal(back.dist, st.dist * 2)
        with pytest.raises(ValueError, match="float32"):
            pack_state((torch.zeros(2, 4), torch.zeros(2, 4,
                                                       dtype=torch.int32)))
        jpacked = jrec.pack_state(tuple(jnp.asarray(x.numpy())
                                        for x in st))
        np.testing.assert_array_equal(jpacked, packed)


class TestCheckpointIntegrity:
    def _tree(self, v: float):
        return {"mut": torch.full((8, 2), v)}

    def test_bit_flip_detected_quarantined_and_replica_wins(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), num_nodes=4, replication=3)
        cm.save_full(0, 1, self._tree(1.25))
        own = tmp_path / "node0" / "full_00000001_of0.npz"
        raw = bytearray(own.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        own.write_bytes(bytes(raw))
        tree, step = cm.load_full(0, self._tree(0.0), from_replica=True)
        assert step == 1
        assert torch.equal(tree["mut"], self._tree(1.25)["mut"])
        assert len(cm.quarantined) == 1
        assert os.path.basename(os.path.dirname(cm.quarantined[0])) \
            == "quarantine"
        assert not own.exists()

    def test_torn_write_falls_back_to_previous_step(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), num_nodes=4, replication=3)
        cm.save_full(0, 1, self._tree(1.0))
        cm.save_full(0, 2, self._tree(2.0))
        for node in (0, 1, 2):
            p = tmp_path / f"node{node}" / "full_00000002_of0.npz"
            p.write_bytes(p.read_bytes()[:len(p.read_bytes()) // 2])
        tree, step = cm.load_full(0, self._tree(0.0), from_replica=True)
        assert step == 1
        assert torch.equal(tree["mut"], self._tree(1.0)["mut"])
        assert len(cm.quarantined) == 3

    def test_all_copies_torn_raises_corruption_not_garbage(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), num_nodes=2, replication=2)
        cm.save_full(0, 1, self._tree(1.0))
        for node in (0, 1):
            p = tmp_path / f"node{node}" / "full_00000001_of0.npz"
            p.write_bytes(b"torn")
        with pytest.raises(CheckpointCorruption):
            cm.load_full(0, self._tree(0.0), from_replica=True)

    def test_corrupt_delta_reads_from_replica(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), num_nodes=3, replication=2)
        cm.save_full(0, 0, self._tree(0.0))
        cm.save_delta(0, 1, np.arange(3, dtype=np.int32),
                      np.ones((3, 2), np.float32))
        p = tmp_path / "node0" / "delta_00000001_of0.npz"
        p.write_bytes(p.read_bytes()[:40])
        steps = list(cm.replay_deltas(0, since_step=0, from_replica=True))
        assert len(steps) == 1 and steps[0][0] == 1
        np.testing.assert_array_equal(steps[0][2],
                                      np.ones((3, 2), np.float32))

    def test_atomic_write_survives_failed_replace(self, tmp_path,
                                                  monkeypatch):
        path = str(tmp_path / "m" / "views.json")
        atomic_write_json(path, {"v": 1})

        def boom(src, dst):
            raise OSError("crash mid-replace")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            atomic_write_json(path, {"v": 2})
        monkeypatch.undo()
        with open(path) as f:
            assert json.load(f) == {"v": 1}
        assert os.listdir(tmp_path / "m") == ["views.json"]

    def test_epoch_gc_keeps_only_recent_epochs(self, tmp_path):
        snap = PartitionSnapshot(n_keys=64, num_shards=4)
        chain = ReplicaChain(str(tmp_path / "c"), snap, 2, keep_epochs=2)
        packed = np.zeros((4, snap.block_size, 2), np.float32)
        for _ in range(4):
            chain.open_epoch()
            chain.baseline(packed)
        left = sorted(d for d in os.listdir(tmp_path / "c")
                      if d.startswith("epoch"))
        assert left == ["epoch2", "epoch3"]

    def test_gc_and_wipe(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), num_nodes=2, replication=2,
                               keep=2)
        for step in range(1, 5):
            cm.save_full(1, step, self._tree(float(step)))
        fulls = sorted(f for f in os.listdir(tmp_path / "node1")
                       if f.startswith("full_"))
        assert fulls == ["full_00000003_of1.npz", "full_00000004_of1.npz"]
        cm.wipe_node(1)
        with pytest.raises(FileNotFoundError):
            cm.load_full(1, self._tree(0.0))
        tree, step = cm.load_full(1, self._tree(0.0), from_replica=True)
        assert step == 4 and float(tree["mut"][0, 0]) == 4.0


def test_snapshot_helpers_match_reference():
    js = JSnapshot(n_keys=100, num_shards=4)
    s = convert.snapshot(js)
    assert convert.snapshot_fields(s.resnapshot(8)) == dataclasses.asdict(
        js.resnapshot(8))
    local = np.array([0, 3, 24], np.int32)
    np.testing.assert_array_equal(
        np.asarray(js.global_keys(2, jnp.asarray(local))),
        s.global_keys(2, torch.from_numpy(local)).numpy())
    with pytest.raises(ValueError, match="block"):
        PartitionSnapshot(8, 2, scheme="hash").global_keys(0, 1)
