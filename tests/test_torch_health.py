"""Heartbeat/lease failure detection of the port (``runtime/health.py``,
``launch/channel.py``), the twins of ``tests/test_health.py``'s
TestHealthConfig, TestChannel and TestHealthMonitor.

Every monitor test drives a FAKE clock through both the writer and the
monitor: no sleeps, no subprocesses (the real multi-process path is in
``tests/test_torch_launch.py``).  One scenario also runs through
``repro``'s monitor on the same channel files, and the two reports must
agree barrier for barrier; one subprocess checks that the worker module
imports the standard library and the channel only.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.channel import read_json, write_json
from repro_torch.runtime.health import (HealthConfig, HealthMonitor,
                                        heartbeat_path, lease_path,
                                        write_heartbeat)

ROOT = Path(__file__).resolve().parents[1]
CFG = HealthConfig(lease_ttl=1.5, straggle_after=0.4,
                   heartbeat_interval=0.1)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _monitor(root, ownership, clock, **kw):
    return HealthMonitor(root, ownership, CFG, clock=clock, **kw)


def _beat(root, wid, seq, clock):
    write_heartbeat(root, wid, seq, clock=clock)


class TestHealthConfig:
    def test_ordering_validated(self):
        with pytest.raises(ValueError, match="heartbeat_interval"):
            HealthConfig(lease_ttl=0.1, straggle_after=0.4,
                         heartbeat_interval=0.2)
        with pytest.raises(ValueError):
            HealthConfig(heartbeat_interval=0.0)

    def test_defaults_give_many_beats_before_death(self):
        c = HealthConfig()
        assert c.lease_ttl / c.heartbeat_interval >= 10


class TestChannel:
    def test_atomic_roundtrip(self, tmp_path):
        p = str(tmp_path / "sub" / "x.json")
        write_json(p, {"a": 1})
        assert read_json(p) == {"a": 1}
        assert read_json(str(tmp_path / "missing.json")) is None
        # No temporary file is left beside the written one.
        assert os.listdir(tmp_path / "sub") == ["x.json"]

    def test_heartbeat_carries_lease_echo(self, tmp_path):
        clk = FakeClock()
        write_heartbeat(str(tmp_path), 3, 7, shards=(1, 5), clock=clk)
        hb = read_json(heartbeat_path(str(tmp_path), 3))
        assert hb["worker_id"] == 3 and hb["seq"] == 7
        assert hb["shards"] == [1, 5] and hb["t"] == clk.t
        assert hb["pid"] == os.getpid()


class TestHealthMonitor:
    def test_leases_granted_at_construction(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        _monitor(root, {0: [0, 2], 1: [1, 3]}, clk)
        lease = read_json(lease_path(root, 1))
        assert lease["shards"] == [1, 3]
        assert lease["ttl_s"] == CFG.lease_ttl

    def test_ok_late_dead_transitions(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0], 1: [1]}, clk)
        for w in (0, 1):
            _beat(root, w, 0, clk)
        rep = mon.observe(0)
        assert [s.state for s in rep.statuses] == ["ok", "ok"]
        assert rep.alive == 2 and not rep.dead_workers

        # Worker 1 goes quiet past the straggle threshold: late, with a
        # straggle signal per leased shard, never a fail event.
        clk.t += CFG.straggle_after + 0.1
        _beat(root, 0, 1, clk)
        rep = mon.observe(3)
        assert [s.state for s in rep.statuses] == ["ok", "late"]
        assert rep.straggles == [(1, pytest.approx(clk.t - 100.0))]
        assert not rep.fail_events

        # Past the lease TTL: dead, one fail event per leased shard,
        # stamped with the observing stratum.
        clk.t = 100.0 + CFG.lease_ttl + 0.01
        _beat(root, 0, 2, clk)
        rep = mon.observe(5)
        assert rep.dead_workers == [1]
        assert [(e.kind, e.at, e.shard) for e in rep.fail_events] \
            == [("fail", 5, 1)]

    def test_never_heartbeat_is_dead_with_infinite_age(self, tmp_path):
        clk = FakeClock()
        mon = _monitor(str(tmp_path), {0: [0]}, clk)
        rep = mon.observe(0)
        assert rep.dead_workers == [0]
        assert rep.statuses[0].age == float("inf")

    def test_dead_reported_once_until_reinstated(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0, 1]}, clk)
        rep = mon.observe(2)
        assert len(rep.fail_events) == 2
        # Second barrier: still dead, but not re-reported.
        assert mon.observe(3).dead_workers == []
        assert mon.observe(3).fail_events == []
        # Replacement takes the lease: reportable anew.
        mon.reinstate(0)
        _beat(root, 0, 0, clk)
        assert mon.observe(4).statuses[0].state == "ok"
        clk.t += CFG.lease_ttl + 1
        rep = mon.observe(9)
        assert rep.dead_workers == [0] and len(rep.fail_events) == 2

    def test_proc_alive_fast_path_beats_the_ttl(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0], 1: [1]}, clk,
                       proc_alive=lambda w: w != 0)
        for w in (0, 1):
            _beat(root, w, 0, clk)
        # Heartbeat fresh, but the process is observably gone: dead NOW.
        rep = mon.observe(1)
        assert rep.dead_workers == [0]
        assert rep.statuses[1].state == "ok"

    def test_proc_alive_none_falls_back_to_lease(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0]}, clk, proc_alive=lambda w: None)
        _beat(root, 0, 0, clk)
        assert mon.observe(0).dead_workers == []
        clk.t += CFG.lease_ttl + 0.1
        assert mon.observe(1).dead_workers == [0]

    def test_observability_mirrors(self, tmp_path):
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import Tracer
        root = str(tmp_path)
        clk = FakeClock()
        tracer, reg = Tracer(), MetricsRegistry()
        mon = _monitor(root, {0: [0], 1: [1]}, clk, tracer=tracer,
                       metrics=reg)
        _beat(root, 0, 0, clk)
        _beat(root, 1, 0, clk)
        clk.t += CFG.straggle_after + 0.05
        _beat(root, 0, 1, clk)
        mon.observe(1)                      # worker 1 late
        clk.t += CFG.lease_ttl
        _beat(root, 0, 2, clk)
        mon.observe(2)                      # worker 1 dead
        names = [e["name"] for e in tracer.events]
        assert "heartbeat_late" in names and "lease_expired" in names
        late = next(e for e in tracer.events
                    if e["name"] == "heartbeat_late")
        assert late["tid"] == "worker1"     # per-worker timeline row
        assert reg.counter("health.straggle_signals").value == 1
        assert reg.counter("health.lease_expiries").value == 1
        assert reg.gauge("health.workers_alive").value == 1

    def test_set_ownership_regrants_leases(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0], 1: [1]}, clk)
        mon.set_ownership({0: [0, 1], 1: []})
        assert read_json(lease_path(root, 0))["shards"] == [0, 1]
        _beat(root, 0, 0, clk)
        _beat(root, 1, 0, clk)
        rep = mon.observe(0)
        assert rep.statuses[0].shards == (0, 1)
        assert rep.statuses[1].shards == ()

    def test_wait_ready_names_silent_workers(self, tmp_path):
        root = str(tmp_path)
        clk = FakeClock()
        mon = _monitor(root, {0: [0], 1: [1]}, clk)
        _beat(root, 0, 0, clk)

        def tick(_):
            clk.t += 1.0
        with pytest.raises(TimeoutError, match=r"\[1\]"):
            mon.wait_ready(timeout=3.0, sleep=tick)
        _beat(root, 1, 0, clk)
        mon.wait_ready(timeout=1.0, sleep=tick)


def _scenario(package, root):
    """One lease table over three workers through ``package``'s monitor,
    heartbeats from ``package``'s writer: ok, late, dead, reinstated,
    regranted.  -> each barrier's report as plain values."""
    import importlib
    health = importlib.import_module(f"{package}.runtime.health")
    cfg = health.HealthConfig(lease_ttl=1.5, straggle_after=0.4,
                              heartbeat_interval=0.1)
    clk = FakeClock()
    mon = health.HealthMonitor(root, {0: [0, 3], 1: [1], 2: [2]}, cfg,
                               clock=clk, proc_alive=lambda w: w != 2
                               or clk.t < 101.0)
    seen = []

    def beat(*workers):
        for w in workers:
            health.write_heartbeat(root, w, int(clk.t * 10), clock=clk)

    def observe(stratum):
        rep = mon.observe(stratum)
        seen.append({
            "states": [(s.worker_id, s.shards, s.state, round(s.age, 6))
                       for s in rep.statuses],
            "fail": [(e.kind, e.at, e.shard) for e in rep.fail_events],
            "dead": rep.dead_workers,
            "straggles": [(s, round(a, 6)) for s, a in rep.straggles],
            "alive": rep.alive})

    beat(0, 1, 2)
    observe(0)
    clk.t += 0.5
    beat(0, 2)
    observe(1)                     # worker 1 late
    clk.t += 0.6
    beat(0, 2)
    observe(2)                     # worker 2's process gone: dead now
    clk.t += 0.5
    beat(0)
    observe(3)                     # worker 1 past its lease
    mon.reinstate(1)
    beat(0, 1)
    observe(4)
    mon.set_ownership({0: [0], 1: [1, 2, 3], 2: []})
    clk.t += 0.2
    beat(0, 1)
    observe(5)
    seen.append({"leases": [read_json(lease_path(root, w))["shards"]
                            for w in range(3)]})
    return seen


def test_monitor_reports_equal_the_reference(tmp_path):
    """The same barriers through both packages' monitors (each reading
    its own package's heartbeats) give the same reports."""
    got = _scenario("repro_torch", str(tmp_path / "port"))
    want = _scenario("repro", str(tmp_path / "ref"))
    assert got == want
    assert [r.get("dead") for r in got[:4]] == [[], [], [2], [1]]


def test_worker_module_imports_the_stdlib_and_channel_only():
    """``python -m repro_torch.launch._worker`` must start without torch,
    numpy, JAX or ``repro``: a protocol-only worker (and a replacement
    one) pays for none of them."""
    probe = ("import json, sys\n"
             "import repro_torch.launch._worker\n"
             "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    heavy = [m for m in mods if m.split(".")[0] in (
        "torch", "numpy", "jax", "jaxlib", "repro")]
    assert heavy == []
    ours = sorted(m for m in mods if m.startswith("repro_torch"))
    assert ours == ["repro_torch", "repro_torch.launch",
                    "repro_torch.launch._worker",
                    "repro_torch.launch.channel"]
