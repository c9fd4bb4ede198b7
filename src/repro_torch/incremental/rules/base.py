"""Rule protocol, registry, and seed-delta helpers.

A mutation batch becomes a set of **seed deltas** over the converged
state — host-built :class:`~repro_torch.core.delta.DeltaBuffer`s carrying
the paper's annotations: ``−()`` invalidates derived values the batch may
have broken, ``→(t')`` replaces a value with a known-better bound, and
``δ(E)`` adjusts accumulated aggregates.  Applying the seeds edits the warm
state so that exactly the repaired keys fail the algorithm's convergence
test; the engine's ``resume`` then propagates the repair, doing
O(|repair|) work instead of a cold O(|base data| × strata) rerun.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch.core.delta import DeltaBuffer

_REGISTRY: dict[str, Callable[[], "IncrementalRule"]] = {}


def register(name: str):
    """Class decorator: make a rule constructible by algorithm name."""

    def deco(cls):
        cls.algorithm = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_rule(name: str) -> "IncrementalRule":
    if name not in _REGISTRY:
        raise KeyError(
            f"no incremental rule registered for {name!r}; known: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def registered() -> list[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class RepairPlan:
    """Outcome of translating one batch into seed deltas.

    ``state`` is the repaired warm state (tensors on the view's device);
    ``touched_keys`` drives the ViewManager's repair-vs-recompute policy;
    ``seeds`` records the DeltaBuffers that were folded in, for
    introspection and tests.
    """

    state: object
    touched_keys: int
    seeds: dict[str, DeltaBuffer] = dataclasses.field(default_factory=dict)


def make_seed(keys: np.ndarray, payload: np.ndarray, ann: int, device
              ) -> DeltaBuffer:
    """Host-built seed Δ buffer on ``device``, sized exactly to the batch
    (host code has no capacity to keep — only the fixpoint does).  Keys
    int32, ann int8, payload float32."""
    keys = np.asarray(keys, np.int32)
    payload = np.asarray(payload, np.float32)
    if payload.ndim == 1:
        payload = payload[:, None]
    n = len(keys)
    return DeltaBuffer(
        keys=torch.from_numpy(keys).to(device),
        payload=torch.from_numpy(payload).to(device),
        ann=torch.full((n,), ann, dtype=torch.int8, device=device),
        count=torch.tensor(n, dtype=torch.int32, device=device),
        overflowed=torch.tensor(False, device=device))


class IncrementalRule:
    """Abstract per-algorithm repair rule.

    Lifecycle: ``bind(view)`` once at view creation (build the
    DeltaAlgorithm, executors, and cold/resume callables against the
    store's pinned shapes); ``cold(view)`` for a from-scratch fixpoint;
    ``repair(view, effect, state)`` to translate one sealed batch;
    ``resume(view, state)`` to re-converge; ``extract(view, state)`` to
    produce the queryable result.  ``rebind`` is called when pinned
    capacities grew.
    """

    algorithm: str = "?"

    def bind(self, view) -> None:
        raise NotImplementedError

    def rebind(self, view) -> None:
        self.bind(view)

    def cold(self, view):
        """-> (state, FixpointResult)"""
        raise NotImplementedError

    def repair(self, view, effect, state) -> RepairPlan:
        raise NotImplementedError

    def resume(self, view, state):
        """-> (state, FixpointResult)"""
        raise NotImplementedError

    def extract(self, view, state) -> np.ndarray:
        raise NotImplementedError

    def state_template(self, view):
        """A state with the view's shapes, on its device — journal
        recovery fills its fields from the saved leaves."""
        raise NotImplementedError


class GraphRuleBase(IncrementalRule):
    """Shared machinery for rules over the sharded graph engine: builds the
    partition snapshot, executors and the algorithms of the cold and warm
    runs; exposes flat <-> sharded state helpers for the host-side seed
    translation.

    ``use_kernels`` (param, default True) sends the executors' rehash and
    the algorithms' applies and dense bodies through the CUDA kernels, as
    the reference's ``use_pallas_route`` sends its rehash through its
    Pallas kernels."""

    def bind(self, view) -> None:
        from repro_torch.core.engine import ShardedExecutor
        from repro_torch.core.partition import PartitionSnapshot

        p = view.params
        n, S = view.store.n, view.store.num_shards
        self.snapshot = PartitionSnapshot(n_keys=n, num_shards=S)
        self.edge_capacity = int(p.get("edge_capacity", max(4 * n, 4096)))
        self.src_capacity = int(p.get("src_capacity",
                                      self.snapshot.block_size))
        # Warm resumes run with a much tighter Δ budget: repairs are small
        # by construction, sparse-stratum cost is O(capacity), and a
        # flooding repair just falls back to the dense body — correctness
        # never depends on the budget.
        self.resume_edge_capacity = int(p.get(
            "resume_edge_capacity", max(self.edge_capacity // 8, 1024)))
        self.resume_src_capacity = int(p.get(
            "resume_src_capacity", max(self.src_capacity // 8, 64)))
        self.max_iters = int(p.get("max_iters", 80))
        self.mode = p.get("mode", "delta")
        # Density ladder (core/engine.py): per-stratum dispatch to the
        # smallest capacity rung that fits the predicted emission.  On the
        # resume executor this doubles as warm-start tier selection — a
        # small repair's strata run at tiny capacities for free.
        self.ladder_tiers = int(p.get("ladder_tiers", 4))
        # Rehash strategy (sort | scatter | auto): warm repairs are the
        # tail-stratum regime the scatter path targets, so default to the
        # per-rung cost model instead of pinning the sort.
        self.route_strategy = p.get("route_strategy", "auto")
        # Fault-tolerant warm resumes: with a "resilient_root" param the
        # repair fixpoint runs through ShardedExecutor.resume_resilient — a
        # per-stratum replica chain under that directory absorbs executor
        # shard failures mid-repair (inject one by setting
        # ``view.fault_plan``), so standing queries survive engine
        # failures without losing the in-flight repair.
        self.resilient_root = p.get("resilient_root")
        self.use_kernels = bool(p.get("use_kernels", True))
        # backend / mesh / axis_name flow through to both executors.  On
        # shard_map, mesh None = the flat mesh over the default process
        # group on the view's device (a ValueError if no group is
        # initialised); on the simulated backend they mean nothing, and
        # the executors read no axis_name on either.
        backend = p.get("backend", "simulated")
        if backend not in ("simulated", "shard_map"):
            raise ValueError(backend)
        axis_name = p.get("axis_name") or "shards"
        mesh = p.get("mesh")
        if backend == "shard_map" and mesh is None:
            from repro_torch.launch.mesh import flat_mesh
            mesh = flat_mesh(S, device=view.device)
        kw = dict(backend=backend, axis_name=axis_name,
                  mesh=mesh if backend == "shard_map" else None,
                  route_strategy=self.route_strategy,
                  use_kernels=self.use_kernels)
        self.executor = ShardedExecutor(
            snapshot=self.snapshot, seg_capacity=self.edge_capacity,
            edge_capacity=self.edge_capacity, src_capacity=self.src_capacity,
            ladder_tiers=self.ladder_tiers, **kw)
        self.resume_executor = ShardedExecutor(
            snapshot=self.snapshot, seg_capacity=self.resume_edge_capacity,
            edge_capacity=self.resume_edge_capacity,
            src_capacity=self.resume_src_capacity,
            ladder_tiers=self.ladder_tiers, **kw)
        self.algo = self.make_algo(view, self.src_capacity,
                                   self.edge_capacity)
        self.resume_algo = self.make_algo(view, self.resume_src_capacity,
                                          self.resume_edge_capacity)

    def make_algo(self, view, src_capacity: int, edge_capacity: int):
        raise NotImplementedError

    def cold_impl(self, view):
        """-> FixpointResult of a from-scratch run on ``view.immutable``."""
        raise NotImplementedError

    def cold(self, view):
        res = self.cold_impl(view)
        return res.state, res

    def resume(self, view, state):
        fault_plan = getattr(view, "fault_plan", None)
        retry = getattr(view, "retry_policy", None)
        budget = getattr(view, "retry_budget", None)
        if self.resilient_root is None and fault_plan is None \
                and retry is None and budget is None:
            res = self.resume_executor.resume(
                self.resume_algo, state, view.immutable, self.max_iters,
                mode=self.mode)
            return res.state, res
        # No configured root: a throwaway unique dir per repair — the
        # chain only needs to outlive this one resume (a fixed path
        # could collide across processes, and ReplicaChain wipes its
        # root on construction), so it is removed afterwards.
        root = self.resilient_root or tempfile.mkdtemp(
            prefix="rex_view_chain_")
        try:
            rr = self.resume_executor.resume_resilient(
                self.resume_algo, state, view.immutable, self.max_iters,
                mode=self.mode, ckpt_root=root, fault_plan=fault_plan,
                retry=retry, budget=budget)
        finally:
            if self.resilient_root is None:
                shutil.rmtree(root, ignore_errors=True)
            # Consumed even when the resume fails — a degraded view's
            # catch-up refresh must not re-inject the same faults.
            view.fault_plan = None
        view.last_recovery = rr.metrics
        return rr.result.state, rr.result

    # ---- flat <-> sharded helpers ---------------------------------------
    def flat64(self, field: torch.Tensor) -> np.ndarray:
        """[S, block] tensor -> f64[padded_keys] host array."""
        return field.detach().cpu().numpy().astype(np.float64).reshape(-1)

    def shard_f32(self, flat: np.ndarray, device) -> torch.Tensor:
        S, B = self.snapshot.num_shards, self.snapshot.block_size
        return torch.from_numpy(
            flat.astype(np.float32).reshape(S, B)).to(device)
