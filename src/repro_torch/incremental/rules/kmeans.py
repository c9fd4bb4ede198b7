"""Incremental k-means: centroid nudge on point insert/remove.

The converged KMState keeps exactly the paper's KMAgg aggregates —
per-centroid (Σx, Σy, n).  A point mutation is therefore a literal KMAgg
delta: removing point p assigned to centroid c retracts ``(c, −x, −y, −1)``;
inserting p grants ``(c*, +x, +y, +1)`` to its nearest current centroid.
Folding the nudge keeps the sums/counts invariant exact, and the warm
resume's first stratum re-checks every valid point against the nudged
centroids, so assignments re-settle in the (usually tiny) neighbourhood of
the change.  Unlike the graph rules there is no unique fixpoint — Lloyd
converges to a local optimum — so the warm view tracks the *standing
query* semantics: the clustering evolves continuously instead of being
re-seeded per batch.

With ``use_kernels`` (param, default True) every stratum's assignment
goes through ``kernels/kmeans_assign``.  The repair reads the assignment
of the removed slots and writes that of the inserted ones on the device:
the whole assignment never crosses to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms import kmeans
from repro_torch.algorithms.kmeans import KMState
from repro_torch.core.delta import ANN_ADJUST
from repro_torch.incremental.rules.base import (IncrementalRule, RepairPlan,
                                                make_seed, register)


@register("kmeans")
class KMeansRule(IncrementalRule):

    def bind(self, view) -> None:
        self.k = int(view.params.get("k", 8))
        self.mode = view.params.get("mode", "delta")
        self.max_iters = int(view.params.get("max_iters", 60))
        self.seed = int(view.params.get("seed", 0))
        self.use_kernels = bool(view.params.get("use_kernels", True))

    def _init_centroids(self, view) -> np.ndarray:
        """KMSampleAgg: sample k valid points (deterministic per view)."""
        arrays = view.store.to_arrays()
        pts = np.asarray(arrays["points"], np.float32)
        valid = np.flatnonzero(np.asarray(arrays["valid"]))
        rng = np.random.default_rng(self.seed)
        pick = rng.choice(valid, size=self.k, replace=len(valid) < self.k)
        return pts[pick]

    def cold(self, view):
        pts, valid = view.immutable
        init = torch.from_numpy(self._init_centroids(view))
        _, res = kmeans.run(pts, init, self.mode, self.max_iters, valid,
                            device=view.device, use_kernels=self.use_kernels)
        return res.state, res

    def resume(self, view, state: KMState):
        pts, valid = view.immutable
        _, res = kmeans.resume(pts, state, self.max_iters, self.mode, valid,
                               device=view.device,
                               use_kernels=self.use_kernels)
        return res.state, res

    def repair(self, view, effect, state: KMState) -> RepairPlan:
        sums = state.sums.cpu().numpy().astype(np.float64)
        counts = state.counts.cpu().numpy().astype(np.float64)
        adj = np.zeros((self.k, 3), np.float64)
        flat = state.assign.reshape(-1)
        removed_of = flat[torch.from_numpy(effect.removed_slots).to(
            flat.device)].cpu().numpy()

        for c, p in zip(removed_of, effect.removed_points):
            adj[int(c)] -= (p[0], p[1], 1.0)
        cents = sums / np.maximum(counts, 1.0)[:, None]
        inserted_to = np.zeros(len(effect.inserted_slots), np.int32)
        for i, p in enumerate(effect.inserted_points):
            c = int(np.argmin(((cents - p) ** 2).sum(axis=1)))
            inserted_to[i] = c
            adj[c] += (p[0], p[1], 1.0)

        sums += adj[:, :2]
        counts += adj[:, 2]
        nudged = np.flatnonzero(np.abs(adj).sum(axis=1))
        seed = make_seed(nudged, adj[nudged], ANN_ADJUST, view.device)
        assign = state.assign.clone()
        assign.view(-1)[torch.from_numpy(effect.inserted_slots).to(
            assign.device)] = torch.from_numpy(inserted_to).to(assign.device)
        dev = view.device
        new_state = KMState(
            assign=assign,
            sums=torch.from_numpy(sums.astype(np.float32)).to(dev),
            counts=torch.from_numpy(counts.astype(np.float32)).to(dev))
        return RepairPlan(state=new_state, touched_keys=effect.size,
                          seeds={"centroid_nudge": seed})

    def extract(self, view, state: KMState) -> np.ndarray:
        return kmeans.centroids_of(state).cpu().numpy().astype(np.float32)

    def state_template(self, view):
        S, B = view.store.num_shards, view.store.block
        dev = view.device
        return KMState(
            assign=torch.zeros((S, B), dtype=torch.int32, device=dev),
            sums=torch.zeros((self.k, 2), dtype=torch.float32, device=dev),
            counts=torch.zeros((self.k,), dtype=torch.float32, device=dev))
