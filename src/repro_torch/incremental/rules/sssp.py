"""Incremental SSSP: monotone decrease-repair + bounded re-derive fallback.

Insertions are the easy, monotone direction: an inserted edge (u, v) can
only improve v, so the seed is a →(t') replacement ``dist(v) ←
min(dist(v), dist(u)+1)``; any vertex that improved fails the
``dist < sent`` test and the warm resume pushes the improvement onward —
the classic frontier restart.

Deletions are non-monotone: a distance may have been *derived through* a
deleted edge.  The rule computes a conservative affected closure A —
heads of deleted tight edges, expanded forward along still-tight edges —
then (a) invalidates A (``−()``: dist ← ∞) and (b) marks the frontier of
still-valid in-neighbors of A for re-propagation (δ(E): sent ← ∞, so the
engine re-emits their settled distances).  This is the *bounded
re-derivation*: only A and its one-hop boundary re-enter the fixpoint.
When A grows past the ViewManager's threshold, the view falls back to a
cold recompute instead (the delta/dense duality lifted to the
update-to-update level).
"""
from __future__ import annotations

import numpy as np

from repro_torch.algorithms import sssp
from repro_torch.algorithms.sssp import SPState
from repro_torch.core.delta import ANN_ADJUST, ANN_DELETE, ANN_REPLACE
from repro_torch.incremental.rules.base import (GraphRuleBase, RepairPlan,
                                                make_seed, register)


def affected_closure(val: np.ndarray, del_u: np.ndarray, del_v: np.ndarray,
                     store, tight) -> np.ndarray:
    """Conservative forward closure of possibly-invalidated derivations.

    ``tight(parent_val, child_val, child_id)`` says whether the child's
    value could have been derived through the parent (e.g. ``c == p + 1``
    for SSSP).  Returns a bool mask over keys.  Correctness: any vertex
    NOT in the closure keeps at least one fully-valid derivation chain,
    by induction over chain length, so its value is untouched.

    Expansion walks only the frontier's out-edges through the store's
    sorted edge index, so host work is O(edges of the affected region),
    not O(closure depth × |E|).
    """
    n = len(val)
    A = np.zeros(n, bool)
    seed_ok = tight(val[del_u], val[del_v], del_v)
    frontier = np.unique(del_v[seed_ok])
    A[frontier] = True
    while len(frontier):
        eu, ev = store.edges_of(frontier)
        m = ~A[ev] & tight(val[eu], val[ev], ev)
        frontier = np.unique(ev[m])
        if not len(frontier):
            break
        A[frontier] = True
    return A


def boundary_sources(A: np.ndarray, val: np.ndarray, src: np.ndarray,
                     dst: np.ndarray) -> np.ndarray:
    """Still-valid in-neighbors of the affected set (the re-derive rim)."""
    m = ~A[src] & A[dst] & np.isfinite(val[src])
    return np.unique(src[m])


@register("sssp")
class SSSPRule(GraphRuleBase):

    def make_algo(self, view, src_capacity, edge_capacity):
        self.source = int(view.params.get("source", 0))
        return sssp.make_algorithm(self.snapshot, src_capacity,
                                   edge_capacity,
                                   use_kernels=self.use_kernels)

    def cold_impl(self, view):
        state0 = sssp.initial_state(self.snapshot, self.source, view.device)
        return self.executor.run(self.algo, state0, 1, view.immutable,
                                 self.max_iters, mode=self.mode)

    def repair(self, view, effect, state: SPState) -> RepairPlan:
        dist = self.flat64(state.dist)
        sent = self.flat64(state.sent)
        src, dst = view.store.edges()
        seeds = {}
        touched = 0

        # --- deletions: invalidate the affected closure, mark its rim ----
        du, dv = effect.deleted
        if len(du):
            A = affected_closure(
                dist, du, dv, view.store,
                lambda p, c, _i: np.isfinite(c) & (c == p + 1.0))
            A[self.source] = False          # dist(source)=0 is axiomatic
            aff = np.flatnonzero(A)
            if len(aff):
                rim = boundary_sources(A, dist, src, dst)
                dist[aff] = np.inf
                sent[aff] = np.inf
                sent[rim] = np.inf          # re-emit settled distances
                seeds["invalidate"] = make_seed(
                    aff, np.full(len(aff), np.inf), ANN_DELETE, view.device)
                seeds["repush"] = make_seed(
                    rim, dist[rim], ANN_ADJUST, view.device)
                touched += len(aff) + len(rim)

        # --- insertions: monotone one-step relaxation --------------------
        iu, iv = effect.inserted
        if len(iu):
            cand = dist[iu] + 1.0
            improves = cand < dist[iv]
            tgt, val = iv[improves], cand[improves]
            if len(tgt):
                np.minimum.at(dist, tgt, val)
                seeds["relax"] = make_seed(tgt, val, ANN_REPLACE,
                                           view.device)
                touched += len(np.unique(tgt))

        new_state = SPState(dist=self.shard_f32(dist, view.device),
                            sent=self.shard_f32(sent, view.device))
        return RepairPlan(state=new_state, touched_keys=touched,
                          seeds=seeds)

    def extract(self, view, state: SPState) -> np.ndarray:
        return self.flat64(state.dist)[:self.snapshot.n_keys].astype(
            np.float32)

    def state_template(self, view):
        return sssp.initial_state(self.snapshot, self.source, view.device)
