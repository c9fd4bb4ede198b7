"""Incremental PageRank: rank redistribution on edge change.

The converged delta-PageRank state satisfies (exactly, modulo float):

    acc(v) = Σ over edge occurrences (u, v) of sent(u) / max(deg(u), 1)

so a batch that edits the out-edge multiset of sources U breaks the
invariant only at the destinations of U's old and new edge sets.  The
repair is a pure δ(E) adjustment: for every changed source u, retract
``sent(u)/deg_old(u)`` along its old edges and grant ``sent(u)/deg_new(u)``
along its new ones.  After folding the adjustment into ``acc``, exactly
the touched destinations fail the ``|pr − sent| ≤ τ`` convergence test and
the engine's warm resume propagates the rank shift — O(deg(U) + repair)
work instead of a cold all-vertex fixpoint.
"""
from __future__ import annotations

import numpy as np

from repro_torch.algorithms import pagerank
from repro_torch.algorithms.pagerank import PRState
from repro_torch.core.delta import ANN_ADJUST
from repro_torch.incremental.rules.base import (GraphRuleBase, RepairPlan,
                                                make_seed, register)


@register("pagerank")
class PageRankRule(GraphRuleBase):

    def make_algo(self, view, src_capacity, edge_capacity):
        self.threshold = float(view.params.get("threshold", 1e-3))
        return pagerank.make_algorithm(
            self.snapshot, self.threshold, src_capacity, edge_capacity,
            use_kernels=self.use_kernels)

    def cold_impl(self, view):
        state0 = pagerank.initial_state(self.snapshot, view.device)
        return self.executor.run(
            self.algo, state0, self.snapshot.padded_keys, view.immutable,
            self.max_iters, mode=self.mode)

    def repair(self, view, effect, state: PRState) -> RepairPlan:
        sent = self.flat64(state.sent)
        acc = self.flat64(state.acc)
        adj = np.zeros_like(acc)

        # Per-edge contribution = sent(u)/max(deg(u),1) with deg taken on
        # the side (old/new) the edge set belongs to.  changed_src is
        # sorted, so degree lookup is a searchsorted.
        def fold(edges, deg_of_changed, sign):
            eu, ev = edges
            if not len(eu):
                return
            pos = np.searchsorted(effect.changed_src, eu)
            deg = np.maximum(deg_of_changed[pos], 1).astype(np.float64)
            np.add.at(adj, ev, sign * sent[eu] / deg)

        fold(effect.old_edges, effect.old_deg, -1.0)
        fold(effect.new_edges, effect.new_deg, +1.0)

        touched = np.flatnonzero(adj)
        seed = make_seed(touched, adj[touched], ANN_ADJUST, view.device)
        new_acc = self.shard_f32(acc + adj, view.device)
        return RepairPlan(state=PRState(acc=new_acc, sent=state.sent),
                          touched_keys=len(touched),
                          seeds={"acc_adjust": seed})

    def extract(self, view, state: PRState) -> np.ndarray:
        pr = pagerank.BASE + pagerank.DAMPING * self.flat64(state.acc)
        return pr[:self.snapshot.n_keys].astype(np.float32)

    def state_template(self, view):
        return pagerank.initial_state(self.snapshot, view.device)
