"""Incremental connected components: merge fast-path, split re-derivation.

Min-label propagation converges to ``label(v) = min id over {v} ∪
ancestors(v)``.  An edge insert (u, v) can only *merge*: the seed is a
→(t') replacement ``label(v) ← min(label(v), label(u))`` and the warm
resume floods the smaller label forward — exactly the paper's monotone
Δ-set restart.

An edge delete can *split* a component (or orphan a label that flowed
through the deleted edge).  Reusing the SSSP closure machinery with the
tightness test ``label(child) == label(parent)`` (label could have flowed
through) and excluding self-labelled vertices (their own id needs no
derivation), the rule resets the affected closure to self-labels (−() on
the derived tuples) and re-emits the rim's still-valid labels; the resumed
fixpoint re-floods minimum labels only through the damaged region.
"""
from __future__ import annotations

import numpy as np

from repro_torch.algorithms import connected_components as cc
from repro_torch.algorithms.connected_components import CCState
from repro_torch.core.delta import ANN_ADJUST, ANN_DELETE, ANN_REPLACE
from repro_torch.incremental.rules.base import (GraphRuleBase, RepairPlan,
                                                make_seed, register)
from repro_torch.incremental.rules.sssp import (affected_closure,
                                                boundary_sources)


@register("connected_components")
class ConnectedComponentsRule(GraphRuleBase):

    def make_algo(self, view, src_capacity, edge_capacity):
        return cc.make_algorithm(self.snapshot, src_capacity,
                                 edge_capacity,
                                 use_kernels=self.use_kernels)

    def cold_impl(self, view):
        state0 = cc.initial_state(self.snapshot, view.device)
        return self.executor.run(self.algo, state0,
                                 self.snapshot.padded_keys, view.immutable,
                                 self.max_iters, mode=self.mode)

    def repair(self, view, effect, state: CCState) -> RepairPlan:
        label = self.flat64(state.label)
        sent = self.flat64(state.sent)
        src, dst = view.store.edges()
        seeds = {}
        touched = 0

        # --- deletions: split handling via forward label closure ---------
        du, dv = effect.deleted
        if len(du):
            # v's label is suspect iff it equals u's (may have flowed
            # through the deleted edge) and is not v's own id.
            A = affected_closure(
                label, du, dv, view.store,
                lambda p, c, i: (c == p) & (c != i.astype(np.float64)))
            aff = np.flatnonzero(A)
            if len(aff):
                rim = boundary_sources(A, label, src, dst)
                label[aff] = aff.astype(np.float64)   # reset to self-label
                sent[aff] = np.inf                    # re-flood own id
                sent[rim] = np.inf                    # re-emit valid labels
                seeds["invalidate"] = make_seed(
                    aff, aff.astype(np.float64), ANN_DELETE, view.device)
                seeds["repush"] = make_seed(rim, label[rim], ANN_ADJUST,
                                            view.device)
                touched += len(aff) + len(rim)

        # --- insertions: monotone merge ----------------------------------
        iu, iv = effect.inserted
        if len(iu):
            cand = label[iu]
            improves = cand < label[iv]
            tgt, val = iv[improves], cand[improves]
            if len(tgt):
                np.minimum.at(label, tgt, val)
                seeds["merge"] = make_seed(tgt, val, ANN_REPLACE,
                                           view.device)
                touched += len(np.unique(tgt))

        new_state = CCState(label=self.shard_f32(label, view.device),
                            sent=self.shard_f32(sent, view.device))
        return RepairPlan(state=new_state, touched_keys=touched,
                          seeds=seeds)

    def extract(self, view, state: CCState) -> np.ndarray:
        return self.flat64(state.label)[:self.snapshot.n_keys].astype(
            np.float32)

    def state_template(self, view):
        return cc.initial_state(self.snapshot, view.device)
