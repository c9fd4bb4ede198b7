"""Incremental view maintenance: warm-state delta repair for standing
queries.

The engine (``repro_torch.core``) already propagates deltas *within* one
fixpoint run; this package lifts the same idea to the life of a query.  A
:class:`~repro_torch.incremental.view.MaterializedView` keeps a converged
``FixpointResult`` resident; base-data mutations (edge insert/delete/
reweight, point insert/remove) are batched by a versioned
:class:`~repro_torch.incremental.mutations.MutationLog`, translated into
seed deltas by per-algorithm repair rules
(``repro_torch.incremental.rules``), and absorbed by resuming the sharded
fixpoint from the warm state.  When the estimated repair volume exceeds a
threshold, the view falls back to a cold recompute — the paper's
delta/dense duality at the update level.

Stores stay numpy on the host; a view's state and graph live on its
``device`` (None means CUDA).
"""
from repro_torch.incremental.journal import ViewJournal
from repro_torch.incremental.mutations import (EdgeDelete, EdgeInsert,
                                               EdgeReweight, MutationBatch,
                                               MutationLog, PointInsert,
                                               PointRemove)
from repro_torch.incremental.rules import get_rule, register, registered
from repro_torch.incremental.stores import GraphStore, PointStore
from repro_torch.incremental.view import (MaterializedView, RefreshReport,
                                          ViewManager)

__all__ = [
    "EdgeDelete", "EdgeInsert", "EdgeReweight", "GraphStore",
    "MaterializedView", "MutationBatch", "MutationLog", "PointInsert",
    "PointRemove", "PointStore", "RefreshReport", "ViewJournal",
    "ViewManager", "get_rule", "register", "registered",
]
