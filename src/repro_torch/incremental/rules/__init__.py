"""Per-algorithm incremental repair rules, plugged in via a registry.

A rule knows how to (a) cold-start its algorithm on a view's base data,
(b) translate a :class:`~repro_torch.incremental.stores.GraphBatchEffect` /
``PointBatchEffect`` into seed deltas over the converged state, and
(c) resume the engine's fixpoint from the repaired state.  New workloads
register with :func:`register` — the ViewManager looks rules up by name.
"""
from __future__ import annotations

from repro_torch.incremental.rules.base import (IncrementalRule, RepairPlan,
                                                get_rule, register,
                                                registered)

# Importing the built-in rules registers them.
from repro_torch.incremental.rules import components as _components  # noqa: F401,E402
from repro_torch.incremental.rules import kmeans as _kmeans  # noqa: F401,E402
from repro_torch.incremental.rules import pagerank as _pagerank  # noqa: F401,E402
from repro_torch.incremental.rules import sssp as _sssp  # noqa: F401,E402

__all__ = ["IncrementalRule", "RepairPlan", "get_rule", "register",
           "registered"]
