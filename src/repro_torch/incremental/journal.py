"""Durable view journal, reusing the runtime's delta checkpoints.

Paper §4.3's hybrid checkpointing — periodic full snapshots plus cheap
per-stratum delta checkpoints — maps one-to-one onto standing queries:
the view's converged state (+ its base-data store) is the *full*
checkpoint, and every sealed mutation batch is a *delta* checkpoint
(keys = mutation sequence ids, payload = encoded mutations).  Recovery
is therefore the same replay loop the runtime already uses: restore the
latest full snapshot, then re-apply every journaled batch after it —
each replayed batch going through the normal repair/resume path, so the
recovered view is bit-identical to the lost one.

Layout:  <root>/views.json                      — manifest
         <root>/<view>/node0/full_*.npz         — base snapshots
         <root>/<view>/node0/delta_*.npz        — mutation batches

The layout, file names and array names are the reference package's
(``repro.incremental.journal``): a state's leaves are written in its
NamedTuple field order, the order ``jax.tree.leaves`` gives, so each
package restores the other's journals.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.incremental.mutations import (MutationBatch, decode_batch,
                                               encode_batch)
from repro_torch.incremental.stores import GraphStore, PointStore
from repro_torch.runtime.checkpoint import (CheckpointManager,
                                            atomic_write_json)

_STORE_KINDS = {GraphStore: "graph", PointStore: "points"}
_STORE_CLASSES = {"graph": GraphStore, "points": PointStore}

# Structure templates for CheckpointManager.load_full's ``like`` argument
# (values are dummies — only the pytree structure matters).
_STORE_LIKES = {
    "graph": {k: np.zeros(()) for k in
              ("src", "dst", "n", "num_shards", "nnz_capacity")},
    "points": {k: np.zeros(()) for k in
               ("points", "valid", "num_shards", "capacity")},
}


def _state_leaves_dict(state) -> dict:
    """A state NamedTuple's fields as ``s0``, ``s1``, ... in field
    order."""
    return {f"s{i}": leaf for i, leaf in enumerate(state)}


class ViewJournal:
    """Per-view CheckpointManagers plus a JSON manifest of view configs."""

    def __init__(self, root: str, retrier=None):
        self.root = root
        # Optional runtime.retry.Retrier shared by every view's
        # CheckpointManager: transient read errors back off and retry
        # deterministically; corrupt files quarantine + fall back.
        self.retrier = retrier
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "views.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)
        else:
            self.manifest = {}

    def _cm(self, name: str) -> CheckpointManager:
        return CheckpointManager(os.path.join(self.root, name),
                                 num_nodes=1, replication=1, keep=2,
                                 retrier=self.retrier)

    def _write_manifest(self) -> None:
        # Atomic + fsynced: the manifest names every recoverable view —
        # a torn manifest would orphan all of their checkpoints.
        atomic_write_json(self._manifest_path, self.manifest)

    def view_names(self) -> list[str]:
        return sorted(self.manifest)

    def forget(self, name: str) -> None:
        """Remove a view from the manifest and delete its checkpoints."""
        import shutil
        self.manifest.pop(name, None)
        self._write_manifest()
        d = os.path.join(self.root, name)
        if os.path.isdir(d):
            shutil.rmtree(d)

    # ---- write side ------------------------------------------------------
    def register_view(self, view) -> None:
        kind = _STORE_KINDS[type(view.store)]
        self.manifest[view.name] = {
            "algorithm": view.algorithm,
            "store_kind": kind,
            "params": view.params,          # must stay JSON-serializable
            "fallback_threshold": view.fallback_threshold,
            "state_leaves": len(view.state),
        }
        self._write_manifest()

    def save_base(self, view) -> None:
        """Full checkpoint of (store, state) at the view's version; older
        bases and the deltas they cover are garbage-collected."""
        tree = {"store": view.store.to_arrays(),
                "state": _state_leaves_dict(view.state)}
        self._cm(view.name).save_full(node=0, step=view.version, tree=tree)

    def log_batch(self, view, batch: MutationBatch,
                  mode: Optional[str] = None) -> int:
        """Delta checkpoint of one sealed batch; returns bytes written.

        The refresh path taken ("repair"/"cold") is journaled too, so
        recovery replays the SAME path — without it a forced refresh
        would replay under the default policy and the restored view
        could settle in a different (equally converged) state.

        ``mode`` is passed explicitly when the batch is journaled BEFORE
        its fixpoint runs (the decided path; mid-repair crash durability);
        without it the last completed refresh's mode is used (legacy
        post-hoc logging).
        """
        keys, payload = encode_batch(batch)
        if mode is None:
            mode = view.history[-1].mode if view.history else "repair"
        return self._cm(view.name).save_delta(
            node=0, step=batch.version, keys=keys, payload=payload,
            meta={"view": view.name, "mutations": len(batch),
                  "mode": mode})

    # ---- recovery side ---------------------------------------------------
    def load_view(self, name: str, device=None):
        """-> (restored MaterializedView on ``device``, batches to
        replay)."""
        from repro_torch.incremental.view import MaterializedView

        info = self.manifest[name]
        like = {"store": _STORE_LIKES[info["store_kind"]],
                "state": {f"s{i}": np.zeros(())
                          for i in range(info["state_leaves"])}}
        tree, base_version = self._cm(name).load_full(node=0, like=like)

        store = _STORE_CLASSES[info["store_kind"]].from_arrays(
            {k: np.asarray(v) for k, v in tree["store"].items()})
        view = MaterializedView(
            name, info["algorithm"], store, params=info["params"],
            fallback_threshold=info["fallback_threshold"],
            _restored=(None, base_version), device=device)
        template = view.rule.state_template(view)
        view.state = type(template)(*(
            torch.from_numpy(np.array(tree["state"][f"s{i}"])).to(
                view.device) for i in range(info["state_leaves"])))

        batches = [(decode_batch(step, keys, payload),
                    meta.get("mode", "repair"))
                   for step, keys, payload, meta in
                   self._cm(name).replay_deltas(node=0,
                                                since_step=base_version,
                                                with_meta=True)]
        return view, batches
