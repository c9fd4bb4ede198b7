"""Checkpointing: full snapshots + REX incremental delta checkpoints.

Paper §4.3: MapReduce checkpoints *everything* (expensive); pipelined DBs
checkpoint *nothing* (no forward-progress guarantee).  REX's hybrid keeps
periodic full checkpoints and, per stratum, replicates only the **mutable
Δᵢ set** — so recovery restarts from the last completed stratum instead of
from scratch, and the per-stratum overhead shrinks as the computation
converges (|Δᵢ| ↓).

This module implements both sides generically over trees of tensors
(dicts, tuples, lists, NamedTuples, dataclasses; leaves are tensors or
arrays, written from the host):

  * ``save_full`` / ``load_full``        — atomic full snapshots with a
    replication chain (shard s's files are copied to replicas
    (s+1..s+R−1) mod S — the paper's DHT replication, factor 3).
  * ``save_delta`` / ``replay_deltas``   — per-stratum Δ checkpoints:
    (stratum, DeltaBuffer) pairs for analytics; (step, sparse param diff)
    for training.

Checkpoints are plain ``.npz`` files under a directory tree; on a real
cluster each worker writes its shard to local disk and the replication
chain copies cross-host (simulated here with directories per "node").

Integrity contract (chaos-hardened):

  * Writes are atomic and durable: tmp file + fsync + ``os.replace`` +
    directory fsync, so a crash mid-write leaves the previous restore
    point intact and never a torn file at the final path.
  * Every checkpoint embeds a sha256 over its array contents
    (``__sum__``); reads verify it.  A torn or bit-corrupted file raises
    :class:`CheckpointCorruption`, is moved to a ``quarantine/``
    subdirectory (never silently deleted — it is forensic evidence),
    and the reader falls back to the next replica holding the same step.
  * Reads can be wrapped in a ``runtime.retry.Retrier`` (transient-error
    retry with seeded backoff); corruption is NOT retried — the same
    bytes would fail again — it falls through to the replica chain.

The on-disk format is the reference package's (``repro.runtime.
checkpoint``): the same file names, manifest, array names (a leaf's tree
path, written as ``jax.tree_util`` writes it: ``['key']``, ``[0]``,
``.field``, joined by ``/``) and ``__sum__`` digest, so each package reads
the other's checkpoints.  A bfloat16 leaf is written as the reference
writes it (its bits under '<V2', digested as ``bfloat16``) and restored by
the template leaf's dtype; the reference itself cannot restore such a file
(its digest reads the dtype back as '|V2').
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Optional

import dataclasses

import numpy as np
import torch


class CheckpointCorruption(RuntimeError):
    """A checkpoint file failed integrity verification (torn write,
    truncated archive, or bit corruption)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


# A bfloat16 leaf is held as its 2-byte bits (numpy has no bfloat16 of its
# own), written under the descr '<V2' and digested as "bfloat16", exactly
# as the reference writes an ml_dtypes bfloat16 array.  A '|V2' array read
# back is such a leaf.
BF16_BITS = np.dtype("V2")


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BITS else str(arr.dtype)


def _digest(arrays: dict) -> np.ndarray:
    """sha256 over array contents + dtypes + shapes, name-sorted —
    stored inside the npz so the checkpoint is self-verifying."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(_dtype_name(arr).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def _read_npz(path: str) -> dict:
    """Load + verify one checkpoint; raises CheckpointCorruption on a
    torn/truncated/bit-flipped file.  Files written before checksums
    existed (no ``__sum__``) load unverified."""
    try:
        with np.load(path) as data:
            arrays = {k: np.array(data[k]) for k in data.files}
    except OSError:
        raise          # missing file / transient FS error — retryable,
        #                not corruption (the caller's retrier handles it)
    except Exception as e:       # torn zip, truncated array, bad pickle
        raise CheckpointCorruption(path, f"unreadable: {e!r}") from e
    expected = arrays.pop("__sum__", None)
    if expected is not None \
            and not np.array_equal(_digest(arrays), expected):
        raise CheckpointCorruption(path, "checksum mismatch")
    return arrays


def _quarantine(path: str) -> str:
    """Move a corrupt file aside (same filesystem, atomic) so retries
    and replicas never re-read it; returns the quarantine path."""
    qdir = os.path.join(os.path.dirname(path), "quarantine")
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, os.path.basename(path))
    try:
        os.replace(path, dst)
    except OSError:
        pass                      # already gone (concurrent wipe) — fine
    return dst


def _fsync_dir(dirname: str) -> None:
    fd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, payload: dict) -> None:
    """Durable atomic JSON write (tmp + fsync + replace + dir fsync) —
    manifests must never be readable half-written."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _children(tree):
    """(path step, child) pairs of an inner node, or None for a leaf.
    Dict keys go in sorted order, as ``jax.tree_util`` visits them; None
    is a node without children, as in ``jax.tree_util``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _to_host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().cpu().view(torch.int16).numpy().view(
                BF16_BITS)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_paths(tree, prefix: str = "") -> list:
    """[(tree path, leaf)] over every leaf of ``tree``, in tree order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for step, child in kids
            for pair in _leaf_paths(child, f"{prefix}/{step}" if prefix
                                    else step)]


def _flatten_with_paths(tree) -> dict:
    """{tree path: host array} over every leaf of ``tree``."""
    return {path: _to_host(leaf) for path, leaf in _leaf_paths(tree)}


def _tree_like(tree, arrays: dict, prefix: str = ""):
    """``tree``'s structure with each leaf read from ``arrays``: a tensor
    on the template leaf's device where that leaf is a tensor, else an
    array."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        arr = arrays[prefix]
        if torch.is_tensor(tree):
            if arr.dtype == BF16_BITS and tree.dtype == torch.bfloat16:
                return torch.from_numpy(np.array(arr).view(np.int16)).view(
                    torch.bfloat16).to(tree.device)
            return torch.from_numpy(np.array(arr)).to(tree.device)
        return np.array(arr)
    vals = [_tree_like(child, arrays, f"{prefix}/{step}" if prefix
                       else step) for step, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(vals)
    return type(tree)(**{f.name: v for f, v in
                         zip(dataclasses.fields(tree), vals)})


def _savez(path: str, arrays: dict) -> None:
    """``np.savez``'s archive (stored, zip64 entries ``<name>.npy``), with
    each bfloat16 leaf's bits under the descr '<V2'."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype == BF16_BITS:
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False,
                            "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(f, arr)


def _atomic_savez(path: str, **arrays):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # suffix must end in .npz or np.savez appends it and the rename
    # would move an empty file.
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
    os.close(fd)
    try:
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        _savez(tmp, {"__sum__": _digest(arrays), **arrays})
        # fsync file THEN replace THEN fsync dir: after a crash the final
        # path holds either the old complete file or the new complete
        # file — never torn bytes.
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class CheckpointManager:
    """Directory layout:  <root>/node<k>/{full_<step>.npz, delta_<step>.npz,
    MANIFEST.json}.  ``replication`` copies every write to the next R−1
    node directories (the paper's replica chain)."""

    def __init__(self, root: str, num_nodes: int = 1, replication: int = 3,
                 keep: int = 2, retrier=None):
        self.root = root
        self.num_nodes = num_nodes
        self.replication = min(replication, num_nodes)
        self.keep = keep
        # Optional runtime.retry.Retrier: transient read errors are
        # retried with seeded backoff; CheckpointCorruption is never
        # retried (deterministic) — it quarantines and falls through to
        # the next replica instead.
        self.retrier = retrier
        self.quarantined: list[str] = []
        os.makedirs(root, exist_ok=True)

    def _load(self, path: str) -> dict:
        """Verified read of one checkpoint file, through the retrier
        when one is attached (transient-error retry only)."""
        if self.retrier is None:
            return _read_npz(path)
        return self.retrier.call(
            _read_npz, path, op=f"ckpt_read:{os.path.basename(path)}",
            retryable=(OSError,))

    def _load_fallback(self, paths: list[str], what: str) -> dict:
        """Read the first verifiable copy among replicas of ONE logical
        checkpoint; corrupt copies are quarantined and skipped.  Raises
        CheckpointCorruption only when every copy is bad — a torn write
        must never silently drop a stratum from the replay."""
        last: Optional[Exception] = None
        for path in paths:
            try:
                return self._load(path)
            except FileNotFoundError as e:
                last = e          # replica vanished (wipe race) — skip
            except CheckpointCorruption as e:
                self.quarantined.append(_quarantine(path))
                last = e
        raise CheckpointCorruption(
            what, f"all {len(paths)} replica cop(ies) corrupt; "
                  f"last: {last}")

    def _node_dir(self, node: int) -> str:
        return os.path.join(self.root, f"node{node}")

    def _replicas(self, node: int):
        return [(node + r) % self.num_nodes
                for r in range(self.replication)]

    # ---- full checkpoints ------------------------------------------------
    def save_full(self, node: int, step: int, tree) -> None:
        arrays = _flatten_with_paths(tree)
        for tgt in self._replicas(node):
            path = os.path.join(self._node_dir(tgt),
                                f"full_{step:08d}_of{node}.npz")
            _atomic_savez(path, **arrays)
        self._write_manifest(node, step, kind="full")
        self._gc(node)

    def load_full(self, node: int, like, step: Optional[int] = None,
                  from_replica: bool = False, exclude_self: bool = False):
        """Restore node's latest (or ``step``) full snapshot; with
        ``from_replica`` read it from the replica chain (the node's own
        disk is presumed lost — paper recovery path).  ``exclude_self``
        additionally skips the node's own directory even if it survives —
        straggler speculation reads ONLY replicas, proving the re-issued
        work never needs the slow node's disk."""
        sources = self._replicas(node) if from_replica else [node]
        if exclude_self:
            sources = [s for s in sources if s != node]
        # Collect every copy of every candidate step across sources, so
        # a corrupt copy on one replica falls back to the same step on
        # another, and an entirely-corrupt step falls back to the next
        # OLDER step still on disk.
        by_step: dict[int, list[str]] = {}
        for src in sources:
            d = self._node_dir(src)
            if not os.path.isdir(d):
                continue
            for f in os.listdir(d):
                if not (f.startswith("full_")
                        and f.endswith(f"_of{node}.npz")):
                    continue
                s = int(f.split("_")[1])
                if step is not None and s != step:
                    continue
                by_step.setdefault(s, []).append(os.path.join(d, f))
        last: Optional[Exception] = None
        for s in sorted(by_step, reverse=True):
            try:
                arrays = self._load_fallback(
                    by_step[s], f"full step {s} of node {node}")
            except CheckpointCorruption as e:
                last = e                  # fall back to the older step
                continue
            arrays.pop("__sum__", None)
            return _tree_like(like, arrays), s
        if last is not None:
            raise CheckpointCorruption(
                f"node {node}", f"every full checkpoint corrupt "
                                f"(steps {sorted(by_step)}): {last}")
        raise FileNotFoundError(
            f"no full checkpoint for node {node} (replicas searched: "
            f"{sources})")

    # ---- incremental delta checkpoints ------------------------------------
    def save_delta(self, node: int, step: int, keys, payload,
                   meta: Optional[dict] = None) -> int:
        """Replicate one stratum's Δ set (indices + payloads only — the
        paper's incremental checkpoint).  Returns bytes written per
        replica."""
        keys = np.asarray(keys)
        payload = np.asarray(payload)
        for tgt in self._replicas(node):
            path = os.path.join(self._node_dir(tgt),
                                f"delta_{step:08d}_of{node}.npz")
            _atomic_savez(path, keys=keys, payload=payload,
                          meta=np.frombuffer(
                              json.dumps(meta or {}).encode(), np.uint8))
        self._write_manifest(node, step, kind="delta")
        return int(keys.nbytes + payload.nbytes)

    def replay_deltas(self, node: int, since_step: int,
                      from_replica: bool = False, with_meta: bool = False,
                      exclude_self: bool = False,
                      merge_sources: bool = False):
        """Yield (step, keys, payload) for every delta checkpoint after
        ``since_step``, in order — recovery replays these onto the
        restored full snapshot to reach the last completed stratum.
        With ``with_meta`` each item gains the decoded meta dict;
        ``exclude_self`` reads only true replicas (see ``load_full``).

        By default the FIRST source directory holding any matching entry
        wins (single-writer history).  ``merge_sources`` instead unions
        entries across all sources by step — required once a node's disk
        has been wiped and re-created mid-history: its own directory then
        holds only post-recovery entries while the older strata live on
        the replicas, and neither side alone is complete.  (Replicated
        writes are byte-identical per step, so the union is unambiguous.)
        """
        sources = self._replicas(node) if from_replica else [node]
        if exclude_self:
            sources = [s for s in sources if s != node]
        # Every source's copy of each step is kept as a fallback: a
        # torn/corrupt delta on one replica reads from the next replica
        # instead of silently dropping the stratum (which would corrupt
        # the restored shard).
        found: dict[int, list[str]] = {}
        primary_sources: Optional[set] = None
        for src in sources:
            d = self._node_dir(src)
            if not os.path.isdir(d):
                continue
            cands = sorted(f for f in os.listdir(d)
                           if f.startswith("delta_")
                           and f.endswith(f"_of{node}.npz"))
            steps = [(int(f.split("_")[1]), f) for f in cands]
            steps = [(s, f) for s, f in steps if s > since_step]
            if steps and not merge_sources and primary_sources is None:
                # single-writer history: the FIRST source holding any
                # matching entry wins, but later sources still provide
                # per-step fallback copies for corruption recovery.
                primary_sources = {s for s, _ in steps}
            for s, f in steps:
                if not merge_sources and primary_sources is not None \
                        and s not in primary_sources:
                    continue
                found.setdefault(s, []).append(os.path.join(d, f))
        for s in sorted(found):
            data = self._load_fallback(
                found[s], f"delta step {s} of node {node}")
            if with_meta:
                meta = json.loads(bytes(data["meta"]).decode())
                yield s, data["keys"], data["payload"], meta
            else:
                yield s, data["keys"], data["payload"]

    # ---- bookkeeping -----------------------------------------------------
    def _write_manifest(self, node: int, step: int, kind: str):
        path = os.path.join(self._node_dir(node), "MANIFEST.json")
        manifest = {"latest_step": step, "kind": kind}
        atomic_write_json(path, manifest)

    def _gc(self, node: int):
        """Keep the last ``keep`` full checkpoints (+ their deltas)."""
        for tgt in self._replicas(node):
            d = self._node_dir(tgt)
            if not os.path.isdir(d):
                continue
            fulls = sorted(f for f in os.listdir(d)
                           if f.startswith("full_")
                           and f.endswith(f"_of{node}.npz"))
            for f in fulls[:-self.keep]:
                os.unlink(os.path.join(d, f))
            if fulls:
                oldest_kept = int(fulls[-self.keep:][0].split("_")[1])
                for f in os.listdir(d):
                    if (f.startswith("delta_")
                            and f.endswith(f"_of{node}.npz")
                            and int(f.split("_")[1]) < oldest_kept):
                        os.unlink(os.path.join(d, f))

    def wipe_node(self, node: int):
        """Simulate total disk loss of one node (failure injection)."""
        d = self._node_dir(node)
        if os.path.isdir(d):
            shutil.rmtree(d)
