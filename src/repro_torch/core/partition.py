"""Partition snapshots (paper §4.1).

REX distributes every query together with a *snapshot* of the key-space
partitioning; all data is routed according to that snapshot for the
lifetime of the query.  Keys are integers in [0, n_keys).  Two schemes:

  * ``block``: contiguous ranges (key // block_size), so the dense state of
    shard s is exactly ``state[s*block : (s+1)*block]``;
  * ``hash``: multiplicative hash mod shards, for skew resistance.
"""
from __future__ import annotations

import dataclasses

import torch

_HASH_MULT = 2654435761  # Knuth multiplicative hash (uint32)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PartitionSnapshot:
    n_keys: int
    num_shards: int
    scheme: str = "block"           # "block" | "hash"
    replication: int = 3

    def __post_init__(self):
        if self.scheme not in ("block", "hash"):
            raise ValueError(self.scheme)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")

    @property
    def block_size(self) -> int:
        """Keys per shard (block scheme); key space is padded to a multiple."""
        return -(-self.n_keys // self.num_shards)

    @property
    def padded_keys(self) -> int:
        return self.block_size * self.num_shards

    def owner_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Owning shard for each key (negative keys -> -1), int32."""
        keys = keys.to(torch.int32)
        if self.scheme == "block":
            owner = torch.div(keys, self.block_size, rounding_mode="floor")
        else:
            # uint32 multiply emulated in int64: (k mod 2^32) * M mod 2^32.
            h = ((keys.long() & _U32) * _HASH_MULT & _U32) >> 16
            owner = h % self.num_shards
        return torch.where(keys < 0, -1, owner).to(torch.int32)

    def local_index(self, keys: torch.Tensor) -> torch.Tensor:
        """Index of a key within its owner's dense state block, int32."""
        keys = keys.to(torch.int32)
        if self.scheme == "block":
            local = torch.remainder(keys, self.block_size)
        else:
            local = torch.div(keys, self.num_shards, rounding_mode="floor")
        return torch.where(keys < 0, -1, local).to(torch.int32)

    def replicas_of(self, shard: int) -> list[int]:
        """Replication chain for a shard (paper §4.1, factor R)."""
        return [(shard + r) % self.num_shards
                for r in range(1, min(self.replication, self.num_shards))]

    def global_keys(self, shard, local_idx):
        """Inverse of (owner_of, local_index) for in-range local indices:
        how replica-chain entries (kept per shard, indexed locally) are
        re-keyed to the GLOBAL key space so they can be re-routed under
        another snapshot (elastic migration).  Block scheme only: the hash
        scheme's owner is not invertible from (shard, local)."""
        if self.scheme != "block":
            raise ValueError("global_keys requires the block scheme")
        return shard * self.block_size + local_idx

    def shard_slice(self, shard: int) -> slice:
        """Dense key range owned by ``shard`` (block scheme only)."""
        if self.scheme != "block":
            raise ValueError("shard_slice requires the block scheme")
        return slice(shard * self.block_size, (shard + 1) * self.block_size)

    def resnapshot(self, num_shards: int) -> "PartitionSnapshot":
        """New snapshot after the node set changes (elastic / recovery)."""
        return dataclasses.replace(self, num_shards=num_shards)


def shard_dense_state(snapshot: PartitionSnapshot, state: torch.Tensor
                      ) -> torch.Tensor:
    """Pad + reshape a dense keyed tensor to [num_shards, block_size, ...]."""
    pad = snapshot.padded_keys - state.shape[0]
    if pad:
        state = torch.cat([state, state.new_zeros((pad,) + state.shape[1:])])
    return state.reshape((snapshot.num_shards, snapshot.block_size)
                         + tuple(state.shape[1:]))


def unshard_dense_state(snapshot: PartitionSnapshot, sharded: torch.Tensor
                        ) -> torch.Tensor:
    """Inverse of :func:`shard_dense_state` (drops padding)."""
    flat = sharded.reshape((snapshot.padded_keys,) + tuple(sharded.shape[2:]))
    return flat[:snapshot.n_keys]
