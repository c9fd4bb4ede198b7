"""Shard ownership over a ``torch.distributed`` process group.

The counterpart of the REX half of ``repro/launch/mesh.py``: a flat mesh
of ``num_shards`` partition-snapshot shards laid over the ranks of a
process group.  A rank stands in for a JAX process and its local devices:
rank ``r`` of ``world`` owns the contiguous shards
``[r * S / world, (r + 1) * S / world)`` and computes them on its own
device.  ``core/engine.py`` runs both of its backends through a mesh:
``backend="shard_map"`` through a :class:`ShardMesh`, the simulated one
through a :class:`LocalMesh`, whose collectives are identities.

Device and backend rules: by default a rank computes on
``cuda:{rank % device_count}`` over NCCL.  The CPU and gloo are used only
when the caller names them (``device="cpu"``, ``backend="gloo"``), as the
tests do; without CUDA the defaults raise instead of falling back.

``make_production_mesh`` and the LM helpers (``dp_axes`` and the rest)
come with the port of ``launch/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``num_shards`` shards over the ``world`` ranks of ``group`` (None =
    the default group); this process is ``rank`` and computes on
    ``device``."""

    num_shards: int
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shards_per_rank(self) -> int:
        return self.num_shards // self.world

    # ---- collectives (synchronous, on this rank's device) -------------
    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        """Chunk ``j`` of ``inp``'s leading axis goes to rank ``j``; chunk
        ``i`` of the result comes from rank ``i``."""
        inp = inp.contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced in place over the ranks; ``op``: "sum" or "max"."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(t, op=ops[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the leading axis, in rank
        order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        box = [obj]
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast_object_list(
            box, src=src, group=self.group,
            device=self.device if self.device.type == "cuda" else None)
        return box[0]


class LocalMesh(ShardMesh):
    """Every shard in this process and no process group: the simulated
    backend.  Each collective is the identity (``all_to_all`` hands back
    its input uncopied, views included)."""

    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        return inp

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def broadcast_object(self, obj):
        return obj


def local_mesh(num_shards: int, device) -> LocalMesh:
    """All ``num_shards`` shards on ``device``, in this process."""
    return LocalMesh(num_shards=num_shards, rank=0, world=1,
                     device=torch.device(device))


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (and a gloo group) "
            "to run the shard_map backend on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def flat_mesh(num_shards: int, *, group=None, device=None) -> ShardMesh:
    """The flat mesh of ``num_shards`` shards over ``group``'s ranks (None
    = the default group, which must be initialised: see
    :func:`init_shard_group`).  ``device`` None = ``cuda:{rank %
    device_count}``; raises without CUDA."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "the shard_map backend needs an initialised process group: "
            "call repro_torch.launch.mesh.init_shard_group first")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if num_shards <= 0 or num_shards % world:
        raise ValueError(
            f"num_shards={num_shards} does not split evenly over "
            f"{world} ranks")
    dev = (_default_device(dist.get_rank()) if device is None
           else torch.device(device))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return ShardMesh(num_shards=num_shards, rank=rank, world=world,
                     device=dev, group=group)


def shard_process_indices(mesh: ShardMesh) -> list[int]:
    """Owning rank of each shard, in shard order."""
    return [s // mesh.shards_per_rank for s in range(mesh.num_shards)]


def local_shards(mesh: ShardMesh, process_index: Optional[int] = None
                 ) -> range:
    """The shards owned by rank ``process_index`` (default: this one): a
    contiguous block of ``shard_process_indices``."""
    if process_index is None:
        process_index = mesh.rank
    owned = [s for s, r in enumerate(shard_process_indices(mesh))
             if r == process_index]
    return range(owned[0], owned[-1] + 1)


def init_shard_group(backend: Optional[str] = None,
                     init_method: str = "env://", *, world_size: int = -1,
                     rank: int = -1,
                     timeout: Optional[datetime.timedelta] = None) -> None:
    """Initialise the default process group for the shard_map backend.

    ``backend`` None = NCCL (raises without CUDA; pass ``"gloo"`` for the
    CPU).  ``init_method`` as ``torch.distributed.init_process_group``
    takes it: ``env://`` reads ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``, and ``file://<path>`` with ``world_size`` and ``rank``
    needs no port.  Under NCCL the rank's device is made current."""
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass backend='gloo' to run the "
                "shard_map backend on the CPU")
        backend = "nccl"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
