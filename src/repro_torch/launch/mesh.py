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

The LM half (the reference's ``make_mesh``, ``make_production_mesh``,
``dp_axes``, ``model_axis_size``, ``dp_size``): :func:`make_mesh` builds a
``torch.distributed`` ``DeviceMesh`` over the initialised default group,
whose axes are named (``("data", "model")`` for the LM);
:func:`make_production_mesh` is shape-only (:class:`AxisMesh`: names and
sizes, no devices), as the reference's works only under forced host
devices.  The helpers read names and sizes from either kind.
:func:`set_mesh` makes a mesh ambient (the counterpart of
``jax.sharding.set_mesh``, read back by :func:`get_mesh`): flash decoding
and MoE's ``a2a`` dispatch read it.  :func:`batch_group` says whether the
batch the code sees is this rank's share of a batch split over the
data-parallel axes (the sharded train step declares it), so a mean over
the batch sums over that group.

The autograd collectives at the end run over one axis of a mesh, under
the port's convention for a sharded step: the loss is the sum of the
data-parallel ranks' local terms, and every rank of the ``"model"`` axis
computes the same values but for what a collective splits among them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
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


# ---------------------------------------------------------------------------
# The LM half: named meshes, their axes, the ambient mesh.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """A shape-only mesh: axis names and sizes, no devices (the production
    meshes of 256 and 512 chips, read by the sharding rules alone)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AxisMesh:
    """(16, 16) over ("data", "model") = 256 chips; multi-pod (2, 16, 16)
    over ("pod", "data", "model") = 512."""
    if multi_pod:
        return AxisMesh(("pod", "data", "model"), (2, 16, 16))
    return AxisMesh(("data", "model"), (16, 16))


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks in rank
    order, its dims named ``axes``.  The group must be initialised and
    have prod(shape) ranks.  ``device`` None = CUDA (raises without it);
    ``"cpu"`` for a gloo group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            f"process group of {math.prod(shape)} ranks: call "
            f"repro_torch.launch.mesh.init_shard_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{math.prod(shape)} ranks; the initialised group has {world}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (and "
                           "a gloo group) to build a mesh on the CPU")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    """The mesh's axis names (a ``DeviceMesh``'s dim names)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` (1 where the mesh has no such axis)."""
    names = axis_names(mesh)
    if name not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(names.index(name))
    return mesh.shape[name]


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (batch sharding)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


# (the default group, a mesh) -> the mesh's data-parallel group.  Keyed by
# value: DTensors may carry an equal mesh object of their own.
_DP_GROUPS: dict = {}


def dp_group(mesh):
    """The process group over the mesh's data-parallel axes: the data
    axis's, or the pod and data axes flattened into one (made on the first
    call for a mesh, then kept)."""
    axes = dp_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (dist.group.WORLD, mesh)
    if key not in _DP_GROUPS:
        # Every rank makes every group (one a model-axis index), as
        # new_group asks; a group's ranks sorted are the pod-major order.
        names = axis_names(mesh)
        ranks = mesh.mesh.permute(
            [i for i, a in enumerate(names) if a not in axes]
            + [names.index(a) for a in axes]).reshape(-1, dp_size(mesh))
        _DP_GROUPS[key] = dist.new_subgroups_by_enumeration(
            ranks.tolist())[0]
    return _DP_GROUPS[key]


def dp_rank(mesh) -> int:
    """This rank's index over the data-parallel axes, the first the
    major (``batch_spec``'s order of the batch's blocks)."""
    index = 0
    for axis in dp_axes(mesh):
        index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
    return index


_AMBIENT = {"mesh": None, "batch_group": None}


@contextlib.contextmanager
def set_mesh(mesh, *, batch_split: bool = False):
    """Within the block ``mesh`` is ambient (:func:`get_mesh`).  With
    ``batch_split`` the batch each rank holds is its share of a batch
    split over the mesh's data-parallel axes (:func:`batch_group`)."""
    old = dict(_AMBIENT)
    _AMBIENT["mesh"] = mesh
    _AMBIENT["batch_group"] = None
    if batch_split and dp_size(mesh) > 1:
        _AMBIENT["batch_group"] = dp_group(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.update(old)


def get_mesh():
    """The ambient mesh, None outside :func:`set_mesh`."""
    return _AMBIENT["mesh"]


def batch_group():
    """The data-parallel axes' group (:func:`dp_group`) where the batch
    is split over them, else None."""
    return _AMBIENT["batch_group"]


def axis_group(mesh, name: str):
    """(the process group of axis ``name``, this rank's index on it)."""
    return mesh.get_group(name), mesh.get_local_rank(name)


# ---------------------------------------------------------------------------
# Collectives with gradients, over one axis's group.
# ---------------------------------------------------------------------------

class _SumTerms(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the sum of the
    gradients, each rank's output feeding its own term of the loss (the
    data axis's convention)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over the group, which every rank then uses alike
    (the model axis's convention).  Backward: each rank's gradient as it
    is."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToReplicated(torch.autograd.Function):
    """Forward: the identity into computations that each rank does on its
    own part.  Backward: the parts' gradients summed over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows concatenated in rank order.  Backward:
    this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, t, group, index, size):
        ctx.index, ctx.rows = index, t.shape[0]
        t = t.contiguous()
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.rows
        return g[ctx.index * n:(ctx.index + 1) * n], None, None, None


class _SplitRows(torch.autograd.Function):
    """Forward: this rank's block of the (replicated) rows.  Backward:
    every rank's block gradient gathered, so the input's gradient is whole
    on each rank."""

    @staticmethod
    def forward(ctx, t, group, index, size):
        ctx.group, ctx.size = group, size
        n = t.shape[0] // size
        return t[index * n:(index + 1) * n]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((ctx.size * g.shape[0],) + tuple(g.shape[1:]))
        dist.all_gather_into_tensor(out, g, group=ctx.group)
        return out, None, None, None


class _AllToAll(torch.autograd.Function):
    """Forward: block ``j`` of the leading axis goes to rank ``j``.
    Backward: the same exchange of the gradient, which undoes it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def sum_terms(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, each rank's result feeding its own
    loss term (backward: the gradients summed)."""
    return _SumTerms.apply(t, group)


def sum_replicated(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, used alike by every rank
    (backward: the identity)."""
    return _SumReplicated.apply(t, group)


def to_replicated(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (alike on every rank) into per-rank partial computations
    (backward: their gradients summed)."""
    return _ToReplicated.apply(t, group)


def gather_rows(t: torch.Tensor, group, index: int, size: int
                ) -> torch.Tensor:
    """The ranks' rows concatenated in rank order (``index`` this rank's
    place among ``size``); backward: this rank's rows."""
    return _GatherRows.apply(t, group, index, size)


def split_rows(t: torch.Tensor, group, index: int, size: int
               ) -> torch.Tensor:
    """Block ``index`` of ``size`` of the rows; backward: the blocks'
    gradients gathered."""
    return _SplitRows.apply(t, group, index, size)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of the leading axis to rank ``j`` of ``group``, with
    its gradient's inverse exchange."""
    return _AllToAll.apply(t, group)
