"""Sharding rules: parameter, optimizer, cache and batch partition specs,
and their placements on a ``torch.distributed`` mesh (the reference's
``launch/sharding.py``).

Scheme (the reference's):
  * 2-D weight sharding: the "parallel" dim (heads / d_ff / experts /
    vocab) shards over **model** (TP/EP); the other large dim over
    **data** (FSDP, the ZeRO-3 analogue).  Optimizer moments take the
    parameter's spec.
  * The **pod** axis is pure DP: parameters replicated across pods.
  * The batch shards over (pod, data).
  * Decode caches: batch over the DP axes; the longest remaining dim
    divisible by the model axis over **model** (context-parallel KV).
Every assignment is checked for divisibility, with the reference's
fallbacks (minicpm3's vocab of 73,448 is not a multiple of 16, so its
embedding shards ``d_model`` instead; mixtral's 8 experts at a model axis
of 16 fall back to TP).

A spec is a :class:`P`: a tuple with the reference's entries, one a tensor
dim (None, an axis name, or a tuple of names).  The port keeps an LM's
parameters per layer (``models/transformer.py``); the spec of a per-layer
parameter is the reference's spec of the stacked leaf it belongs to
(``transformer.stacked_name``) without the leading unit entry, so the
same divisibility fallbacks apply (:func:`tree_specs` of an ``LM``).

Placements: :func:`to_shardings` turns a spec into ``DTensor`` placements
on a ``DeviceMesh`` (``Shard(i)`` on each mesh dim that the spec names for
tensor dim ``i``, ``Replicate()`` elsewhere), the counterpart of
``NamedSharding``.  :func:`shard_params` stores an LM's parameters as
DTensors so; :func:`make_gather_fn` is the ZeRO-3 hook: at the point of
use it redistributes a layer's parameters to the layout :func:`drop_data`
gives (the all-gather over the data axes; autograd reduce-scatters the
gradients back to the storage layout).

Compute over the model axis (the reference's GSPMD partitioning of that
layout): :func:`tp_plan` says which parts of a config's layers split over
"model" (heads, d_ff, vocab; ``models/tp.py``), and :func:`tp_local`
hands the layer code each gathered parameter as this rank computes with
it: the rank's block where the plan splits its part (column-parallel
``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` and the head, row-parallel
``wo`` and ``w_down``), the KV heads its query heads need where the KV
heads do not split, and the parameter replicated over the model axis
elsewhere (:func:`compute_tensor`).  Its gradient is partial over the
data axes (each rank's share of the batch), in its block on the model
axis, and partial there for KV heads that several ranks compute; the
gather's backward reduce-scatters it.  MoE's ``a2a`` experts take the
gathered layout as it is (:func:`local_block`), and flash decoding splits
the cache's slots; decode's layer code is replicated over the model axis.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.launch.mesh import (axis_names, axis_size, dp_axes, dp_size,
                                     model_axis_size)


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name or a
    tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def _axis(mesh, name: str) -> Optional[str]:
    return name if name in axis_names(mesh) else None


def param_spec(path: str, shape: tuple, mesh) -> P:
    """The spec of a parameter leaf addressed by its reference tree path
    (``params/units/b0_dense/attn/wq``, shape ``(U, D, H·Dh)``)."""
    msize = model_axis_size(mesh)
    dsize = axis_size(mesh, "data")
    model = _axis(mesh, "model")
    data = _axis(mesh, "data")

    # Strip the stacked-units leading axis (units/enc_units subtrees).
    lead: tuple = ()
    if ("units" in path or "enc_units" in path) and len(shape) > 1:
        lead, shape = (None,), tuple(shape[1:])

    def dim(i, axis, size):
        return axis if axis and _fits(shape[i], size) else None

    n = len(shape)
    if n <= 1:
        # vectors (norm scales, lam): shard over model when large.
        spec = (dim(0, model, msize) if n == 1 and shape[0] >= 1024
                else (None,) * n)
        return P(*lead, *(spec if isinstance(spec, tuple) else (spec,)))

    name = path.split("/")[-1]
    if name == "embed":
        s = (dim(0, model, msize), dim(1, data, dsize))
        if s[0] is None:        # vocab not divisible: shard d_model on model
            s = (None, dim(1, model, msize))
        return P(*s)
    if name == "lm_head":
        s = (dim(0, data, dsize), dim(1, model, msize))
        if s[1] is None:
            s = (dim(0, model, msize), None)
        return P(*s)
    if name == "router":
        return P(*lead, None, None)
    if name in ("w_gate", "w_up", "w_down") and n == 3:   # experts [E,·,·]
        e_ax = dim(0, model, msize)
        if name == "w_down":    # [E, F, D]
            return P(*lead, e_ax, dim(1, data, dsize) if e_ax else
                     dim(1, model, msize), None)
        return P(*lead, e_ax, dim(1, data, dsize) if e_ax else None,
                 dim(2, model, msize) if not e_ax else None)
    if name in ("wo", "w_down", "w_out"):                 # [big, D]
        return P(*lead, dim(0, model, msize), dim(1, data, dsize))
    if name == "r_gates":                                 # [4, H, hd, hd]
        return P(*lead, None, dim(1, model, msize), None, None)
    if name == "conv_w":                                  # [W, R]
        return P(*lead, None, dim(1, model, msize))
    if n == 2:
        # Default projection [D_in, D_out]: FSDP on in, TP on out.
        return P(*lead, dim(0, data, dsize), dim(1, model, msize))
    return P(*lead, *(None,) * n)


def walk(tree, leaf_fn, *others, path: str = "", is_leaf=None):
    """``leaf_fn(path, leaf, *other_leaves)`` over dicts, lists and tuples
    (NamedTuples kept), paths joined with "/"; ``others`` are trees of the
    same structure walked alongside, and ``is_leaf`` ends the descent
    early (a spec is a tuple)."""
    def sub(key, node, rest):
        return walk(node, leaf_fn, *(o[key] for o in rest),
                    path=f"{path}/{key}", is_leaf=is_leaf)
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: sub(k, v, others) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
            vals = [sub(i, v, others) for i, v in enumerate(tree)]
            return (type(tree)(*vals) if hasattr(tree, "_fields")
                    else type(tree)(vals))
    return leaf_fn(path, tree, *others)


def _is_lm(tree) -> bool:
    return isinstance(tree, nn.Module) and hasattr(tree, "kinds")


def leaf_specs(params, mesh) -> dict:
    """{reference leaf name: the reference's spec of the stacked leaf}
    (the stacked shape, its leading unit entry included): the specs of
    μ, ν, residuals and gradients, which the port keeps by leaf."""
    from repro_torch.models.transformer import stacked_leaves
    from repro_torch.train.optimizer import leaf_shape
    return {name: param_spec("params/" + name.replace(".", "/"),
                             leaf_shape(name, ps), mesh)
            for name, ps in stacked_leaves(params).items()}


def tree_specs(tree, mesh, prefix: str = ""):
    """Specs of a tree.  Of an ``LM``: {parameter name: the spec of its
    stacked leaf without the leading unit entry}.  Of dicts, lists and
    tuples of arrays: the reference's, ``param_spec`` of each leaf at its
    path under ``prefix``."""
    if _is_lm(tree):
        from repro_torch.models.transformer import is_stacked, stacked_name
        leaves = leaf_specs(tree, mesh)
        out = {}
        for name, _ in tree.named_parameters():
            leaf = stacked_name(name, tree)
            spec = leaves[leaf]
            out[name] = P(*spec[1:]) if is_stacked(leaf) else spec
        return out
    return walk(tree, lambda path, x: param_spec(path, tuple(x.shape), mesh),
                path=prefix)


def batch_spec(shape: tuple, mesh) -> P:
    """Tokens/labels/frames/embeds: batch over the DP axes when
    divisible."""
    dps = dp_axes(mesh)
    total = dp_size(mesh)
    if shape and _fits(shape[0], total):
        return P(dps, *(None,) * (len(shape) - 1))
    return P(*(None,) * len(shape))


def cache_spec(path: str, shape: tuple, mesh) -> P:
    """Decode-cache leaves: batch -> DP; the longest remaining divisible
    dim -> model (context-parallel KV)."""
    msize = model_axis_size(mesh)
    model = _axis(mesh, "model")
    dps = dp_axes(mesh)
    total = dp_size(mesh)
    lead: tuple = ()
    if "units" in path and len(shape) > 1:
        lead, shape = (None,), tuple(shape[1:])
    spec = [None] * len(shape)
    if shape and _fits(shape[0], total):
        spec[0] = dps
    if model and len(shape) > 1:
        # Largest non-batch dim divisible by the model axis.
        cands = sorted(range(1, len(shape)), key=lambda i: -shape[i])
        for i in cands:
            if _fits(shape[i], msize):
                spec[i] = model
                break
    return P(*lead, *spec)


def cache_tree_specs(cache, mesh, cfg) -> dict:
    """The port's cache ``{"layers": [...]}`` with each leaf's spec: the
    reference's spec of the stacked cache leaf the layer's leaf belongs to
    (``cache/units/b{i}_<kind>/...``, rows of ``n_units``; a tail layer's
    ``cache/tail/t{j}_<kind>/...``), without the leading unit entry."""
    from repro_torch.models.transformer import layer_leaf

    def layer(i, c):
        prefix, row = layer_leaf(cfg, i)

        def spec(path, x):
            shape = tuple(x.shape)
            if row is not None:
                return P(*cache_spec(path, (cfg.n_units,) + shape,
                                     mesh)[1:])
            return cache_spec(path, shape, mesh)
        return walk(c, spec, path="cache/" + prefix.replace(".", "/"))
    return {"layers": [layer(i, c) for i, c in enumerate(cache["layers"])]}


def _without(spec: P, axes: tuple) -> P:
    def keep(ax):
        if ax is None:
            return None
        if isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a not in axes)
            return kept if kept else None
        return None if ax in axes else ax
    return P(*(keep(a) for a in spec))


def drop_data(spec: P) -> P:
    """The TP-only view of a parameter spec (the ZeRO-3 gathered
    layout)."""
    return _without(spec, ("data", "pod"))


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh (DTensor).
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec``: on each mesh dim, ``Shard(i)`` where
    the spec names that dim's axis for tensor dim ``i``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, (tuple, list))
                                  and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def to_shardings(spec_tree, mesh):
    """Each spec of a tree (dicts, lists, tuples of :class:`P`) as its
    placements on ``mesh``."""
    return walk(spec_tree, lambda _, spec: placements(spec, mesh),
                is_leaf=lambda t: isinstance(t, P))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_shape(shape: tuple, mesh, place) -> tuple:
    """The shape of this rank's block of a tensor of ``shape`` in
    ``place``: each ``Shard(d)``, mesh dim by mesh dim, keeps this rank's
    chunk of dim d as ``torch.chunk`` cuts it."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard():
            n, c = mesh.size(i), coord[i]
            chunk = -(-out[p.dim] // n)
            out[p.dim] = max(0, min(chunk, out[p.dim] - c * chunk))
    return tuple(out)


def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` (the same whole value on every rank) as a DTensor of
    placements ``place``: each rank keeps its own block, no
    communication.  A fake tensor (the dry run's) has no values to cut:
    its block is made at :func:`local_shape`."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models.layers import is_fake
    with torch.no_grad():
        if is_fake(t):
            return DTensor.from_local(
                t.new_empty(local_shape(tuple(t.shape), mesh, place)),
                mesh, place, run_check=False, shape=t.shape,
                stride=t.stride())
        return distribute_tensor(t.detach(), mesh, place, src_data_rank=None)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (a collective), a tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor (its storage), a tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def assign(dst: torch.Tensor, value: torch.Tensor) -> None:
    """Copy the whole ``value`` into ``dst`` (this rank's block of it where
    ``dst`` is a DTensor), in place."""
    with torch.no_grad():
        if is_dtensor(dst):
            value = distribute(value.to(dst.dtype), dst.device_mesh,
                               dst.placements).to_local()
        local(dst).copy_(value)


def grad_placements(mesh, place) -> list:
    """The placements of a rank's gradient of a tensor used in
    ``place``: partial over the data axes (each rank's share of the
    batch), as placed on the others."""
    from torch.distributed.tensor import Partial
    return [Partial() if name in ("pod", "data") else p
            for name, p in zip(axis_names(mesh), place)]


def gathered_layout(t: torch.Tensor) -> torch.Tensor:
    """A stored DTensor redistributed to :func:`drop_data`'s layout: the
    all-gather over the data axes (backward: the reduce-scatter)."""
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    place = [Replicate() if name in ("pod", "data") else p
             for name, p in zip(axis_names(mesh), t.placements)]
    if place == list(t.placements):     # nothing to gather: no dispatch
        return t
    return t.redistribute(mesh, place)


class _Compute(torch.autograd.Function):
    """Forward: a DTensor replicated over the data axes and in
    ``model_place`` on the model axis, as this rank's local tensor.
    Backward: the local gradient, partial over the data axes (and over the
    model axis where ``model_partial``: ranks that each computed with the
    whole tensor's part), in the input's placements.  An input that a
    gather made (:func:`gathered_layout`, a tensor with a ``grad_fn``)
    takes it still partial over the data axes, and the gather's backward
    reduce-scatters it to the storage layout (a redistribute to replicated
    would all-reduce it first); a stored tensor takes it summed over
    them."""

    @staticmethod
    def forward(ctx, t, model_place, model_partial):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.place = t.device_mesh, tuple(t.placements)
        ctx.gathered = t.grad_fn is not None
        ctx.model_place, ctx.model_partial = model_place, model_partial
        return t.redistribute(ctx.mesh, [
            model_place if name == "model" else Replicate()
            for name in axis_names(ctx.mesh)]).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, names = ctx.mesh, axis_names(ctx.mesh)
        place = [(Partial() if ctx.model_partial else ctx.model_place)
                 if name == "model" else Replicate() for name in names]
        g = DTensor.from_local(g, mesh, grad_placements(mesh, place),
                               run_check=False)
        return g.redistribute(mesh, [
            Partial() if ctx.gathered and name in ("pod", "data") else p
            for name, p in zip(names, ctx.place)]), None, None


def compute_tensor(t: torch.Tensor) -> torch.Tensor:
    """A parameter as replicated layer code uses it: a DTensor replicated
    over every axis, as this rank's local tensor (its gradient partial
    over the data axes, whole on the model axis; :class:`_Compute`); a
    tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    rep = [Replicate()] * mesh.ndim
    if list(t.placements) == rep and dp_size(mesh) == 1:
        # Nothing to gather, and a gradient partial over axes of size 1
        # is whole: the redistribute (a host dispatch a use) is skipped.
        return t.to_local(grad_placements=rep)
    return _Compute.apply(t, Replicate(), False)


# ---------------------------------------------------------------------------
# Compute over the model axis (models/tp.py).
# ---------------------------------------------------------------------------

def tp_plan(cfg, msize: int):
    """The :class:`models.tp.Plan` of ``cfg`` on a model axis of
    ``msize`` ranks, read from the specs at a model axis of that size:
    attention splits by whole heads where ``msize`` divides n_heads and the
    config has a GQA kind (its KV heads in blocks where ``msize`` divides
    n_kv_heads, else each rank computes the one its query heads share, or
    the attention stays whole where they straddle two); the MLP where the
    spec puts d_ff on "model"; the head and the embedding lookup where it
    puts vocab there.  Nothing splits at ``msize`` 1."""
    from repro_torch.launch.mesh import AxisMesh
    from repro_torch.models.tp import TP_KINDS, Plan
    mesh = AxisMesh(("data", "model"), (1, msize))
    h, h_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv = "replicated"
    gqa = any(k in TP_KINDS for k in cfg.unit)
    if msize > 1 and gqa and h % msize == 0 and \
            param_spec("params/units/b0/attn/wq", (1, cfg.d_model, h * hd),
                       mesh)[-1] == "model":
        if h_kv % msize == 0:
            kv = "split"
        elif (h // h_kv) % (h // msize) == 0:
            kv = "computed"
    mlp = bool(cfg.d_ff) and param_spec(
        "params/units/b0/mlp/w_gate", (1, cfg.d_model, cfg.d_ff),
        mesh)[-1] == "model"
    head = param_spec("params/embed", (cfg.vocab, cfg.d_model),
                      mesh)[0] == "model"

    def part(split):
        return "split" if split else "replicated"
    return Plan(size=msize, kv=kv, mlp=part(mlp), head=part(head),
                n_heads=h, n_kv_heads=h_kv, hd=hd, d_ff=cfg.d_ff,
                vocab=cfg.vocab)


def tp_of(cfg, mesh):
    """The :class:`models.tp.TP` of this rank on ``mesh``'s model axis
    (its index there and the axis's group), None where the plan splits
    nothing (a model axis of 1, no mesh)."""
    from repro_torch.models.tp import TP
    if mesh is None or "model" not in axis_names(mesh) or \
            model_axis_size(mesh) == 1:
        return None
    plan = tp_plan(cfg, model_axis_size(mesh))
    if not plan.splits:
        return None
    from repro_torch.launch.mesh import axis_group
    group, index = axis_group(mesh, "model")
    return TP(plan, index, group)


def mesh_of(tensors):
    """The mesh of the first DTensor among ``tensors``, None without
    one."""
    return next((t.device_mesh for t in tensors if is_dtensor(t)), None)


def tp_local(kind: str, name: str, t: torch.Tensor, tp) -> torch.Tensor:
    """Parameter ``name`` of a block of ``kind`` (a DTensor in the
    gathered layout) as rank ``tp`` computes with it: its block
    (``models.tp.param_block``) where the plan splits its part, the KV
    heads the rank's query heads share where the plan computes them on
    each rank (taken from the whole ``wk``/``wv``, the gradient partial
    over the model axis), replicated elsewhere or without ``tp``
    (:func:`compute_tensor`); a tensor as it is."""
    from repro_torch.models.tp import param_block
    blk = None if tp is None else param_block(kind, name, tp.plan, tp.index)
    if blk is None or not is_dtensor(t):
        return compute_tensor(t)
    from torch.distributed.tensor import Replicate, Shard
    dim, start, size = blk
    if name.endswith(("wk", "wv")) and tp.plan.kv == "computed":
        return _Compute.apply(t, Replicate(), True).narrow(dim, start, size)
    out = _Compute.apply(t, Shard(dim), False)
    if out.shape[dim] != size:
        raise ValueError(f"{name}: this rank's block of {tuple(t.shape)} "
                         f"on the model axis has {out.shape[dim]} of dim "
                         f"{dim}, the plan {size}")
    return out


def vocab_local(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's vocab block of a gathered embedding (``dim`` 0) or
    head (``dim`` 1), in ``tp_local``'s gradient convention."""
    from torch.distributed.tensor import Shard
    return _Compute.apply(t, Shard(dim), False)


def local_block(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's block, in ``place``, of a tensor used in a computation
    split over the model axis: a DTensor is redistributed to ``place``
    (its gradient partial over the data axes, in ``place`` on the model
    axis); a whole tensor is sliced (its gradient then lies in this rank's
    block, the others' blocks zero)."""
    if is_dtensor(t):
        return t.redistribute(mesh, place).to_local(
            grad_placements=grad_placements(mesh, place))
    for name, p in zip(axis_names(mesh), place):
        if p.is_shard():
            n = axis_size(mesh, name)
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, mesh.get_local_rank(name) * size, size)
    return t


def make_gather_fn(mesh):
    """The ZeRO-3 hook for ``transformer.forward``: ``gather(module or
    parameter, hint)`` redistributes a module's parameters ({name:
    tensor}) or one parameter to :func:`drop_data`'s layout at the point
    of use (storage stays FSDP x TP), so only the layer being computed is
    resident gathered.  Tensors that are not DTensors come back as they
    are."""
    def one(t):
        return gathered_layout(t) if is_dtensor(t) else t

    def gather(obj, hint: str):
        if isinstance(obj, nn.Module):
            return {name: one(p) for name, p in obj.named_parameters()}
        return one(obj)
    return gather


def shard_params(params: nn.Module, mesh) -> nn.Module:
    """Store every parameter of an ``LM`` as a DTensor placed by
    :func:`tree_specs` (each rank keeps its block of the whole value it
    holds; no communication), in place."""
    specs = tree_specs(params, mesh)
    for name, p in list(params.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        mod._parameters[attr] = nn.Parameter(
            distribute(p, mesh, placements(specs[name], mesh)),
            requires_grad=p.requires_grad)
    return params


def param_mesh(params: nn.Module):
    """The mesh an LM's parameters are stored on (:func:`shard_params`),
    None for plain tensors."""
    p = next(params.parameters())
    return p.device_mesh if is_dtensor(p) else None


# The slot dim of each GQA cache leaf, which flash decoding splits over
# the model axis (the reference's shard_map body takes it so).
SLOT_DIMS = {"attn/k": 2, "attn/v": 2, "attn/pos": 1}


def shard_cache(cache: dict, mesh, cfg) -> dict:
    """This rank's block of a whole decode cache for flash decoding
    (``attention.gqa_decode(flash=True)``), each leaf placed by
    :func:`cache_tree_specs`: batch rows over the DP axes, a GQA cache's
    slots over the model axis.  The port's other decode paths do not
    split a cache over the model axis, so their leaves keep only the DP
    part of their specs.  Raises where a spec puts a GQA cache's model
    axis on a dim other than its slots."""
    msize = model_axis_size(mesh)

    def block(path, x, spec):
        slot = next((d for key, d in SLOT_DIMS.items()
                     if path.endswith("/" + key)), None)
        if slot is None:
            spec = _without(spec, ("model",))
        elif msize > 1 and spec[slot] != "model":
            raise ValueError(f"{path}: flash decoding splits the slots (dim "
                             f"{slot}) over the model axis, but the cache's "
                             f"spec is {spec}")
        return distribute(x, mesh, placements(spec, mesh)).to_local().clone()
    return walk(cache, block, cache_tree_specs(cache, mesh, cfg))
