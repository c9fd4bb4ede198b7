"""Training step: cross-entropy loss, gradients, microbatching and the
optimizer (the reference's ``train/train_step.py``).

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``.  With ``microbatches > 1`` the batch is cut along its leading
axis into that many microbatches, each one's gradient
(``torch.autograd.grad``, in the parameters' dtype) is added into float32
accumulators that start at zero, and the sums are divided by
``microbatches``: the reference's ``lax.scan`` order.  A batch holds
``tokens`` and ``labels`` int32[B, T] and may hold ``positions`` ([B, T],
or [3, B, T] for M-RoPE, then in one microbatch), ``embeds`` [B, T, D]
(the vision stub's input, read in place of the tokens' rows) and
``frames`` [B, S_enc, D] (Whisper's audio stub: ``transformer.encode``
runs over them, through the flash kernels where ``use_flash_kernel``,
and the decoder attends to its output).  The gradients are
kept by the reference's stacked leaves (``optimizer.py``), then
compressed (``compression``) and applied by AdamW, in place.

Departures, as in serving: ``TrainConfig.use_flash_kernel`` defaults to
True (the reference's to False, which trains through its plain
``attention_ref``), so on the card the forward runs the flash kernels and
the backward ``flash_attention_bwd``; the bf16 forward kernel rounds P to
bf16, which the reference's float32 path does not.

Sharded (the reference's ``--mesh DxM`` under GSPMD): a state whose
parameters are DTensors (:func:`shard_train_state`: parameters, μ, ν
and residuals stored by ``launch/sharding.py``'s specs on a ("data",
"model") ``DeviceMesh``, or ("pod", "data", "model") with the pod axis a
second data-parallel one) takes the sharded step.  Each microbatch (the
global batch cut as above) is split over the data-parallel axes by
``batch_spec``;
each rank computes its rows' loss term (the rows' summed log-likelihoods
over the microbatch's whole label count, so the ranks' terms sum to the
loss) with the parameters gathered at the point of use, one layer at a
time: by ``TrainConfig.gather_fn``, else by ``sharding.make_gather_fn``.
Over the "model" axis the layers compute by the plan (``models/tp.py``),
and where it splits the vocab the loss is vocab-parallel: the logits stay
each rank's vocab block, and log Z, the gold logit and smoothing's mean
logit are reduced over the axis (:func:`_vocab_parallel`).
Autograd reduce-scatters the gradients to the storage layout;
the step accumulates each rank's blocks, takes the global norm over the
mesh and updates the blocks in place.  Compression runs on the whole
leaf, gathered for it (``int8``'s blocks of 256 and ``delta``'s top-k run
across the layers, as on one device): a gather of every gradient and
residual leaf a step.  Within a mesh the ranks' answers are the same
values summed in other orders; on a 1x1 mesh they are the plain path's.
A batch whose arrays are DTensors on the state's mesh, stored by
``batch_spec`` (:func:`stored_rows`; the dry run's, ``launch/dryrun.py``),
is each rank's rows already: the rank cuts its own rows into the
microbatches (with one microbatch, the same rows as a whole batch's).

A TrainState is written to a checkpoint as the reference's tree
(:func:`checkpoint_tree`: the stacked parameter tree, ``opt.step``, μ, ν
and the residuals at the reference's tree paths), so each package resumes
the other's float32 checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding
from repro_torch.models import transformer
from repro_torch.models.transformer import is_stacked, stacked_leaves
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update, compress_tree,
                                         leaf_shape, zero_residuals)


class TrainState(NamedTuple):
    params: transformer.LM
    opt: AdamWState
    residuals: Optional[dict]      # gradient-compression error feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compression: str = "none"      # none | int8 | delta
    topk_frac: float = 0.01
    moe_aux_weight: float = 0.01
    moe_strategy: str = "sort"
    use_flash_kernel: bool = True
    label_smoothing: float = 0.0
    gather_fn: object = None       # ZeRO-3 per-layer weight gather hook


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             smoothing: float = 0.0, tp=None) -> tuple:
    """(the summed negative log-likelihood of the unmasked labels, their
    count).  With ``tp`` (``models/tp.py``) ``logits`` are the rank's vocab
    block: the vocab-parallel loss (:func:`_vocab_parallel`)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        mean_logit = torch.mean(logits, dim=-1) if smoothing else None
    else:
        logz, gold, mean_logit = _vocab_parallel(logits, safe, tp, smoothing)
    nll = logz - gold
    if smoothing:
        nll = (1 - smoothing) * nll + smoothing * (logz - mean_logit)
    return torch.sum(torch.where(mask, nll, 0.0)), torch.sum(mask)


def _vocab_parallel(logits: torch.Tensor, labels: torch.Tensor, tp,
                    smoothing: float) -> tuple:
    """(log Z, the gold logit, the mean logit or None) of the whole vocab
    from rank ``tp``'s block of the logits: the blocks' max reduced by max
    over the model axis (no gradient: log Z does not depend on it), their
    sums of exp(l - max), their gold logits (zero for labels outside the
    block) and, for smoothing, their sums of logits, each summed over the
    axis (``sum_replicated``)."""
    import torch.distributed as dist
    start, n = tp.plan.block(tp.plan.vocab, tp.index)
    m = torch.amax(logits.detach(), dim=-1)
    if tp.group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    logz = m + torch.log(tp.exit(torch.sum(torch.exp(
        logits - m[..., None]), dim=-1)))
    local = labels - start
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None]
                        )[..., 0]
    gold = tp.exit(torch.where(inside, gold, 0.0))
    mean = (tp.exit(torch.sum(logits, dim=-1)) / tp.plan.vocab
            if smoothing else None)
    return logz, gold, mean


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """logits f32[B, T, V]; labels int32[B, T] (−1 = masked)."""
    nll, count = _nll_sum(logits, labels, smoothing)
    return nll / torch.clamp(count, min=1)


def _logits(cfg, tcfg: TrainConfig, params, batch, gather_fn=None,
            gather_logits: bool = True, tp=None):
    gather_fn = gather_fn or tcfg.gather_fn
    enc_out = None
    if "frames" in batch:
        enc_out = transformer.encode(cfg, params, batch["frames"],
                                     use_kernel=tcfg.use_flash_kernel,
                                     gather_fn=gather_fn, tp=tp)
    return transformer.forward(
        cfg, params, batch["tokens"], positions=batch.get("positions"),
        embeds=batch.get("embeds"), use_kernel=tcfg.use_flash_kernel,
        moe_strategy=tcfg.moe_strategy, enc_out=enc_out,
        gather_fn=gather_fn, gather_logits=gather_logits, tp=tp)


def make_loss_fn(cfg, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss + aux weight * aux, (loss, aux))."""

    def loss_fn(params, batch):
        logits, aux = _logits(cfg, tcfg, params, batch)
        loss = cross_entropy(logits, batch["labels"], tcfg.label_smoothing)
        return loss + tcfg.moe_aux_weight * aux, (loss, aux)
    return loss_fn


def make_rank_loss_fn(cfg, tcfg: TrainConfig, mesh):
    """loss_fn(params, rows, split) -> (this rank's term of loss + aux
    weight * aux, (its term of the loss, aux)) for a state stored on
    ``mesh``: ``rows`` the rank's rows of a microbatch (its whole batch
    where ``split`` is False), the terms of the data axis's ranks summing
    to the microbatch's loss.  The parameters are gathered a layer at a
    time, by ``tcfg.gather_fn`` or else ``sharding.make_gather_fn``."""
    hook = tcfg.gather_fn or sharding.make_gather_fn(mesh)
    tp = sharding.tp_of(cfg, mesh)
    vtp = None if tp is None else tp.part("head")   # the logits' vocab block

    def loss_fn(params, batch, split: bool):
        with meshes.set_mesh(mesh, batch_split=split):
            logits, aux = _logits(cfg, tcfg, params, batch, hook,
                                  gather_logits=False, tp=tp)
        nll, count = _nll_sum(logits, batch["labels"], tcfg.label_smoothing,
                              vtp)
        dp = meshes.dp_size(mesh)
        if split:
            import torch.distributed as dist
            dist.all_reduce(count, group=meshes.dp_group(mesh))
            loss = nll / torch.clamp(count, min=1)
            total = loss + tcfg.moe_aux_weight * aux
        else:           # every data rank computes the whole batch's loss
            loss = nll / torch.clamp(count, min=1) / dp
            total = loss + tcfg.moe_aux_weight * aux / dp
        return total, (loss, aux)
    return loss_fn


def init_train_state(cfg, tcfg: TrainConfig,
                     gen: Optional[torch.Generator] = None, device=None
                     ) -> TrainState:
    """Parameters from ``transformer.init_params`` (``gen``, seed 0 when
    None, on ``device``, None = CUDA), now asking for gradients; AdamW's
    zero state; zero residuals when compressing."""
    params = transformer.init_params(cfg, gen, resolve_device(device))
    params.requires_grad_(True)
    residuals = (zero_residuals(params) if tcfg.compression != "none"
                 else None)
    return TrainState(params=params, opt=adamw_init(params),
                      residuals=residuals)


def _microbatches(batch: dict, n: int) -> list:
    """The batch cut along every array's leading axis, as the reference
    reshapes it (so M-RoPE's [3, B, T] positions take one microbatch)."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of {n} microbatches")
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    if n > 1 and any(sh[0] != b for sh in shapes.values()):
        raise ValueError(f"microbatches cut every batch array along its "
                         f"leading axis, which must be the batch's {b}; got "
                         f"{shapes}")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """``state`` (the same values on every rank) stored on ``mesh``:
    parameters by ``sharding.tree_specs`` (in place), μ, ν and residuals
    by their leaves' specs; each rank keeps its blocks."""
    specs = sharding.leaf_specs(state.params, mesh)
    sharding.shard_params(state.params, mesh)

    def put(tree):
        if tree is None:
            return None
        return {name: sharding.distribute(
            x, mesh, sharding.placements(specs[name], mesh))
            for name, x in tree.items()}
    return TrainState(params=state.params,
                      opt=AdamWState(step=state.opt.step,
                                     mu=put(state.opt.mu),
                                     nu=put(state.opt.nu)),
                      residuals=put(state.residuals))


def _rank_rows(batch: dict, mesh) -> tuple[dict, bool]:
    """(this rank's rows of a microbatch by ``batch_spec``, whether the
    batch was split); every array's leading axis is the batch's."""
    b = next(iter(batch.values())).shape[0]
    dp = meshes.dp_size(mesh)
    if sharding.batch_spec((b,), mesh)[0] is None:
        return batch, False
    if any(v.shape[0] != b for v in batch.values()):
        raise ValueError(f"a batch split over the data axis needs every "
                         f"array's leading axis to be the batch's {b}; got "
                         f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
    n, d = b // dp, meshes.dp_rank(mesh)
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}, True


def stored_rows(batch: dict, mesh) -> tuple[dict, bool]:
    """(this rank's rows of a batch stored by ``batch_spec`` as DTensors
    on ``mesh``, whether they are split over the data-parallel axes)."""
    if any(not sharding.is_dtensor(v) or v.device_mesh != mesh
           for v in batch.values()):
        raise ValueError("a stored batch holds DTensors on the state's "
                         "mesh, every array")
    b = next(iter(batch.values())).shape[0]
    split = sharding.batch_spec((b,), mesh)[0] is not None
    return {k: sharding.local(v) for k, v in batch.items()}, split


def global_norm_sharded(grads: dict, specs: dict, mesh) -> torch.Tensor:
    """The global norm of gradients held as this rank's blocks (``specs``
    each leaf's spec): each leaf's local sum of squares, summed over the
    mesh axes that shard it, then over the leaves in order."""
    import torch.distributed as dist
    names = list(grads)
    sums = torch.stack([torch.sum(torch.square(grads[n].float()))
                        for n in names])
    for dim, axis in enumerate(meshes.axis_names(mesh)):
        if mesh.size(dim) == 1:
            continue
        flags = [sharding.placements(specs[n], mesh)[dim].is_shard()
                 for n in names]
        if not any(flags):
            continue
        sharded = torch.tensor(flags, device=sums.device)
        part = torch.where(sharded, sums, 0.0)
        dist.all_reduce(part, group=mesh.get_group(axis))
        sums = torch.where(sharded, part, sums)
    total = sums[0]
    for x in sums[1:]:
        total = total + x
    return torch.sqrt(total.double()).float()


def _compress_sharded(grads: dict, residuals: dict, tcfg: TrainConfig,
                      specs: dict, mesh) -> tuple:
    """``compress_tree`` on whole leaves: each gradient block gathered
    with its residual, compressed as on one device, and cut back to this
    rank's blocks (the new residuals stored as before)."""
    from torch.distributed.tensor import DTensor
    whole = {n: DTensor.from_local(g, mesh, sharding.placements(
        specs[n], mesh)).full_tensor() for n, g in grads.items()}
    res = {n: sharding.full(r) for n, r in residuals.items()}
    out, new_res, wire = compress_tree(whole, res, tcfg.compression,
                                       tcfg.topk_frac)
    place = {n: sharding.placements(specs[n], mesh) for n in grads}
    return ({n: sharding.distribute(g, mesh, place[n]).to_local()
             for n, g in out.items()},
            {n: sharding.distribute(r, mesh, place[n])
             for n, r in new_res.items()}, wire)


def make_train_step(cfg, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``; a state stored on
    a mesh (:func:`shard_train_state`) takes the sharded step (module
    docstring)."""
    plain_loss = make_loss_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        mesh = sharding.param_mesh(params)
        if mesh is None:
            loss_fn = plain_loss
        else:
            rank_loss = make_rank_loss_fn(cfg, tcfg, mesh)
            if any(sharding.is_dtensor(v) for v in batch.values()):
                batch, split = stored_rows(batch, mesh)

                def loss_fn(params, mbatch):
                    return rank_loss(params, mbatch, split)
            else:
                def loss_fn(params, mbatch):
                    return rank_loss(params, *_rank_rows(mbatch, mesh))
        leaves = stacked_leaves(params)
        flat = [p for ps in leaves.values() for p in ps]
        dev = sharding.local(flat[0]).device
        grads = {name: torch.zeros(
            leaf_shape(name, [sharding.local(p) for p in ps]),
            dtype=torch.float32, device=dev) for name, ps in leaves.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for mbatch in _microbatches(batch, tcfg.microbatches):
            total, (loss, _) = loss_fn(params, mbatch)
            # A batch with embeds reads no embedding row, so an untied
            # embedding has no gradient: zero, as the reference's.
            got = iter(torch.autograd.grad(total, flat, allow_unused=True))
            with torch.no_grad():
                for name, ps in leaves.items():
                    acc = grads[name]
                    for row in (acc.unbind(0) if is_stacked(name)
                                else [acc]):
                        g = next(got)
                        if g is not None:
                            row.add_(sharding.local(g))
            loss_sum = loss_sum + loss.detach()
            del total, loss
        for g in grads.values():
            g.div_(tcfg.microbatches)
        if mesh is not None and meshes.dp_size(mesh) > 1:
            import torch.distributed as dist
            dist.all_reduce(loss_sum, group=meshes.dp_group(mesh))
        loss = loss_sum / tcfg.microbatches

        wire_bytes = torch.zeros((), dtype=torch.float32, device=dev)
        residuals = state.residuals
        gnorm = None
        if mesh is None:
            if tcfg.compression != "none":
                grads, residuals, wire_bytes = compress_tree(
                    grads, residuals, tcfg.compression, tcfg.topk_frac)
        else:
            specs = sharding.leaf_specs(params, mesh)
            if tcfg.compression != "none":
                grads, residuals, wire_bytes = _compress_sharded(
                    grads, residuals, tcfg, specs, mesh)
            gnorm = global_norm_sharded(grads, specs, mesh)
        params, opt, metrics = adamw_update(tcfg.adamw, state.opt, params,
                                            grads, gnorm)
        metrics.update({"loss": loss, "wire_bytes": wire_bytes})
        return TrainState(params, opt, residuals), metrics

    return train_step


# ---------------------------------------------------------------------------
# The reference's tree, for checkpoints and conversion.
# ---------------------------------------------------------------------------

def nest(flat: dict) -> dict:
    """{"units.b0_dense.attn.wq": x, ...} -> {"units": {"b0_dense":
    {"attn": {"wq": x}}}, ...}."""
    out: dict = {}
    for name, x in flat.items():
        node = out
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = x
    return out


def unnest(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nest` (empty dicts, the reference's
    non-parametric norms, have no leaves)."""
    out = {}
    for k in sorted(tree):
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(unnest(tree[k], name))
        else:
            out[name] = tree[k]
    return out


def stacked_params(params) -> dict:
    """{leaf name: the reference's array}: per-layer parameters stacked on
    a leading layer axis (a copy), the rest detached as they are; whole
    values where the parameters are stored sharded."""
    return {name: (torch.stack([sharding.full(p.detach()) for p in ps])
                   if is_stacked(name) else sharding.full(ps[0].detach()))
            for name, ps in stacked_leaves(params).items()}


def checkpoint_tree(state: TrainState) -> TrainState:
    """``state`` as the reference's TrainState tree: nested dicts of the
    stacked leaves (the port's NamedTuples carry the reference's field
    names, so the tree paths are the reference's), of whole tensors (a
    sharded state is gathered: every rank must call it)."""
    res = state.residuals

    def whole(tree):
        return nest({k: sharding.full(v) for k, v in tree.items()})
    return TrainState(
        params=nest(stacked_params(state.params)),
        opt=AdamWState(step=state.opt.step, mu=whole(state.opt.mu),
                       nu=whole(state.opt.nu)),
        residuals=None if res is None else whole(res))


def restore_tree(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` with every value taken from ``tree`` (a
    :func:`checkpoint_tree` of the same shapes, e.g. one read back from a
    checkpoint): parameters copied in place, row by row; a sharded
    state's values cut to this rank's blocks."""
    new = unnest(tree.params)
    with torch.no_grad():
        for name, ps in stacked_leaves(state.params).items():
            src = new[name]
            rows = src.unbind(0) if is_stacked(name) else [src]
            for p, row in zip(ps, rows):
                sharding.assign(p, row)
    dev = state.opt.step.device

    def like(old: dict, new: dict) -> dict:
        return {k: (sharding.distribute(v.to(dev), old[k].device_mesh,
                                        old[k].placements)
                    if sharding.is_dtensor(old[k]) else v)
                for k, v in new.items()}
    res = None if tree.residuals is None else like(state.residuals,
                                                   unnest(tree.residuals))
    return TrainState(
        params=state.params,
        opt=AdamWState(step=tree.opt.step.to(dev),
                       mu=like(state.opt.mu, unnest(tree.opt.mu)),
                       nu=like(state.opt.nu, unnest(tree.opt.nu))),
        residuals=res)
