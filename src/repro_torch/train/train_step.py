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
bf16, which the reference's float32 path does not.  ``gather_fn`` (the
ZeRO-3 hook) and multi-device meshes wait for ``launch/sharding.py``.

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
from repro_torch.models import transformer
from repro_torch.models.attention import _not_ported
from repro_torch.models.transformer import is_stacked, stacked_leaves
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update, compress_tree,
                                         leaf_shape, zero_residuals)

SHARDING_SLICE = "slice 9h (sharding.py)"


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
    use_flash_kernel: bool = True
    label_smoothing: float = 0.0
    gather_fn: object = None       # ZeRO-3 per-layer weight gather hook


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """logits f32[B, T, V]; labels int32[B, T] (−1 = masked)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = logz - gold
    if smoothing:
        mean_logit = torch.mean(logits, dim=-1)
        nll = (1 - smoothing) * nll + smoothing * (logz - mean_logit)
    return torch.sum(torch.where(mask, nll, 0.0)) / torch.clamp(
        torch.sum(mask), min=1)


def _check_tcfg(tcfg: TrainConfig) -> None:
    if tcfg.gather_fn is not None:
        raise _not_ported("gather_fn (ZeRO-3 per-layer weight gathers)",
                          SHARDING_SLICE)


def make_loss_fn(cfg, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss + aux weight * aux, (loss, aux))."""
    _check_tcfg(tcfg)

    def loss_fn(params, batch):
        enc_out = None
        if "frames" in batch:
            enc_out = transformer.encode(cfg, params, batch["frames"],
                                         use_kernel=tcfg.use_flash_kernel)
        logits, aux = transformer.forward(
            cfg, params, batch["tokens"], positions=batch.get("positions"),
            embeds=batch.get("embeds"), use_kernel=tcfg.use_flash_kernel,
            enc_out=enc_out)
        loss = cross_entropy(logits, batch["labels"], tcfg.label_smoothing)
        return loss + tcfg.moe_aux_weight * aux, (loss, aux)
    return loss_fn


def init_train_state(cfg, tcfg: TrainConfig,
                     gen: Optional[torch.Generator] = None, device=None
                     ) -> TrainState:
    """Parameters from ``transformer.init_params`` (``gen``, seed 0 when
    None, on ``device``, None = CUDA), now asking for gradients; AdamW's
    zero state; zero residuals when compressing."""
    _check_tcfg(tcfg)
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


def make_train_step(cfg, tcfg: TrainConfig):
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = stacked_leaves(params)
        flat = [p for ps in leaves.values() for p in ps]
        dev = flat[0].device
        grads = {name: torch.zeros(leaf_shape(name, ps), dtype=torch.float32,
                                   device=dev)
                 for name, ps in leaves.items()}
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
                            row.add_(g)
            loss_sum = loss_sum + loss.detach()
            del total, loss
        for g in grads.values():
            g.div_(tcfg.microbatches)
        loss = loss_sum / tcfg.microbatches

        wire_bytes = torch.zeros((), dtype=torch.float32, device=dev)
        residuals = state.residuals
        if tcfg.compression != "none":
            grads, residuals, wire_bytes = compress_tree(
                grads, residuals, tcfg.compression, tcfg.topk_frac)
        params, opt, metrics = adamw_update(tcfg.adamw, state.opt, params,
                                            grads)
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
    a leading layer axis (a copy), the rest detached as they are."""
    return {name: (torch.stack([p.detach() for p in ps]) if is_stacked(name)
                   else ps[0].detach())
            for name, ps in stacked_leaves(params).items()}


def checkpoint_tree(state: TrainState) -> TrainState:
    """``state`` as the reference's TrainState tree: nested dicts of the
    stacked leaves (the port's NamedTuples carry the reference's field
    names, so the tree paths are the reference's)."""
    res = state.residuals
    return TrainState(
        params=nest(stacked_params(state.params)),
        opt=AdamWState(step=state.opt.step, mu=nest(state.opt.mu),
                       nu=nest(state.opt.nu)),
        residuals=None if res is None else nest(res))


def restore_tree(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` with every value taken from ``tree`` (a
    :func:`checkpoint_tree` of the same shapes, e.g. one read back from a
    checkpoint): parameters copied in place, row by row."""
    new = unnest(tree.params)
    with torch.no_grad():
        for name, ps in stacked_leaves(state.params).items():
            src = new[name]
            rows = src.unbind(0) if is_stacked(name) else [src]
            for p, row in zip(ps, rows):
                p.copy_(row)
    res = None if tree.residuals is None else unnest(tree.residuals)
    dev = state.opt.step.device
    return TrainState(
        params=state.params,
        opt=AdamWState(step=tree.opt.step.to(dev),
                       mu=unnest(tree.opt.mu), nu=unnest(tree.opt.nu)),
        residuals=res)
