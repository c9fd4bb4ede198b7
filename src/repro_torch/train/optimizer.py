"""AdamW, its schedule, and gradient compression with error feedback (the
reference's ``train/optimizer.py``).

Two gradient compressors for the data-parallel reduction, both with
**error feedback** (the residual not transmitted this step is carried and
added to the next step's gradient, so no information is lost for good, as
REX keeps un-propagated Δ mass in operator state):

  * ``int8``  — per-block scale quantization: 4× fewer bytes on the wire.
  * ``delta`` — REX's idea applied to SGD: ship only the top-|Δ| gradient
    components as (index, value) deltas, the gradient's Δᵢ set.

The reference's trees become dicts keyed by the reference's leaf names
(``models.transformer.stacked_leaves``), in its flatten order.  A leaf of
the stacked unit has the reference's stacked shape ``(n_units, ...)``
(a tail layer's leaf its own shape): μ, ν, residuals and gradients are
kept so, and the parameters are the port's per-layer tensors.  Two things
are decided on the stacked leaf, as the reference decides them: weight
decay applies to leaves of two or more dimensions, which includes the
per-layer norm scales (``(U, D)``) and RG-LRU's ``lam`` (``(U, R)``) and
excludes ``final_norm``'s and the tail's 1-D leaves; and compression runs
over the whole stacked leaf (the layer-ordered concatenation of its
parameters): one top-k and one run of 256-value blocks across the
layers.

Departure: :func:`adamw_update` updates the parameters, μ and ν in place
(the reference returns new arrays); the state it returns shares them.
The arithmetic is the reference's, op for op, in float32, with the
parameters rounded back to their dtype (no float32 master copy).  Stored
sharded (DTensors, ``launch/sharding.py``), the parameters, μ and ν are
updated block by block on each rank's own blocks, with the gradients'
blocks and a global norm the caller computed over the mesh
(``train_step.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.launch.sharding import local
from repro_torch.models.transformer import is_stacked, stacked_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32[]
    mu: dict               # leaf name -> float32, the stacked leaf's shape
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def leaf_shape(name: str, params: list) -> tuple:
    """The reference's shape of leaf ``name`` made of ``params`` (an item
    of ``stacked_leaves``)."""
    if is_stacked(name):
        return (len(params), *params[0].shape)
    return tuple(params[0].shape)


def _zeros(params) -> dict:
    dev = next(params.parameters()).device
    return {name: torch.zeros(leaf_shape(name, ps), dtype=torch.float32,
                              device=dev)
            for name, ps in stacked_leaves(params).items()}


def adamw_init(params) -> AdamWState:
    dev = next(params.parameters()).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros(params), nu=_zeros(params))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar on ``like``'s device, so that
    ``x / t`` rounds once (``float / tensor`` in torch multiplies by a
    reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA takes it (torch's
    vectorised CPU sqrt can be an ulp off): in float64, rounded once."""
    return torch.sqrt(x.double()).float()


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine from 1 to 0.1 of ``cfg.lr``;
    float32[] from an int32[] step."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves, in order, of each leaf's sum of
    squares in float32."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return _sqrt(total)


def _rows(t: torch.Tensor, stacked: bool) -> list:
    t = local(t)
    return list(t.unbind(0)) if stacked else [t]


def adamw_update(cfg: AdamWConfig, state: AdamWState, params, grads: dict,
                 gnorm: torch.Tensor = None) -> tuple:
    """One AdamW step with global-norm clipping: ``params`` an LM,
    ``grads`` {leaf name: stacked gradient} (this rank's blocks where the
    state is sharded, with ``gnorm`` the global norm).  Returns (params,
    state, metrics {grad_norm, lr}), params, μ and ν updated in place."""
    if gnorm is None:
        gnorm = global_norm(grads)
    one = _f32(1.0, gnorm)
    scale = torch.minimum(one, _f32(cfg.clip_norm, gnorm) /
                          torch.maximum(gnorm, _f32(1e-9, gnorm)))
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, gnorm), step.float())
    b2c = 1.0 - torch.pow(_f32(cfg.b2, gnorm), step.float())
    with torch.no_grad():
        for name, ps in stacked_leaves(params).items():
            stacked = is_stacked(name)
            decay = len(leaf_shape(name, ps)) >= 2
            for p, g, m, v in zip(ps, _rows(grads[name], stacked),
                                  _rows(state.mu[name], stacked),
                                  _rows(state.nu[name], stacked)):
                p = local(p)
                g = g.float() * scale
                m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
                v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
                delta = (m / b1c) / (_sqrt(v / b2c) + cfg.eps)
                if decay:        # decoupled weight decay on matrices only
                    delta = delta + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression with error feedback.
# ---------------------------------------------------------------------------

BLOCK = 256


def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: (q int8[N/BLOCK, BLOCK], scale
    float32[N/BLOCK]), N padded with zeros to a multiple of BLOCK."""
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK).float()
    scale = torch.amax(blocks.abs(), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None]
                    ).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def _bytes(n: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(n), dtype=torch.float32, device=like.device)


def ef_int8(g: torch.Tensor, residual: torch.Tensor) -> tuple:
    """Error-feedback int8: (g_hat, new residual, wire bytes)."""
    target = g.float() + residual
    q, scale = int8_compress(target)
    g_hat = int8_decompress(q, scale, g.shape)
    return g_hat, target - g_hat, _bytes(q.numel() + scale.numel() * 4, g)


def ef_topk_delta(g: torch.Tensor, residual: torch.Tensor, k: int) -> tuple:
    """REX-delta compression: ship only the k largest-|·| components as
    (index, value) deltas; the rest stays in the residual.  Returns
    (g_hat dense, new residual, wire bytes = 8k)."""
    target = (g.float() + residual).reshape(-1)
    k = min(k, target.shape[0])
    idx = torch.topk(target.abs(), k).indices
    g_hat = torch.zeros_like(target)
    g_hat[idx] = target[idx]
    g_hat = g_hat.reshape(g.shape)
    return g_hat, target.reshape(g.shape) - g_hat, _bytes(8.0 * k, g)


def compress_tree(grads: dict, residuals: dict, method: str = "int8",
                  topk_frac: float = 0.01) -> tuple:
    """A compressor leaf by leaf, over the stacked leaves: (grads_hat,
    residuals, total wire bytes).  ``none`` passes through at 4·N bytes,
    the uncompressed float32 wire cost."""
    outs, new_res = {}, {}
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(grads.values())).device)
    for name, g in grads.items():
        r = residuals[name]
        if method == "none":
            gh, nr, b = g, r, _bytes(4.0 * g.numel(), g)
        elif method == "int8":
            gh, nr, b = ef_int8(g, r)
        elif method == "delta":
            gh, nr, b = ef_topk_delta(g, r, max(1, int(g.numel()
                                                       * topk_frac)))
        else:
            raise ValueError(method)
        outs[name], new_res[name] = gh, nr
        total = total + b
    return outs, new_res, total


def zero_residuals(params) -> dict:
    """Float32 zeros of every stacked leaf's shape."""
    return _zeros(params)
