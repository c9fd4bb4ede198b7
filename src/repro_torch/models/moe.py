"""Mixture-of-Experts FFN with REX-style delta dispatch (the reference's
``models/moe.py``).

Expert dispatch is the paper's rehash: each token's routed copy is a
*delta* ``(key=expert, payload=activation)``; dispatch groups the deltas
by owner into fixed-capacity per-expert buffers, the experts apply them,
and the combine scatters the results back weighted by router probability.
Past capacity the lowest-priority copies are dropped (the delta-buffer
overflow policy, with the router probability as the priority).

Dispatch strategies, selected by ``strategy``:
  * "sort"   — rank in group by (expert, −probability), the kept copies
    into per-expert capacity buffers, the expert products, combine.
  * "onehot" — dispatch and combine as one-hot einsums (dense [T, E, C]
    masks, capacity by token order).
  * "a2a"    — the reference's ``shard_map`` dispatch over a 'model' mesh
    axis; raises ``NotImplementedError`` naming ROADMAP slice 9h
    (``launch/sharding.py``).

Order of ties: the reference's ``jax.lax.top_k`` takes the lower index
among equal probabilities and its ``jnp.lexsort`` is stable; ``torch.topk``
promises neither, so top-k is a stable descending sort and the lexsort two
stable sorts (by −p, then by expert).  The sort runs on detached values
(the reference's ``stop_gradient``): the router's gradient flows through
the combine's probabilities.

The expert products are the reference's: float32 activations times the
experts' weights, in float32.  They run an expert at a time, each weight
upcast on its own (a float32 copy of a whole ``[E, D, F]`` tensor is
17.85 GB at arctic's width).  The sort dispatch packs each expert's
capacity buffer: its kept copies, without the empty rows (zero, and so
are their outputs), so an expert with no copy costs nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import _not_ported
from repro_torch.models.layers import (MLP, _param, apply_mlp, dtype_of,
                                       init_mlp, normal_)

A2A_SLICE = "slice 9h (sharding.py)"


class MoE(nn.Module):
    """router f32 [D, E]; w_gate, w_up [E, D, F] and w_down [E, F, D] in
    the config dtype; ``dense``, arctic's parallel SwiGLU, where the config
    sets ``moe_dense_residual``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = dtype_of(cfg.dtype)
        self.router = _param(d, e, dtype=torch.float32, device=device)
        self.w_gate = _param(e, d, f, dtype=dt, device=device)
        self.w_up = _param(e, d, f, dtype=dt, device=device)
        self.w_down = _param(e, f, d, dtype=dt, device=device)
        if cfg.moe_dense_residual:
            self.dense = MLP(d, f, dt, device)


def init_moe(moe: MoE, cfg, gen: torch.Generator) -> None:
    """The reference's scales: router and the input-side weights d^-1/2,
    w_down f^-1/2, drawn an expert at a time (no float32 temporary of a
    whole expert tensor)."""
    s_in, s_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
    normal_(moe.router, s_in, gen)
    for w, s in ((moe.w_gate, s_in), (moe.w_up, s_in), (moe.w_down, s_out)):
        for e in range(w.shape[0]):
            normal_(w[e], s, gen)
    if cfg.moe_dense_residual:
        init_mlp(moe.dense, gen)


def _capacity(cfg, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, params: MoE, xf: torch.Tensor):
    """Router: top-k expert choices + normalized probs per token."""
    logits = xf.float() @ params.router                   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, cfg.top_k)               # [T, K]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    aux = _load_balance_loss(probs, top_e, cfg.n_experts)
    return top_e.to(torch.int32), top_p, aux


def _load_balance_loss(probs, top_e, n_experts):
    """Switch-style auxiliary loss (fraction routed × mean prob)."""
    t = probs.shape[0]
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, top_e.reshape(-1).long(),
        torch.ones(top_e.numel(), dtype=torch.float32, device=probs.device))
    frac = counts / (t * top_e.shape[-1])
    mean_p = torch.mean(probs, dim=0)
    return n_experts * torch.sum(frac * mean_p)


def _expert_ffn(params: MoE, buf: torch.Tensor, rows) -> torch.Tensor:
    """SwiGLU of each expert over its rows: buf f32[sum(rows), D], expert
    e's rows the e-th block of ``rows[e]`` (host ints) -> f32[sum(rows),
    D] in the same order."""
    outs, start = [], 0
    for e, r in enumerate(rows):
        if r:
            xe = buf[start:start + r]
            gate = F.silu(xe @ params.w_gate[e].float())
            up = xe @ params.w_up[e].float()
            outs.append((gate * up) @ params.w_down[e].float())
        start += r
    if not outs:
        return buf.new_zeros((0, params.w_down.shape[-1]))
    return torch.cat(outs)


def moe_ffn(cfg, params: MoE, x: torch.Tensor, strategy: str = "sort"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D] in x's dtype, aux_loss f32 scalar)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    cap = _capacity(cfg, b * t)
    top_e, top_p, aux = _route(cfg, params, xf)

    if strategy == "sort":
        y = _dispatch_sort(cfg, params, xf, top_e, top_p, cap)
    elif strategy == "onehot":
        y = _dispatch_onehot(cfg, params, xf, top_e, top_p, cap)
    elif strategy == "a2a":
        raise _not_ported("MoE strategy 'a2a' (all_to_all over a 'model' "
                          "mesh axis)", A2A_SLICE)
    else:
        raise ValueError(strategy)

    if cfg.moe_dense_residual:
        y = y + apply_mlp(params.dense, xf)
    return y.reshape(b, t, d).to(x.dtype), aux


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))``: the order by ``major``, then
    ``minor``, then index, from two stable sorts."""
    o1 = torch.sort(minor, stable=True).indices
    o2 = torch.sort(major[o1], stable=True).indices
    return o1[o2]


def _group_ranks(sorted_owner: torch.Tensor, n_groups: int):
    """(each element's rank within its group, the groups' sizes) for
    sorted owners (int64, in [0, n_groups))."""
    counts = torch.bincount(sorted_owner, minlength=n_groups)
    pos = torch.arange(sorted_owner.numel(), device=sorted_owner.device)
    return pos - (torch.cumsum(counts, 0) - counts)[sorted_owner], counts


def _rank_in_group(owner: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Stable rank of each element within its owner group (the
    route_by_owner construction from core/delta.py)."""
    owner = owner.long()
    order = torch.sort(owner, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = _group_ranks(owner[order], n_groups)[0]
    return rank.to(torch.int32)


def _sorted_kept(flat_e, flat_p, n_experts: int, cap: int):
    """The copies that a capacity-``cap`` dispatch keeps, as indices into
    the flat copies ordered by expert, then rank (high probability first,
    so the low-probability copies overflow; ties to the earlier copy), and
    each expert's number of them (host ints)."""
    order = _lexsort(-flat_p.detach(), flat_e)
    rank, counts = _group_ranks(flat_e[order], n_experts)
    return order[rank < cap], torch.clamp(counts, max=cap).tolist()


def _dispatch_sort(cfg, params: MoE, xf, top_e, top_p, cap):
    """Sort-based delta dispatch (route_by_owner over expert keys).  The
    reference scatters the kept copies into [E·C, D] capacity buffers;
    here each expert's buffer is packed, its kept copies in rank order and
    no empty rows, so the memory follows the copies and not E·C."""
    n, d = xf.shape
    flat_e = top_e.reshape(-1).long()                     # [N*K]
    flat_p = top_p.reshape(-1)
    token_of = torch.arange(n, device=xf.device).repeat_interleave(
        cfg.top_k)
    kept, rows = _sorted_kept(flat_e, flat_p, cfg.n_experts, cap)
    out = _expert_ffn(params, xf[token_of[kept]].float(), rows)
    contrib = out * flat_p[kept][:, None]
    return torch.zeros((n, d), dtype=torch.float32,
                       device=xf.device).index_add(0, token_of[kept],
                                                   contrib)


def _dispatch_onehot(cfg, params: MoE, xf, top_e, top_p, cap):
    """One-hot einsum dispatch (dense masks; Switch/GShard style)."""
    n, _ = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    # Position of each (token, k) copy within its expert, by cumsum.
    onehot = F.one_hot(top_e.long(), e).float()           # [N, K, E]
    pos_in_e = (torch.cumsum(onehot.reshape(n * k, e), dim=0) - 1
                ).reshape(n, k, e)
    pos = torch.sum(pos_in_e * onehot, dim=-1).to(torch.int32)   # [N, K]
    keep = pos < cap
    disp = ((onehot * keep[..., None])[..., None]
            * F.one_hot(torch.where(keep, pos, 0).long(), cap
                        ).float()[..., None, :])          # [N, K, E, C]
    disp = torch.sum(disp, dim=1)                         # [N, E, C]
    buf = torch.einsum("nec,nd->ecd", disp, xf.float())
    out_buf = _expert_ffn(params, buf.reshape(e * cap, -1),
                          [cap] * e).reshape(buf.shape)
    comb = disp * torch.sum(onehot * top_p[..., None], dim=1)[:, :, None]
    return torch.einsum("nec,ecd->nd", comb, out_buf)
