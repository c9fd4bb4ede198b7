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
  * "a2a"    — the REX rehash made explicit over the ambient mesh's
    'model' axis (``launch/mesh.set_mesh``), the reference's ``shard_map``
    body.  EP mode (E % M == 0 and the rank's tokens divisible by M): each
    model rank takes its slice of its data row's tokens, routes the
    copies into fixed-capacity per-owner segments (``cap_seg``, the
    reference's, so the same copies are kept and dropped), ONE
    ``all_to_all`` each way over 'model' with the payloads in the model's
    dtype, the expert products in float32 on the rank's E / M experts (at
    most ``cap_loc`` rows an expert), and an ``all_gather`` of the data
    row.  TP mode (otherwise): the sort dispatch on the rank's slice of
    d_ff, then one sum over 'model'.  The expert weights come whole (each
    rank takes its block) or as DTensors in the gathered layout
    (``launch/sharding.make_gather_fn``).  Without an ambient mesh with a
    'model' axis it raises ``ValueError``, as the reference's does.
    Gradients flow through both modes (``launch/mesh.py``'s collectives).

Under a sharded train step each rank holds its share of a batch split
over the data axis (``launch/mesh.batch_group``).  The sort and one-hot
dispatches then decide capacity over the whole batch, as the reference's
do on its global arrays: the capacity is the whole batch's, and the kept
copies are those of a dispatch over every rank's routes (gathered; each
rank then computes its own kept copies).  The load-balancing loss is the
whole batch's (expert counts and probabilities summed over the data
axis), divided by the data axis's size, so that the ranks' terms sum to
it.  The a2a dispatch decides capacity per data row, as the reference's
``shard_map`` body does.

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

Under FakeTensorMode (the dry run, ``launch/dryrun.py``) a tensor has no
values, so every size the routes decide is taken at its bound
(``layers.is_fake``): the sort dispatch fills each expert's buffer with its C
rows (the reference's ``[E·C, D]`` buffers; ``ceil(C / ranks)`` rows on
each rank of a batch split over the data axis), and the a2a dispatch keeps
every copy and fills every received segment, spread evenly over the
rank's experts.  The dry run counts that work, an unlucky step's.  Real
tensors take the packed dispatch above.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import mesh as meshes
from repro_torch.models.layers import (MLP, _param, apply_mlp, dtype_of,
                                       init_mlp, is_fake, normal_)


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
    """Switch-style auxiliary loss (fraction routed × mean prob); over a
    batch split over the data axis, the whole batch's, divided by that
    axis's size (the module docstring)."""
    t = probs.shape[0]
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, top_e.reshape(-1).long(),
        torch.ones(top_e.numel(), dtype=torch.float32, device=probs.device))
    group = meshes.batch_group()
    if group is None:
        frac = counts / (t * top_e.shape[-1])
        mean_p = torch.mean(probs, dim=0)
        return n_experts * torch.sum(frac * mean_p)
    import torch.distributed as dist
    ranks = dist.get_world_size(group)
    dist.all_reduce(counts, group=group)
    frac = counts / (ranks * t * top_e.shape[-1])
    mean_p = meshes.sum_terms(torch.sum(probs, dim=0), group) / (ranks * t)
    return n_experts * torch.sum(frac * mean_p) / ranks


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


def moe_ffn(cfg, params: MoE, x: torch.Tensor, strategy: str = "sort",
            tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D] in x's dtype, aux_loss f32 scalar).
    ``tp`` (``models/tp.py``) splits the dense residual's d_ff; the expert
    products keep their layout under every strategy."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    group = meshes.batch_group()
    ranks = 1 if group is None else _group_size(group)
    cap = _capacity(cfg, b * t * ranks)
    top_e, top_p, aux = _route(cfg, params, xf)

    if strategy == "sort":
        y = _dispatch_sort(cfg, params, xf, top_e, top_p, cap, over=group)
    elif strategy == "onehot":
        y = _dispatch_onehot(cfg, params, xf, top_e, top_p, cap,
                             over=group)
    elif strategy == "a2a":
        y = _dispatch_a2a(cfg, params, xf, top_e, top_p)
    else:
        raise ValueError(strategy)

    if cfg.moe_dense_residual:
        y = y + apply_mlp(params.dense, xf, tp)
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
    if is_fake(sorted_owner):    # bincount's length is the values'
        counts = sorted_owner.new_zeros(n_groups).index_add_(
            0, sorted_owner, torch.ones_like(sorted_owner))
    else:
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
    each expert's number of them (host ints); ``cap`` each on fake
    tensors."""
    if is_fake(flat_e):
        return flat_e.new_empty(n_experts * cap), [cap] * n_experts
    order = _lexsort(-flat_p.detach(), flat_e)
    rank, counts = _group_ranks(flat_e[order], n_experts)
    return order[rank < cap], torch.clamp(counts, max=cap).tolist()


def _group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _gathered_routes(t: torch.Tensor, group) -> tuple:
    """(every rank's ``t`` concatenated in rank order, this rank's offset
    into it); no gradient."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(_group_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts), dist.get_rank(group) * t.shape[0]


def _dispatch_sort(cfg, params: MoE, xf, top_e, top_p, cap, over=None):
    """Sort-based delta dispatch (route_by_owner over expert keys).  The
    reference scatters the kept copies into [E·C, D] capacity buffers;
    here each expert's buffer is packed, its kept copies in rank order and
    no empty rows, so the memory follows the copies and not E·C.  ``over``
    a group whose ranks' rows make the batch: the kept copies are a
    dispatch's over all of them (module docstring)."""
    n, d = xf.shape
    flat_e = top_e.reshape(-1).long()                     # [N*K]
    flat_p = top_p.reshape(-1)
    token_of = torch.arange(n, device=xf.device).repeat_interleave(
        cfg.top_k)
    if over is None:
        kept, rows = _sorted_kept(flat_e, flat_p, cfg.n_experts, cap)
    else:
        all_e, lo = _gathered_routes(flat_e, over)
        all_p, _ = _gathered_routes(flat_p, over)
        if is_fake(flat_e):       # this rank's share of each full buffer
            share = -(-cap // _group_size(over))
            kept = flat_e.new_empty(cfg.n_experts * share)
            rows = [share] * cfg.n_experts
        else:
            kept = _sorted_kept(all_e, all_p, cfg.n_experts, cap)[0]
            kept = kept[(kept >= lo) & (kept < lo + flat_e.numel())] - lo
            rows = torch.bincount(flat_e[kept],
                                  minlength=cfg.n_experts).tolist()
    out = _expert_ffn(params, xf[token_of[kept]].float(), rows)
    contrib = out * flat_p[kept][:, None]
    return torch.zeros((n, d), dtype=torch.float32,
                       device=xf.device).index_add(0, token_of[kept],
                                                   contrib)


def _dispatch_onehot(cfg, params: MoE, xf, top_e, top_p, cap, over=None):
    """One-hot einsum dispatch (dense masks; Switch/GShard style).
    ``over``: positions counted over the group's whole batch, in rank
    order."""
    n, _ = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    # Position of each (token, k) copy within its expert, by cumsum.
    onehot = F.one_hot(top_e.long(), e).float()           # [N, K, E]
    pos_in_e = (torch.cumsum(onehot.reshape(n * k, e), dim=0) - 1
                ).reshape(n, k, e)
    if over is not None:     # the copies of the ranks before this one
        all_e, lo = _gathered_routes(top_e.reshape(-1).long(), over)
        before = torch.bincount(all_e[:lo], minlength=e).float()
        pos_in_e = pos_in_e + before
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


class _Experts:
    """Expert weights as ``_expert_ffn`` reads them (a rank's block)."""

    def __init__(self, w_gate, w_up, w_down):
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def _ceil8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _dispatch_a2a(cfg, params: MoE, xf, top_e, top_p):
    """The rehash dispatch over the ambient mesh's 'model' axis (module
    docstring); xf [n, D] is this rank's data row of the tokens, and so
    is the float32 output."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes.get_mesh()
    if mesh is None or "model" not in meshes.axis_names(mesh):
        raise ValueError(
            "a2a MoE dispatch needs an ambient mesh with a 'model' axis "
            "(launch.mesh.set_mesh) — use strategy='sort' otherwise")
    from repro_torch.launch.sharding import local_block
    msize = meshes.model_axis_size(mesh)
    group, m = meshes.axis_group(mesh, "model")
    e, k = cfg.n_experts, cfg.top_k
    n, d = xf.shape
    ep_mode = (e % msize == 0) and (n % msize == 0)
    model_dim = meshes.axis_names(mesh).index("model")

    def block(w, dim):
        place = [Replicate()] * mesh.ndim
        place[model_dim] = Shard(dim)
        return local_block(w, mesh, place)

    if not ep_mode:
        # TP experts: local dispatch on the rank's slice of d_ff, one sum.
        experts = _Experts(block(params.w_gate, 2), block(params.w_up, 2),
                           block(params.w_down, 1))
        y = _dispatch_sort(cfg, experts, meshes.to_replicated(xf, group),
                           top_e, meshes.to_replicated(top_p, group),
                           _capacity(cfg, n))
        return meshes.sum_replicated(y, group)

    experts = _Experts(block(params.w_gate, 0), block(params.w_up, 0),
                       block(params.w_down, 0))
    e_per = e // msize
    n_sub = n // msize
    # Each model rank dispatches its slice of the data row's tokens.
    xs = meshes.split_rows(xf, group, m, msize)
    ps = meshes.split_rows(top_p, group, m, msize)
    es = top_e[m * n_sub:(m + 1) * n_sub]
    copies = n_sub * k
    flat_e = es.reshape(copies).long()
    flat_p = ps.reshape(copies)
    token_of = torch.arange(n_sub, device=xf.device).repeat_interleave(k)
    owner = flat_e // e_per
    cap_seg = _ceil8(int(cfg.capacity_factor * copies / msize))
    rank = _rank_in_group(owner, msize).long()
    keep = rank < cap_seg
    slot = owner * cap_seg + rank
    if is_fake(keep):             # every copy kept
        kept = torch.arange(copies, device=xf.device)
    else:
        kept = torch.nonzero(keep).reshape(-1)
    # Payloads travel in the model's dtype; the experts compute in float32.
    wire_dt = xs.dtype
    send_tok = xs.new_zeros((msize * cap_seg, d)).index_copy(
        0, slot[kept], xs[token_of[kept]])
    send_e = torch.full((msize * cap_seg,), -1, dtype=torch.long,
                        device=xf.device).index_copy(0, slot[kept],
                                                     flat_e[kept])
    # THE rehash: one all_to_all each way over 'model'.
    recv_tok = meshes.all_to_all(send_tok, group)
    recv_e = meshes.all_to_all(send_e, group)
    # Group the received rows by local expert (at most cap_loc each).
    le = torch.where(recv_e >= 0, recv_e - m * e_per, e_per)
    cap_loc = max(8, (msize * cap_seg // e_per) * 2)
    rank2 = _rank_in_group(le, e_per + 1).long()
    keep2 = (le < e_per) & (rank2 < cap_loc)
    order = _lexsort(rank2, le)
    if is_fake(le):       # every received row an expert's, spread evenly
        n_rows = order.numel()
        counts = [min(cap_loc, n_rows // e_per + (i < n_rows % e_per))
                  for i in range(e_per)]
        rows_in = order[:sum(counts)]
    else:
        rows_in = order[keep2[order]]      # kept rows, by expert then rank
        counts = torch.bincount(le[rows_in], minlength=e_per).tolist()
    out = _expert_ffn(experts, recv_tok[rows_in].float(), counts)
    out_rows = recv_tok.new_zeros((msize * cap_seg, d)).index_copy(
        0, rows_in, out.to(wire_dt))
    back = meshes.all_to_all(out_rows, group)
    got = back[slot[kept]]
    y_sub = torch.zeros((n_sub, d), dtype=torch.float32,
                        device=xf.device).index_add(
        0, token_of[kept], got.float() * flat_p[kept][:, None])
    # Reassemble the data row in the wire dtype.
    return meshes.gather_rows(y_sub.to(wire_dt), group, m, msize).float()
