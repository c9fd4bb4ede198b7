"""Tensor-parallel compute over the "model" axis: each rank's block of a
layer's products (the reference's GSPMD partitioning of its ``drop_data``
layout under ``jax.jit``: column-parallel products in, row-parallel out).

The plan (:class:`Plan`, made by ``launch/sharding.tp_plan`` from the
specs) says, for a config and a model axis of M ranks, which parts split:

* ``attention`` (the GQA kinds: ``"dense"``, ``"moe"``, ``"enc"``,
  ``"dec_cross"`` with its cross-attention, ``"attn_local"``): by whole
  heads where M divides n_heads.  Rank r takes the query heads [r·H/M,
  (r+1)·H/M): a block of ``wq``'s columns and of ``wo``'s rows.  ``kv``:
  ``"split"`` where M divides n_kv_heads (a block of ``wk``/``wv``'s
  columns), ``"computed"`` where the rank's query heads share one KV head,
  ``(r·H/M) // (H/H_kv)``, which the rank computes from the whole
  ``wk``/``wv`` (several ranks compute it).  Elsewhere (M ∤ n_heads, or a
  rank's heads straddling two groups) the attention stays whole on every
  rank: ``"replicated"``.
* ``mlp``: the SwiGLU's d_ff in blocks (``w_gate``/``w_up`` columns,
  ``w_down`` rows), MoE's dense residual included.
* ``head``: the vocab in blocks (the head's columns: ``lm_head``'s, or the
  tied embedding's rows), and the embedding lookup of the rows the rank
  holds.

A split part's input enters through :meth:`TP.enter` (``to_replicated``:
the identity forward, the gradients summed over the model axis) and its
output leaves through :meth:`TP.exit` (``sum_replicated``: the sum over
the model axis, the identity backward).  A :class:`TP` without a group is
rank ``index`` alone in one process: both are the identity, and a split
function returns that rank's partial.  :func:`rank_params` cuts a rank's
blocks from whole tensors (:func:`param_block`, which
``launch/sharding.tp_local`` also follows on DTensors), and
:func:`split_layer` runs a layer as M ranks would, their partials summed in
rank order: the tests and the card's ``tp_layer`` phase run the code the
ranks run.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.launch import mesh as meshes

TP_KINDS = ("dense", "moe", "enc", "dec_cross", "attn_local")   # GQA kinds


class Plan(NamedTuple):
    """Which parts of a config's layers split over a model axis of
    ``size`` ranks (module docstring), with the sizes they split."""
    size: int
    kv: str               # "split" | "computed" | "replicated"
    mlp: str              # "split" | "replicated"
    head: str             # "split" | "replicated"
    n_heads: int
    n_kv_heads: int
    hd: int
    d_ff: int
    vocab: int

    @property
    def attention(self) -> str:
        """"split" where the rank computes its query heads (and the KV
        heads they need), else "replicated"."""
        return "replicated" if self.kv == "replicated" else "split"

    @property
    def splits(self) -> bool:
        return "split" in (self.attention, self.mlp, self.head)

    def record(self) -> dict:
        """{part: "split" or "replicated"} (the dry run's ``"tp"``)."""
        return {"attention": self.attention,
                "kv": "replicated" if self.kv == "computed" else self.kv,
                "mlp": self.mlp, "head": self.head}

    def q_heads(self, index: int) -> tuple[int, int]:
        """(first query head, count) of rank ``index``."""
        n = self.n_heads // self.size
        return index * n, n

    def kv_heads(self, index: int) -> tuple[int, int]:
        """(first KV head, count) that rank ``index`` computes."""
        if self.kv == "split":
            n = self.n_kv_heads // self.size
            return index * n, n
        group = self.n_heads // self.n_kv_heads
        return self.q_heads(index)[0] // group, 1

    def block(self, n: int, index: int) -> tuple[int, int]:
        """(start, length) of rank ``index``'s block of ``n``."""
        return index * (n // self.size), n // self.size


class TP(NamedTuple):
    """Rank ``index`` of a model axis computing by ``plan``; ``group`` is
    the axis's process group, None for the rank alone in one process (the
    collectives are then the identity)."""
    plan: Plan
    index: int
    group: object = None

    def part(self, name: str) -> Optional["TP"]:
        """This TP where the plan splits ``name``, else None."""
        return self if getattr(self.plan, name) == "split" else None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into column-parallel products: backward, the gradients summed
        over the model axis."""
        if self.group is None:
            return x
        return meshes.to_replicated(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Out of row-parallel products: the partials summed over the
        model axis."""
        if self.group is None:
            return y
        return meshes.sum_replicated(y, self.group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order
        (backward: this rank's part)."""
        if self.group is None:
            raise ValueError("gathering over the model axis needs its "
                             "process group")
        out = meshes.gather_rows(t.movedim(dim, 0), self.group, self.index,
                                 self.plan.size)
        return out.movedim(0, dim)

    def gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """The whole KV heads [B, H_kv, ...] from every rank's local KV
        heads (dim 1); where ranks compute the same head, its first
        rank's."""
        got = self.gather(t, 1)
        if self.plan.kv == "split":
            return got
        starts = [self.plan.kv_heads(r)[0] for r in range(self.plan.size)]
        first = [starts.index(j) for j in range(self.plan.n_kv_heads)]
        return got[:, first]


def param_block(kind: str, name: str, plan: Plan, index: int
                ) -> Optional[tuple[int, int, int]]:
    """(dim, start, length) of rank ``index``'s block of parameter
    ``name`` of a block of ``kind`` (``attn.wq``, ``mlp.w_down``,
    ``ffn.dense.w_up``, ...), None where the rank uses it whole."""
    *path, leaf = name.split(".")
    owner = path[-1] if path else ""
    hd = plan.hd
    if owner in ("attn", "cross") and kind in TP_KINDS and \
            plan.attention == "split":
        if leaf in ("wq", "wo"):
            q0, n = plan.q_heads(index)
            return (1 if leaf == "wq" else 0), q0 * hd, n * hd
        if leaf in ("wk", "wv"):
            k0, n = plan.kv_heads(index)
            return 1, k0 * hd, n * hd
    if owner in ("mlp", "dense") and plan.mlp == "split" and \
            leaf in ("w_gate", "w_up", "w_down"):
        f0, n = plan.block(plan.d_ff, index)
        return (0 if leaf == "w_down" else 1), f0, n
    return None


def rank_params(kind: str, module: nn.Module, plan: Plan, index: int,
                leaves: bool = False) -> dict:
    """{name: rank ``index``'s block of each parameter of ``module`` (a
    view of the whole tensor), or the whole tensor where the rank uses it
    whole}; with ``leaves`` each block a new leaf that asks for a
    gradient."""
    out = {}
    for name, p in module.named_parameters():
        blk = param_block(kind, name, plan, index)
        t = p if blk is None else p.narrow(*blk)
        out[name] = (t.detach().clone(memory_format=torch.contiguous_format)
                     .requires_grad_() if leaves else t)
    return out


class Apply(nn.Module):
    """``fn(module, *args, **kwargs)`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.m, *args, **kwargs)


def call_with(module: nn.Module, params: dict, fn: Callable, *args,
              **kwargs):
    """``fn(module, *args, **kwargs)`` with the module's parameters
    replaced by ``params`` ({name: tensor}) for the call."""
    return torch.func.functional_call(
        Apply(module, fn), {f"m.{n}": t for n, t in params.items()}, args,
        kwargs)


def split_layer(kind: str, cfg, block: nn.Module, x: torch.Tensor,
                positions: torch.Tensor, plan: Plan,
                ranks: Optional[list] = None,
                enc_out: Optional[torch.Tensor] = None,
                record: Optional[list] = None) -> torch.Tensor:
    """A ``"dense"``, ``"moe"``, ``"enc"``, ``"dec_cross"`` or
    ``"attn_local"`` block's forward as ``plan.size`` ranks compute it, in
    this process: each split part's partials (``ranks[r]``,
    :func:`rank_params` of rank r, by default views of the block's) summed
    in rank order, a replicated part rank 0's.  The norms and residuals
    are the ranks' common work, and so are an MoE block's experts (rank
    0's ``moe_ffn``, which adds its partial of the dense residual; the
    other ranks' partials are their ``apply_mlp`` of it, as ``moe_ffn``
    calls it).  ``record`` gets each partial's max |value| (a tensor)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_mlp, apply_norm
    from repro_torch.models.moe import moe_ffn
    if kind not in ("dense", "moe", "enc", "dec_cross", "attn_local"):
        raise ValueError(f"split_layer runs the GQA kinds, not {kind!r}")
    if ranks is None:
        ranks = [rank_params(kind, block, plan, r) for r in range(plan.size)]

    def summed(part, fn, split=True):
        n = plan.size if split and getattr(plan, part) == "split" else 1
        out = None
        for r in range(n):
            y = call_with(block, ranks[r], fn, TP(plan, r).part(part))
            if record is not None:
                record.append(y.detach().abs().max())
            out = y if out is None else out + y
        return out

    def moe_part(p, tp):
        if tp is None or tp.index == 0:
            return moe_ffn(cfg, p.ffn, h2, tp=tp)[0]
        return apply_mlp(p.ffn.dense, h2.reshape(-1, h2.shape[-1]), tp
                         ).reshape(h2.shape).to(h2.dtype)

    h = apply_norm(cfg.norm_kind, block.ln1, x)
    x = x + summed("attention", lambda p, tp: attn.gqa_train(
        cfg, p.attn, h, positions, causal=kind != "enc", tp=tp))
    if kind == "dec_cross":
        hc = apply_norm(cfg.norm_kind, block.ln_cross, x)
        x = x + summed("attention", lambda p, tp: attn.cross_attend(
            cfg, p.cross, hc, attn.encode_cross_kv(cfg, p.cross, enc_out,
                                                   tp), tp))
    if kind == "moe":
        h2 = apply_norm(cfg.norm_kind, block.ln2, x)
        x = x + summed("mlp", moe_part, split=cfg.moe_dense_residual)
    elif hasattr(block, "mlp"):
        h2 = apply_norm(cfg.norm_kind, block.ln2, x)
        x = x + summed("mlp", lambda p, tp: apply_mlp(p.mlp, h2, tp))
    return x
