"""Model assembly for the dense, MoE and MLA block kinds: init,
full-sequence forward, prefill and single-token decode (the ``"dense"``,
``"moe"`` and ``"mla"`` parts of the reference's
``models/transformer.py``).

The parameters live in an :class:`LM` (``nn.Module``): ``embed``,
``final_norm``, ``lm_head`` (untied configs) and ``layers``, an
``nn.ModuleList`` with one :class:`Block` per layer in place of the
reference's stacked leading U axis (:func:`stacked_leaves` names each
parameter by its reference leaf, under ``units.b0_<kind>``).  The forward
functions are plain functions on tensors that mirror the reference's
signatures.  Where the config sets ``remat`` and a parameter asks for a
gradient, the forward recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per unit);
``unroll`` has no meaning in eager PyTorch and is accepted and ignored.
Caches are ``{"layers": [{"attn": {k, v, pos}}, ...]}`` (MLA: ``{"attn":
{c, kr}}``), one dict per layer.

A dense block is pre-norm GQA attention plus a SwiGLU MLP, both residual;
an MoE block the same attention plus the expert FFN (``models/moe.py``),
whose load-balancing loss each path sums over the layers (``forward``
returns it; prefill and decode drop it, as the reference's do); an MLA
block multi-head latent attention plus the MLP.  ``forward`` and
``prefill_forward`` take ``embeds`` [B, T, D] in place of tokens (the
vision stub's patch and text embeddings, cast to the embedding's dtype),
and ``forward`` takes positions [B, T] or, for M-RoPE, [3, B, T];
``prefill_forward`` keeps the default positions 0..T-1, as the
reference's does.  Other block kinds raise ``NotImplementedError`` naming
their ROADMAP slice (queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import (MLP, Norm, _param, apply_mlp,
                                       apply_norm, dtype_of, init_mlp,
                                       init_norm, normal_)

KINDS = ("dense", "moe", "mla")      # the block kinds the port has
KIND_SLICES = {
    "enc": "slice 9f (Whisper encoder-decoder)",
    "dec_cross": "slice 9f (Whisper encoder-decoder)",
    "attn_local": "slice 9g (sliding window)",
    "rec": "slice 9g (RG-LRU)",
    "mlstm": "slice 9g (xLSTM)",
    "slstm": "slice 9g (xLSTM)",
}


def _check_kind(kind: str) -> None:
    if kind in KINDS:
        return
    if kind in KIND_SLICES:
        raise attn._not_ported(f"block kind {kind!r}", KIND_SLICES[kind])
    raise ValueError(kind)


def _check_model(cfg) -> None:
    for kind in cfg.unit:
        _check_kind(kind)
    if cfg.encoder_layers:
        raise attn._not_ported("the encoder", KIND_SLICES["enc"])
    attn._check_cfg(cfg)


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """ln1, attn (:class:`attn.MLA` for ``"mla"``, GQA otherwise), then
    ln2 + ffn (:class:`moe.MoE`) for ``"moe"``, ln2 + mlp for ``"dense"``
    and ``"mla"`` where the config has d_ff."""

    def __init__(self, kind: str, cfg, device=None):
        super().__init__()
        _check_kind(kind)
        self.ln1 = Norm(cfg.norm_kind, cfg.d_model, device)
        self.attn = (attn.MLA(cfg, device) if kind == "mla"
                     else attn.GQA(cfg, device))
        if kind == "moe":
            self.ln2 = Norm(cfg.norm_kind, cfg.d_model, device)
            self.ffn = moe.MoE(cfg, device)
        elif cfg.d_ff:
            self.ln2 = Norm(cfg.norm_kind, cfg.d_model, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype_of(cfg.dtype), device)


class LM(nn.Module):
    """The parameters of a dense, MoE or MLA LM, uninitialised (see
    :func:`init_params` and ``convert.lm_params_from_jax``).  ``kind`` is
    the config's one block kind, ``unit`` the reference's name of the
    stacked unit (``units.b0_<kind>``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_model(cfg)
        self.kind = cfg.unit[0]
        self.unit = f"units.b0_{self.kind}"
        dt = dtype_of(cfg.dtype)
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.final_norm = Norm(cfg.norm_kind, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab, dtype=dt,
                                  device=device)
        self.layers = nn.ModuleList(Block(self.kind, cfg, device)
                                    for _ in range(cfg.n_layers))


def init_block(kind: str, cfg, block: Block,
               gen: torch.Generator) -> None:
    _check_kind(kind)
    init_norm(block.ln1)
    if kind == "mla":
        attn.init_mla(block.attn, cfg, gen)
    else:
        attn.init_gqa(block.attn, cfg, gen)
    if kind == "moe":
        init_norm(block.ln2)
        moe.init_moe(block.ffn, cfg, gen)
    elif cfg.d_ff:
        init_norm(block.ln2)
        init_mlp(block.mlp, gen)


def init_params(cfg, gen: Optional[torch.Generator] = None, device=None
                ) -> LM:
    """An :class:`LM` on ``device`` (None = CUDA) with the reference's
    init scales, drawn from ``gen`` (a ``torch.Generator`` on that device;
    seed 0 when None).  The numbers differ from the reference's
    ``jax.random`` ones: tests carry the reference's weights across with
    ``convert.lm_params_from_jax``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    params = LM(cfg, dev)
    normal_(params.embed, cfg.d_model ** -0.5, gen)
    init_norm(params.final_norm)
    if not cfg.tie_embeddings:
        normal_(params.lm_head, cfg.d_model ** -0.5, gen)
    for block in params.layers:
        init_block(params.kind, cfg, block, gen)
    return params


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def stacked_name(name: str, unit: str) -> str:
    """The reference leaf that a parameter of the port belongs to, for a
    model whose stacked unit is ``unit`` (``LM.unit``):
    ``layers.3.attn.wq`` -> ``units.b0_dense.attn.wq`` (row 3 of the
    stacked leaf), any other name as it is."""
    if name.startswith("layers."):
        return f"{unit}.{name.split('.', 2)[2]}"
    return name


def stacked_leaves(params: LM) -> dict:
    """{reference leaf name: [the port's parameters that make it]}, the
    per-layer ones in layer order, the leaves in the order in which
    ``jax.tree`` flattens the reference's tree (dict keys sorted at every
    level).  A leaf under ``units`` is stacked: its shape is
    ``(n_layers, *parameter shape)``."""
    groups: dict = {}
    for name, p in params.named_parameters():
        groups.setdefault(stacked_name(name, params.unit), []).append(p)
    return {k: groups[k] for k in sorted(groups, key=lambda n: n.split("."))}


def is_stacked(leaf: str) -> bool:
    return leaf.startswith("units.")


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _ffn_residual(kind: str, cfg, p: Block, x: torch.Tensor,
                  moe_strategy: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x plus the block's FFN (the expert FFN or the MLP) and the aux loss
    (0 but for an MoE block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        h2 = apply_norm(cfg.norm_kind, p.ln2, x)
        y, aux = moe.moe_ffn(cfg, p.ffn, h2, strategy=moe_strategy)
        x = x + y
    elif cfg.d_ff:
        h2 = apply_norm(cfg.norm_kind, p.ln2, x)
        x = x + apply_mlp(p.mlp, h2)
    return x, aux


def apply_block(kind: str, cfg, p: Block, x: torch.Tensor,
                positions: torch.Tensor, use_kernel: bool = True,
                moe_strategy: str = "sort"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x', aux_loss); a dense or MLA block's aux loss is 0."""
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind == "mla":
        x = x + attn.mla_train(cfg, p.attn, h, positions, causal=True)
    else:
        x = x + attn.gqa_train(cfg, p.attn, h, positions, causal=True,
                               use_kernel=use_kernel)
    return _ffn_residual(kind, cfg, p, x, moe_strategy)


def prefill_block(kind: str, cfg, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  unroll: bool = False, use_kernel: bool = True,
                  moe_strategy: str = "sort") -> tuple[torch.Tensor, dict]:
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind == "mla":
        y, cache = attn.mla_prefill(cfg, p.attn, h, positions, max_len)
    else:
        y, cache = attn.gqa_prefill(cfg, p.attn, h, positions, max_len,
                                    use_kernel=use_kernel)
    x, _ = _ffn_residual(kind, cfg, p, x + y, moe_strategy)
    return x, {"attn": cache}


def decode_block(kind: str, cfg, p: Block, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, flash: bool = False
                 ) -> tuple[torch.Tensor, dict]:
    """One token; an MoE block runs ``moe_ffn``'s default strategy, an
    MLA block ignores ``flash`` (which shards a GQA cache), as the
    reference's do."""
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind == "mla":
        y, cache["attn"] = attn.mla_decode(cfg, p.attn, h, cache["attn"],
                                           pos)
    else:
        y, cache["attn"] = attn.gqa_decode(cfg, p.attn, h, cache["attn"],
                                           pos, flash=flash)
    x, _ = _ffn_residual(kind, cfg, p, x + y, "sort")
    return x, cache


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device=None) -> dict:
    _check_kind(kind)
    if kind == "mla":
        return {"attn": attn.init_mla_cache(cfg, batch, max_len, dtype,
                                            device)}
    return {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype, device)}


# ---------------------------------------------------------------------------
# Forward (train shape / prefill).
# ---------------------------------------------------------------------------

def _default_positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _head(cfg, params: LM) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed(params: LM, tokens, embeds) -> torch.Tensor:
    """The input rows: ``embeds`` [B, T, D] in the embedding's dtype where
    given (the tokens are then not read), else the tokens' rows."""
    if embeds is None:
        return params.embed[tokens.long()]
    return embeds.to(params.embed.dtype)


def forward(cfg, params: LM, tokens: Optional[torch.Tensor],
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            use_kernel: bool = True, unroll: bool = False,
            moe_strategy: str = "sort"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens int32[B, T] (or ``embeds`` [B, T, D] for the stub frontends);
    positions [B, T] or, for M-RoPE, [3, B, T] (default 0..T-1) ->
    (logits f32[B, T, V], aux_loss scalar, the sum of the blocks'
    load-balancing losses)."""
    _check_model(cfg)
    x = _embed(params, tokens, embeds)
    b, t, _ = x.shape
    if positions is None:
        positions = _default_positions(b, t, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    for block in params.layers:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                apply_block, params.kind, cfg, block, x, positions,
                use_kernel, moe_strategy, use_reentrant=False)
        else:
            x, a = apply_block(params.kind, cfg, block, x, positions,
                               use_kernel=use_kernel,
                               moe_strategy=moe_strategy)
        aux = aux + a
    x = apply_norm(cfg.norm_kind, params.final_norm, x)
    return (x @ _head(cfg, params)).float(), aux


def prefill_forward(cfg, params: LM, tokens: Optional[torch.Tensor],
                    max_len: int, embeds: Optional[torch.Tensor] = None,
                    unroll: bool = False, use_kernel: bool = True,
                    moe_strategy: str = "sort") -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits f32[B, 1, V], cache): the full-sequence
    compute over tokens int32[B, T] (or ``embeds`` [B, T, D]) at positions
    0..T-1, the cache of every layer, and only the next-token logits.
    ``use_kernel=False`` takes the plain attention path, against which the
    kernel path is checked."""
    _check_model(cfg)
    x = _embed(params, tokens, embeds)
    b, t, _ = x.shape
    positions = _default_positions(b, t, x.device)
    caches = []
    for block in params.layers:
        x, c = prefill_block(params.kind, cfg, block, x, positions,
                             max_len, use_kernel=use_kernel,
                             moe_strategy=moe_strategy)
        caches.append(c)
    x = apply_norm(cfg.norm_kind, params.final_norm, x[:, -1:])
    return (x @ _head(cfg, params)).float(), {"layers": caches}


# ---------------------------------------------------------------------------
# Decode (one token against a cache).
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """An empty cache of ``max_len`` slots a layer, on ``device`` (None =
    CUDA)."""
    _check_model(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    return {"layers": [init_block_cache(cfg.unit[0], cfg, batch, max_len,
                                        dt, dev)
                       for _ in range(cfg.n_layers)]}


def decode_step(cfg, params: LM, token: torch.Tensor, cache: dict,
                pos: torch.Tensor, unroll: bool = False,
                flash_decode: bool = False) -> tuple[torch.Tensor, dict]:
    """token int32[B, 1]; pos int32[] (the token's global position).
    Returns (logits f32[B, 1, V], cache), the cache updated in place."""
    x = params.embed[token.long()]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    for block, c in zip(params.layers, cache["layers"]):
        x, _ = decode_block(params.kind, cfg, block, x, c, pos,
                            flash_decode)
    x = apply_norm(cfg.norm_kind, params.final_norm, x)
    return (x @ _head(cfg, params)).float(), cache
