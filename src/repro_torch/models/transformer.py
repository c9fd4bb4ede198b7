"""Model assembly for the dense block kind: init, full-sequence forward,
prefill and single-token decode (the ``"dense"`` part of the reference's
``models/transformer.py``).

The parameters live in a :class:`DenseLM` (``nn.Module``): ``embed``,
``final_norm``, ``lm_head`` (untied configs) and ``layers``, an
``nn.ModuleList`` with one :class:`DenseBlock` per layer in place of the
reference's stacked leading U axis (:func:`stacked_leaves` names each
parameter by its reference leaf).  The forward functions are plain
functions on tensors that mirror the reference's signatures.  Where the
config sets ``remat`` and a parameter asks for a gradient, the forward
recomputes each block in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` per unit); ``unroll`` has no meaning in
eager PyTorch and is accepted and ignored.  Caches are ``{"layers":
[{"attn": {k, v, pos}}, ...]}``, one dict per layer.

A dense block is pre-norm GQA attention plus a SwiGLU MLP, both residual.
Other block kinds raise ``NotImplementedError`` naming their ROADMAP
slice (queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Norm, _param, apply_mlp,
                                       apply_norm, dtype_of, init_mlp,
                                       init_norm, normal_)

KIND_SLICES = {
    "moe": "slice 9c (MoE)",
    "mla": "slice 9d (MLA)",
    "enc": "slice 9f (Whisper encoder-decoder)",
    "dec_cross": "slice 9f (Whisper encoder-decoder)",
    "attn_local": "slice 9g (sliding window)",
    "rec": "slice 9g (RG-LRU)",
    "mlstm": "slice 9g (xLSTM)",
    "slstm": "slice 9g (xLSTM)",
}


def _check_kind(kind: str) -> None:
    if kind == "dense":
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

class DenseBlock(nn.Module):
    """ln1, attn (GQA), and ln2 + mlp where the config has d_ff."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.norm_kind, cfg.d_model, device)
        self.attn = attn.GQA(cfg, device)
        if cfg.d_ff:
            self.ln2 = Norm(cfg.norm_kind, cfg.d_model, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype_of(cfg.dtype), device)


class DenseLM(nn.Module):
    """The parameters of a dense LM, uninitialised (see :func:`init_params`
    and ``convert.lm_params_from_jax``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_model(cfg)
        dt = dtype_of(cfg.dtype)
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.final_norm = Norm(cfg.norm_kind, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab, dtype=dt,
                                  device=device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))


def init_block(kind: str, cfg, block: DenseBlock,
               gen: torch.Generator) -> None:
    _check_kind(kind)
    init_norm(block.ln1)
    attn.init_gqa(block.attn, cfg, gen)
    if cfg.d_ff:
        init_norm(block.ln2)
        init_mlp(block.mlp, gen)


def init_params(cfg, gen: Optional[torch.Generator] = None, device=None
                ) -> DenseLM:
    """A :class:`DenseLM` on ``device`` (None = CUDA) with the reference's
    init scales, drawn from ``gen`` (a ``torch.Generator`` on that device;
    seed 0 when None).  The numbers differ from the reference's
    ``jax.random`` ones: tests carry the reference's weights across with
    ``convert.lm_params_from_jax``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    params = DenseLM(cfg, dev)
    normal_(params.embed, cfg.d_model ** -0.5, gen)
    init_norm(params.final_norm)
    if not cfg.tie_embeddings:
        normal_(params.lm_head, cfg.d_model ** -0.5, gen)
    for block in params.layers:
        init_block("dense", cfg, block, gen)
    return params


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


UNIT = "units.b0_dense"     # the reference's stacked dense unit


def stacked_name(name: str) -> str:
    """The reference leaf that a parameter of the port belongs to:
    ``layers.3.attn.wq`` -> ``units.b0_dense.attn.wq`` (row 3 of the
    stacked leaf), any other name as it is."""
    if name.startswith("layers."):
        return f"{UNIT}.{name.split('.', 2)[2]}"
    return name


def stacked_leaves(params: DenseLM) -> dict:
    """{reference leaf name: [the port's parameters that make it]}, the
    per-layer ones in layer order, the leaves in the order in which
    ``jax.tree`` flattens the reference's tree (dict keys sorted at every
    level).  A leaf under ``units`` is stacked: its shape is
    ``(n_layers, *parameter shape)``."""
    groups: dict = {}
    for name, p in params.named_parameters():
        groups.setdefault(stacked_name(name), []).append(p)
    return {k: groups[k] for k in sorted(groups, key=lambda n: n.split("."))}


def is_stacked(leaf: str) -> bool:
    return leaf.startswith(UNIT + ".")


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _mlp_residual(cfg, p: DenseBlock, x: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff:
        h2 = apply_norm(cfg.norm_kind, p.ln2, x)
        x = x + apply_mlp(p.mlp, h2)
    return x


def apply_block(kind: str, cfg, p: DenseBlock, x: torch.Tensor,
                positions: torch.Tensor, use_kernel: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x', aux_loss); a dense block's aux loss is 0."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    x = x + attn.gqa_train(cfg, p.attn, h, positions, causal=True,
                           use_kernel=use_kernel)
    return _mlp_residual(cfg, p, x), aux


def prefill_block(kind: str, cfg, p: DenseBlock, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  unroll: bool = False, use_kernel: bool = True
                  ) -> tuple[torch.Tensor, dict]:
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    y, cache = attn.gqa_prefill(cfg, p.attn, h, positions, max_len,
                                use_kernel=use_kernel)
    return _mlp_residual(cfg, p, x + y), {"attn": cache}


def decode_block(kind: str, cfg, p: DenseBlock, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, flash: bool = False
                 ) -> tuple[torch.Tensor, dict]:
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    y, cache["attn"] = attn.gqa_decode(cfg, p.attn, h, cache["attn"], pos,
                                       flash=flash)
    return _mlp_residual(cfg, p, x + y), cache


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device=None) -> dict:
    _check_kind(kind)
    return {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype, device)}


# ---------------------------------------------------------------------------
# Forward (train shape / prefill).
# ---------------------------------------------------------------------------

def _default_positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _head(cfg, params: DenseLM) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def forward(cfg, params: DenseLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            use_kernel: bool = True, unroll: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens int32[B, T] -> (logits f32[B, T, V], aux_loss scalar)."""
    _check_model(cfg)
    x = params.embed[tokens.long()]
    b, t, _ = x.shape
    if positions is None:
        positions = _default_positions(b, t, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    for block in params.layers:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                apply_block, "dense", cfg, block, x, positions, use_kernel,
                use_reentrant=False)
        else:
            x, a = apply_block("dense", cfg, block, x, positions,
                               use_kernel=use_kernel)
        aux = aux + a
    x = apply_norm(cfg.norm_kind, params.final_norm, x)
    return (x @ _head(cfg, params)).float(), aux


def prefill_forward(cfg, params: DenseLM, tokens: torch.Tensor,
                    max_len: int, unroll: bool = False,
                    use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits f32[B, 1, V], cache): the full-sequence
    compute, the cache of every layer, and only the next-token logits.
    ``use_kernel=False`` takes the plain attention path, against which the
    kernel path is checked."""
    _check_model(cfg)
    x = params.embed[tokens.long()]
    b, t, _ = x.shape
    positions = _default_positions(b, t, x.device)
    caches = []
    for block in params.layers:
        x, c = prefill_block("dense", cfg, block, x, positions, max_len,
                             use_kernel=use_kernel)
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
    return {"layers": [init_block_cache("dense", cfg, batch, max_len, dt,
                                        dev)
                       for _ in range(cfg.n_layers)]}


def decode_step(cfg, params: DenseLM, token: torch.Tensor, cache: dict,
                pos: torch.Tensor, unroll: bool = False,
                flash_decode: bool = False) -> tuple[torch.Tensor, dict]:
    """token int32[B, 1]; pos int32[] (the token's global position).
    Returns (logits f32[B, 1, V], cache), the cache updated in place."""
    x = params.embed[token.long()]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    for block, c in zip(params.layers, cache["layers"]):
        x, _ = decode_block("dense", cfg, block, x, c, pos, flash_decode)
    x = apply_norm(cfg.norm_kind, params.final_norm, x)
    return (x @ _head(cfg, params)).float(), cache
