"""Model assembly for every block kind: init, full-sequence forward,
prefill, single-token decode and the encoder (the reference's
``models/transformer.py``).

An architecture is a repeating **unit** of block kinds (``cfg.unit``)
repeated ``cfg.n_units`` times, then an exact **tail**, the unit's first
``n_layers % len(unit)`` kinds: recurrentgemma-2b's unit is ``("rec",
"rec", "attn_local")`` with a ``("rec", "rec")`` tail (26 = 8·3 + 2),
xlstm-350m's ``("mlstm", "slstm")``, every other config's a single kind.
:func:`layer_kinds` lists each layer's kind.

The parameters live in an :class:`LM` (``nn.Module``): ``embed``,
``final_norm``, ``lm_head`` (untied configs) and ``layers``, an
``nn.ModuleList`` with one :class:`Block` per layer in place of the
reference's stacked leading U axis; an encoder-decoder (Whisper) also
holds ``encoder``, one ``"enc"`` block a layer (``enc_units.b0_enc``),
and ``enc_norm``.  :func:`stacked_leaves` names each parameter by its
reference leaf: layer ℓ of the units is row ℓ // len(unit) of
``units.b{ℓ % len(unit)}_<kind>.…``, a tail layer j is
``tail.t{j}_<kind>.…`` and is not stacked.  The forward functions are
plain functions on tensors that mirror the reference's signatures.  Where
the config sets ``remat`` and a parameter asks for a gradient, the
forward recomputes each decoder block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per unit;
the encoder, like the reference's, keeps its activations); ``unroll`` has
no meaning in eager PyTorch and is accepted and ignored.  Caches are
``{"layers": [...]}``, one dict per layer: ``{"attn": {k, v, pos}}`` for
GQA (``"dec_cross"`` adds ``"cross_kv"``, the encoder's (k, v)), ``{"attn":
{c, kr}}`` for MLA, ``{"cell": {...}}``, the recurrence's state, for
``"rec"`` (``models/rglru.py``), ``"mlstm"`` and ``"slstm"``
(``models/ssm.py``).

A dense block is pre-norm GQA attention plus a SwiGLU MLP, both residual;
an ``"attn_local"`` block the same over the config's sliding window
(``attention.py``'s window paths); an MoE block the same attention plus
the expert FFN (``models/moe.py``), whose load-balancing loss each path
sums over the layers (``forward`` returns it; prefill and decode drop it,
as the reference's do); an MLA block multi-head latent attention plus the
MLP; an ``"enc"`` block bidirectional GQA plus the MLP; a ``"dec_cross"``
block causal GQA, then cross-attention to the encoder output
(``ln_cross``, ``cross``), then the MLP; a ``"rec"`` block the RG-LRU
cell plus the MLP; ``"mlstm"`` and ``"slstm"`` blocks their xLSTM cell
alone (no MLP, as the reference's).  ``forward`` and ``prefill_forward``
take ``embeds`` [B, T, D] in place of tokens (the vision stub's patch and
text embeddings, cast to the embedding's dtype), and ``forward`` takes
positions [B, T] or, for M-RoPE, [3, B, T]; ``prefill_forward`` keeps the
default positions 0..T-1, as the reference's does.  With
``rope_kind="none"`` every path adds :func:`_sinusoid` positions to its
input, as the reference's does.  :func:`encode` runs the encoder over
precomputed frames [B, S, D] (the audio frontend is a stub, as in the
reference), in the frames' dtype: float32 frames run a bf16 model's
encoder in float32.  Departure: it takes ``use_kernel`` (default True), so
on the card the encoder's attention runs the flash kernels; the
reference's ``encode`` always runs ``attention_ref`` (``use_kernel=False``
here).

``gather_fn(module or parameter, hint)`` is the ZeRO-3 hook
(``launch/sharding.make_gather_fn``): parameters stored sharded
(DTensors, FSDP x TP) are gathered at the point of use, one layer at a
time (inside the layer's recomputation under remat), so only one layer's
weights are ever resident gathered.  ``forward`` and ``prefill_forward``
apply it to the embedding, each decoder layer, the final norm and the
head (``decode_step`` likewise), ``encode`` to each encoder layer and its
norm; the gathered tensors replace the module's for that call
(``torch.func.functional_call``).  ``forward``, ``prefill_forward`` and
``encode`` compute over the model axis as this rank's ``tp`` says
(``models/tp.py``), decided once a call: given (the sharded train step
decides it once), else the plan of the config on the hook's parameters'
mesh (``sharding.tp_of``, ``sharding.tp_plan``): a
block takes this rank's blocks of the parameters whose part splits
(``sharding.tp_local``: heads, d_ff) and runs its attention and MLP on
them, each summed over the model axis once; the embedding lookup reads
the rank's vocab rows (summed over the axis) and the head computes the
rank's vocab columns, gathered whole at the end (``forward(...,
gather_logits=False)`` keeps them: the sharded train step's vocab-parallel
loss); the prefill's cache gathers its KV heads whole.  Parameters whose
part does not split are replicated for the layer code
(``sharding.compute_tensor``), but an MoE block's expert weights under
``moe_strategy="a2a"``, which its dispatch takes in the gathered layout.
``decode_step`` computes replicated over the model axis;
``decode_step(flash_decode=True)`` runs GQA's flash decoding
(``attention.gqa_decode``) for the ``"dense"`` and ``"attn_local"``
kinds, as the reference's does.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (MLP, Norm, _param, apply_mlp,
                                       apply_norm, dtype_of, init_mlp,
                                       init_norm, normal_)

KINDS = ("dense", "moe", "mla", "enc", "dec_cross", "attn_local", "rec",
         "mlstm", "slstm")   # the port's kinds: every kind of the reference


class Cell(NamedTuple):
    """A recurrent kind's functions: its block holds ``module(cfg,
    device)`` as ``cell``, and its cache is {"cell": a state}."""
    module: type
    init: Callable
    forward: Callable      # (cfg, cell, x, return_state=False)
    decode: Callable       # (cfg, cell, x, state) -> (y, state)
    init_state: Callable   # (cfg, batch, device)


CELLS = {
    "rec": Cell(rglru.RGLRU, rglru.init_rglru, rglru.rglru_forward,
                rglru.rglru_decode, rglru.init_rglru_state),
    "mlstm": Cell(ssm.MLSTM, ssm.init_mlstm, ssm.mlstm_forward,
                  ssm.mlstm_decode, ssm.init_mlstm_state),
    "slstm": Cell(ssm.SLSTM, ssm.init_slstm, ssm.slstm_forward,
                  ssm.slstm_decode, ssm.init_slstm_state),
}
NO_MLP = ("mlstm", "slstm")   # xLSTM cells stand alone, as the reference's


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


def _check_model(cfg) -> None:
    for kind in cfg.unit:
        _check_kind(kind)
    attn._check_cfg(cfg)


def layer_kinds(cfg) -> tuple:
    """Each layer's block kind: the unit ``n_units`` times, then the
    tail."""
    return tuple(cfg.unit) * cfg.n_units + tuple(cfg.tail)


def layer_leaf(cfg, layer: int) -> tuple[str, Optional[int]]:
    """(the reference's leaf prefix of decoder layer ``layer``, its row of
    the stacked leaf, None for a tail layer): ``units.b{i}_<kind>`` row u
    for layer u·len(unit) + i, ``tail.t{j}_<kind>`` for tail layer j."""
    n = len(cfg.unit)
    if layer < n * cfg.n_units:
        i = layer % n
        return f"units.b{i}_{cfg.unit[i]}", layer // n
    j = layer - n * cfg.n_units
    return f"tail.t{j}_{cfg.tail[j]}", None


def _check_enc_out(cfg, enc_out) -> None:
    if cfg.encoder_layers and enc_out is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its decoder "
                         f"takes enc_out (transformer.encode)")


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """ln1, then cell (the recurrence's weights) for ``"rec"``,
    ``"mlstm"`` and ``"slstm"``, attn (:class:`attn.MLA` for ``"mla"``,
    GQA otherwise) for the others; for ``"dec_cross"`` ln_cross + cross
    (GQA weights), then ln2 + ffn (:class:`moe.MoE`) for ``"moe"``, ln2 +
    mlp for the other kinds but ``NO_MLP`` where the config has d_ff."""

    def __init__(self, kind: str, cfg, device=None):
        super().__init__()
        _check_kind(kind)
        self.ln1 = Norm(cfg.norm_kind, cfg.d_model, device)
        if kind in CELLS:
            self.cell = CELLS[kind].module(cfg, device)
        else:
            self.attn = (attn.MLA(cfg, device) if kind == "mla"
                         else attn.GQA(cfg, device))
        if kind == "dec_cross":
            self.ln_cross = Norm(cfg.norm_kind, cfg.d_model, device)
            self.cross = attn.GQA(cfg, device)
        if kind == "moe":
            self.ln2 = Norm(cfg.norm_kind, cfg.d_model, device)
            self.ffn = moe.MoE(cfg, device)
        elif cfg.d_ff and kind not in NO_MLP:
            self.ln2 = Norm(cfg.norm_kind, cfg.d_model, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype_of(cfg.dtype), device)


class LM(nn.Module):
    """The parameters of an LM, uninitialised (see :func:`init_params` and
    ``convert.lm_params_from_jax``).  ``cfg`` is the config it was built
    for, ``kinds`` each layer's block kind (:func:`layer_kinds`); an
    encoder-decoder also has ``encoder`` and ``enc_norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_model(cfg)
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        dt = dtype_of(cfg.dtype)
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=dt, device=device)
        self.final_norm = Norm(cfg.norm_kind, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab, dtype=dt,
                                  device=device)
        self.layers = nn.ModuleList(Block(kind, cfg, device)
                                    for kind in self.kinds)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(Block("enc", cfg, device)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(cfg.norm_kind, cfg.d_model, device)


def init_block(kind: str, cfg, block: Block,
               gen: torch.Generator) -> None:
    _check_kind(kind)
    init_norm(block.ln1)
    if kind in CELLS:
        CELLS[kind].init(block.cell, cfg, gen)
    elif kind == "mla":
        attn.init_mla(block.attn, cfg, gen)
    else:
        attn.init_gqa(block.attn, cfg, gen)
    if kind == "dec_cross":
        init_norm(block.ln_cross)
        attn.init_cross(block.cross, cfg, gen)
    if kind == "moe":
        init_norm(block.ln2)
        moe.init_moe(block.ffn, cfg, gen)
    elif hasattr(block, "mlp"):
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
    for kind, block in zip(params.kinds, params.layers):
        init_block(kind, cfg, block, gen)
    if cfg.encoder_layers:
        for block in params.encoder:
            init_block("enc", cfg, block, gen)
        init_norm(params.enc_norm)
    return params


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


ENC_UNIT = "enc_units.b0_enc"     # the reference's stacked encoder unit


def _leaf(name: str, params: LM) -> tuple[str, Optional[int]]:
    head, _, rest = name.partition(".")
    if head not in ("layers", "encoder"):
        return name, None
    layer, _, rest = rest.partition(".")
    if head == "encoder":
        return f"{ENC_UNIT}.{rest}", int(layer)
    prefix, row = layer_leaf(params.cfg, int(layer))
    return f"{prefix}.{rest}", row


def stacked_name(name: str, params: LM) -> str:
    """The reference leaf that a parameter of the port belongs to:
    ``layers.3.attn.wq`` -> ``units.b0_dense.attn.wq`` (row 3 of the
    stacked leaf) for a one-kind unit; for recurrentgemma-2b's ``layers.5``
    -> ``units.b2_attn_local`` (row 1) and ``layers.25`` ->
    ``tail.t1_rec``; ``encoder.3.attn.wq`` -> ``enc_units.b0_enc.attn.wq``;
    any other name as it is."""
    return _leaf(name, params)[0]


def stacked_row(name: str, params: LM) -> Optional[int]:
    """The row of its stacked leaf that a per-layer parameter is
    (``layers.3.…`` of a one-kind unit and ``encoder.3.…``: 3); None for a
    tail layer's and for the others."""
    return _leaf(name, params)[1]


def stacked_leaves(params: LM) -> dict:
    """{reference leaf name: [the port's parameters that make it]}, the
    per-layer ones in layer order, the leaves in the order in which
    ``jax.tree`` flattens the reference's tree (dict keys sorted at every
    level).  A leaf under ``units`` or ``enc_units`` is stacked: its shape
    is ``(rows, *parameter shape)``; a ``tail`` leaf is one layer's."""
    groups: dict = {}
    for name, p in params.named_parameters():
        groups.setdefault(stacked_name(name, params), []).append(p)
    return {k: groups[k] for k in sorted(groups, key=lambda n: n.split("."))}


def is_stacked(leaf: str) -> bool:
    """Whether the reference's leaf has a leading row axis: the units' and
    the encoder's, not the tail's (so a tail's 1-D leaves, its norm scales
    and ``lam``, take no weight decay, as the reference's do not)."""
    return leaf.startswith(("units.", "enc_units."))


# ---------------------------------------------------------------------------
# The ZeRO-3 hook: parameters gathered at the point of use.
# ---------------------------------------------------------------------------

EXPERT_WEIGHTS = ("ffn.w_gate", "ffn.w_up", "ffn.w_down")


def keep_gathered(moe_strategy: str) -> tuple:
    """Parameters that keep the gathered layout (the a2a dispatch's)."""
    return EXPERT_WEIGHTS if moe_strategy == "a2a" else ()


def gathered(gather_fn, module: nn.Module, hint: str, fn: Callable, *args,
             keep: tuple = (), kind: Optional[str] = None, tp=None):
    """``fn(module, *args)``, the module's parameters replaced for the call
    by those ``gather_fn`` gives at the point of use (each replicated for
    the layer code, but those whose names end with one of ``keep``);
    without a hook, as they are.  Given a block's ``kind``, ``fn`` also
    takes ``tp``: this rank's ``models.tp.TP`` (None without a hook), and
    the parameters are those it computes with (``sharding.tp_local``)."""
    kw = {} if kind is None else {"tp": None if gather_fn is None else tp}
    if gather_fn is None:
        return fn(module, *args, **kw)
    from repro_torch.launch.sharding import tp_local
    got = gather_fn(module, hint)
    return tpm.call_with(module, {n: t if n.endswith(keep) else
                                  tp_local(kind, n, t, tp)
                                  for n, t in got.items()}, fn, *args, **kw)


def gathered_param(gather_fn, p: torch.Tensor, hint: str) -> torch.Tensor:
    """One parameter as the hook gives it, replicated for use."""
    if gather_fn is None:
        return p
    from repro_torch.launch.sharding import compute_tensor
    return compute_tensor(gather_fn(p, hint))


def _vocab_param(gather_fn, p: torch.Tensor, hint: str, tp, dim: int):
    """(the embedding (``dim`` 0) or ``lm_head`` (``dim`` 1) as the
    forward uses it, the TP whose vocab block it is): the rank's vocab
    block where ``tp``'s plan splits the head, else replicated, and
    None."""
    if gather_fn is None:
        return p, None
    from repro_torch.launch.sharding import compute_tensor, vocab_local
    t = gather_fn(p, hint)
    vtp = None if tp is None else tp.part("head")
    if vtp is None:
        return compute_tensor(t), None
    return vocab_local(t, dim), vtp


def _tp_of(cfg, params: LM, gather_fn, tp):
    """``tp``, or where it is not given and a hook gathers the parameters,
    this rank's on their mesh (``sharding.tp_of``); None without a
    hook."""
    if gather_fn is None:
        return None
    if tp is not None:
        return tp
    from repro_torch.launch.sharding import mesh_of, tp_of
    return tp_of(cfg, mesh_of(params.parameters()))


def _block_with(p, kind, cfg, x, positions, use_kernel, moe_strategy,
                enc_out, tp=None):
    return apply_block(kind, cfg, p, x, positions, use_kernel=use_kernel,
                       moe_strategy=moe_strategy, enc_out=enc_out, tp=tp)


def _run_block(gather_fn, block, kind, cfg, x, positions, use_kernel,
               moe_strategy, enc_out, tp):
    return gathered(gather_fn, block, "unit", _block_with, kind, cfg, x,
                    positions, use_kernel, moe_strategy, enc_out,
                    keep=keep_gathered(moe_strategy), kind=kind, tp=tp)


def _norm_with(norm, kind, x):
    return apply_norm(kind, norm, x)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _parts(kind: str, tp) -> tuple:
    """(the attention's TP, the MLP's) of a block of ``kind``: each None
    where the plan does not split it (attention splits in the GQA
    kinds)."""
    if tp is None:
        return None, None
    return (tp.part("attention") if kind in tpm.TP_KINDS else None,
            tp.part("mlp"))


def _ffn_residual(kind: str, cfg, p: Block, x: torch.Tensor,
                  moe_strategy: str, tp=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x plus the block's FFN (the expert FFN or the MLP) and the aux loss
    (0 but for an MoE block); ``tp`` the MLP's (the dense residual's)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        h2 = apply_norm(cfg.norm_kind, p.ln2, x)
        y, aux = moe.moe_ffn(cfg, p.ffn, h2, strategy=moe_strategy, tp=tp)
        x = x + y
    elif hasattr(p, "mlp"):
        h2 = apply_norm(cfg.norm_kind, p.ln2, x)
        x = x + apply_mlp(p.mlp, h2, tp)
    return x, aux


def _cross_residual(cfg, p: Block, x: torch.Tensor, enc_kv: tuple, tp=None
                    ) -> torch.Tensor:
    """x plus a ``"dec_cross"`` block's cross-attention to ``enc_kv``."""
    hc = apply_norm(cfg.norm_kind, p.ln_cross, x)
    return x + attn.cross_attend(cfg, p.cross, hc, enc_kv, tp)


def apply_block(kind: str, cfg, p: Block, x: torch.Tensor,
                positions: torch.Tensor, use_kernel: bool = True,
                moe_strategy: str = "sort",
                enc_out: Optional[torch.Tensor] = None, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x', aux_loss); the aux loss is 0 but for an MoE block.
    ``enc_out`` [B, S_enc, D] is the encoder output a ``"dec_cross"``
    block attends to; ``tp`` this rank's ``models.tp.TP`` (``p`` then
    holds its blocks of the parameters the plan splits)."""
    _check_kind(kind)
    atp, mtp = _parts(kind, tp)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind in CELLS:
        x = x + CELLS[kind].forward(cfg, p.cell, h)
    elif kind == "mla":
        x = x + attn.mla_train(cfg, p.attn, h, positions, causal=True)
    else:
        x = x + attn.gqa_train(cfg, p.attn, h, positions,
                               causal=kind != "enc", use_kernel=use_kernel,
                               tp=atp)
    if kind == "dec_cross":
        x = _cross_residual(cfg, p, x, attn.encode_cross_kv(
            cfg, p.cross, enc_out, atp), atp)
    return _ffn_residual(kind, cfg, p, x, moe_strategy, mtp)


def prefill_block(kind: str, cfg, p: Block, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int,
                  unroll: bool = False, use_kernel: bool = True,
                  moe_strategy: str = "sort",
                  enc_out: Optional[torch.Tensor] = None, tp=None
                  ) -> tuple[torch.Tensor, dict]:
    """The block's forward and its cache; a ``"dec_cross"`` block's cache
    also holds ``cross_kv``, the encoder's (k, v); a recurrent block's is
    {"cell": its state after the last token}.  ``tp`` as
    :func:`apply_block`'s; the cache's KV heads are whole."""
    _check_kind(kind)
    atp, mtp = _parts(kind, tp)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind in CELLS:
        y, cache = CELLS[kind].forward(cfg, p.cell, h, return_state=True)
        out = {"cell": cache}
    elif kind == "mla":
        y, cache = attn.mla_prefill(cfg, p.attn, h, positions, max_len)
        out = {"attn": cache}
    else:
        y, cache = attn.gqa_prefill(cfg, p.attn, h, positions, max_len,
                                    use_kernel=use_kernel, tp=atp)
        out = {"attn": cache}
    x = x + y
    if kind == "dec_cross":
        kv = attn.encode_cross_kv(cfg, p.cross, enc_out, atp)
        x = _cross_residual(cfg, p, x, kv, atp)
        out["cross_kv"] = kv if atp is None else tuple(
            atp.gather_heads(t) for t in kv)
    x, _ = _ffn_residual(kind, cfg, p, x, moe_strategy, mtp)
    return x, out


def decode_block(kind: str, cfg, p: Block, x: torch.Tensor,
                 cache: dict, pos: torch.Tensor, flash: bool = False
                 ) -> tuple[torch.Tensor, dict]:
    """One token; an MoE block runs ``moe_ffn``'s default strategy, an
    MLA or recurrent block ignores ``flash`` (which shards a GQA cache), as
    the reference's do.  A ``"dec_cross"`` block reads its cache's
    ``cross_kv`` and never writes it; a recurrent block replaces its
    cache's ``cell``."""
    _check_kind(kind)
    h = apply_norm(cfg.norm_kind, p.ln1, x)
    if kind in CELLS:
        y, cache["cell"] = CELLS[kind].decode(cfg, p.cell, h,
                                                cache["cell"])
    elif kind == "mla":
        y, cache["attn"] = attn.mla_decode(cfg, p.attn, h, cache["attn"],
                                           pos)
    else:
        y, cache["attn"] = attn.gqa_decode(cfg, p.attn, h, cache["attn"],
                                           pos, flash=flash)
    x = x + y
    if kind == "dec_cross":
        x = _cross_residual(cfg, p, x, cache["cross_kv"])
    x, _ = _ffn_residual(kind, cfg, p, x, "sort")
    return x, cache


def init_block_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     device=None) -> dict:
    _check_kind(kind)
    if kind in CELLS:
        return {"cell": CELLS[kind].init_state(cfg, batch, device)}
    if kind == "mla":
        return {"attn": attn.init_mla_cache(cfg, batch, max_len, dtype,
                                            device)}
    cache = {"attn": attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                         device)}
    if kind == "dec_cross":
        shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.hd)
        cache["cross_kv"] = (
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
    return cache


# ---------------------------------------------------------------------------
# Positions, the encoder, the forward (train shape / prefill).
# ---------------------------------------------------------------------------

def _default_positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _round_f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


# The exp XLA's CPU backend emits for float32 (Cephes's polynomial): its
# ln 2 split in two and its coefficients, each a float32.
_EXP_LOG2E = _round_f32(1.44269504088896341)
_EXP_LN2 = (_round_f32(0.693359375), _round_f32(-2.12194440e-4))
_EXP_POLY = tuple(_round_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 ``x`` (in [-87, 0]) as the reference computes it on
    its CPU backend: exp(x) = 2^n exp(r), n = floor(x log2 e + 1/2), r = x
    - n ln 2 in two steps, exp(r) by Cephes's degree-5 polynomial, each
    step one fused multiply-add (here a float64 multiply-add rounded once
    to float32).  ``torch.exp`` rounds correctly and so parts from it by
    an ulp on some inputs, which a position of 1500 multiplies into 1e-4
    of a sinusoid."""
    def fma(a, b, c):
        return (a.double() * b + c).float()

    n = torch.floor(fma(x, _EXP_LOG2E, 0.5))
    r = fma(n, -_EXP_LN2[0], x)
    r = fma(n, -_EXP_LN2[1], r)
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)  # 2^n
    return y * two_n


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Fixed sin/cos position encoding (Whisper's, table-free), float32
    [..., d] for int positions [...]: the sines then the cosines of
    ``positions * exp(-i log(10000) / (d/2 - 1))``, i < d/2."""
    half = d // 2
    # float32 log(10000) over (d/2 - 1), rounded once (a float32 division).
    step = _round_f32(_round_f32(math.log(10_000.0)) / max(half - 1, 1))
    freqs = _exp_f32(torch.arange(half, dtype=torch.float32,
                                  device=positions.device) * -step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _add_positions(cfg, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
    """x plus the sinusoid at ``positions`` [B, T] (row 0 of [3, B, T]) in
    x's dtype where the config has ``rope_kind="none"``, else x."""
    if cfg.rope_kind != "none":
        return x
    pos = positions if positions.dim() == 2 else positions[0]
    return x + _sinusoid(pos, x.shape[-1]).to(x.dtype)


def encode(cfg, params: LM, frames: torch.Tensor, use_kernel: bool = True,
           unroll: bool = False, gather_fn=None, tp=None) -> torch.Tensor:
    """The Whisper encoder over precomputed frame embeddings [B, S, D]
    (sinusoid positions 0..S-1, the ``"enc"`` blocks, ``enc_norm``), in
    the frames' dtype.  ``use_kernel=False`` is the reference's path;
    ``gather_fn`` and ``tp`` as :func:`forward`'s."""
    _check_model(cfg)
    tp = _tp_of(cfg, params, gather_fn, tp)
    b, s, _ = frames.shape
    pos = _default_positions(b, s, frames.device)
    x = frames + _sinusoid(pos, frames.shape[-1]).to(frames.dtype)
    for block in params.encoder:
        x, _ = gathered(gather_fn, block, "unit", _block_with, "enc", cfg,
                        x, pos, use_kernel, "sort", None, kind="enc", tp=tp)
    return gathered(gather_fn, params.enc_norm, "enc_norm", _norm_with,
                    cfg.norm_kind, x)


def _head(cfg, params: LM, embed_w: Optional[torch.Tensor] = None,
          gather_fn=None) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (params.embed if embed_w is None else embed_w).T
    return gathered_param(gather_fn, params.lm_head, "lm_head")


def _embed(embed_w: torch.Tensor, tokens, embeds, tp=None) -> torch.Tensor:
    """The input rows: ``embeds`` [B, T, D] in the embedding's dtype where
    given (the tokens are then not read), else the tokens' rows; with
    ``tp`` ``embed_w`` is the rank's vocab block, whose rows of the tokens
    (zero for tokens outside it) are summed over the model axis."""
    if embeds is not None:
        return embeds.to(embed_w.dtype)
    if tp is None:
        return embed_w[tokens.long()]
    start, n = tp.plan.block(tp.plan.vocab, tp.index)
    local = tokens.long() - start
    inside = (local >= 0) & (local < n)
    rows = embed_w[torch.where(inside, local, 0)]
    return tp.exit(rows.masked_fill(~inside[..., None], 0))


def _logits(cfg, params: LM, x: torch.Tensor, embed_w: torch.Tensor, tp,
            gather_fn, gather: bool = True) -> torch.Tensor:
    """The head on the final norm's output, f32: where ``tp``'s plan
    splits the head (``embed_w`` then the rank's vocab block) the rank's
    vocab columns, gathered whole over the model axis where ``gather``."""
    if cfg.tie_embeddings:
        w, tp = embed_w.T, None if tp is None else tp.part("head")
    else:
        w, tp = _vocab_param(gather_fn, params.lm_head, "lm_head", tp, 1)
    if tp is None:
        return (x @ w).float()
    logits = tp.enter(x) @ w
    return (tp.gather(logits, -1) if gather else logits).float()


def forward(cfg, params: LM, tokens: Optional[torch.Tensor],
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            use_kernel: bool = True, unroll: bool = False,
            moe_strategy: str = "sort",
            enc_out: Optional[torch.Tensor] = None, gather_fn=None,
            gather_logits: bool = True, tp=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens int32[B, T] (or ``embeds`` [B, T, D] for the stub frontends);
    positions [B, T] or, for M-RoPE, [3, B, T] (default 0..T-1);
    ``enc_out`` the encoder output an encoder-decoder's blocks attend to;
    ``gather_fn`` the ZeRO-3 hook -> (logits f32[B, T, V], aux_loss
    scalar, the sum of the blocks' load-balancing losses).  ``tp`` is this
    rank's ``models.tp.TP`` over the model axis, by default that of the
    hook's parameters' mesh (``sharding.tp_of``); where its plan splits the
    vocab and ``gather_logits`` is False, the logits are this rank's vocab
    block f32[B, T, V / M] (module docstring)."""
    _check_model(cfg)
    _check_enc_out(cfg, enc_out)
    tp = _tp_of(cfg, params, gather_fn, tp)
    embed_w, vtp = _vocab_param(gather_fn, params.embed, "embed", tp, 0)
    x = _embed(embed_w, tokens, embeds, vtp)
    b, t, _ = x.shape
    if positions is None:
        positions = _default_positions(b, t, x.device)
    x = _add_positions(cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    for kind, block in zip(params.kinds, params.layers):
        args = (gather_fn, block, kind, cfg, x, positions, use_kernel,
                moe_strategy, enc_out, tp)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _run_block, *args, use_reentrant=False)
        else:
            x, a = _run_block(*args)
        aux = aux + a
    x = gathered(gather_fn, params.final_norm, "final_norm", _norm_with,
                 cfg.norm_kind, x)
    return _logits(cfg, params, x, embed_w, tp, gather_fn,
                   gather_logits), aux


def prefill_forward(cfg, params: LM, tokens: Optional[torch.Tensor],
                    max_len: int, embeds: Optional[torch.Tensor] = None,
                    unroll: bool = False, use_kernel: bool = True,
                    moe_strategy: str = "sort",
                    enc_out: Optional[torch.Tensor] = None, gather_fn=None,
                    tp=None) -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits f32[B, 1, V], cache): the full-sequence
    compute over tokens int32[B, T] (or ``embeds`` [B, T, D]) at positions
    0..T-1, the cache of every layer (with each ``"dec_cross"`` layer's
    ``cross_kv`` from ``enc_out``), and only the next-token logits.
    ``use_kernel=False`` takes the plain attention path, against which the
    kernel path is checked; ``gather_fn`` the ZeRO-3 hook and ``tp`` as
    :func:`forward`'s."""
    _check_model(cfg)
    _check_enc_out(cfg, enc_out)
    tp = _tp_of(cfg, params, gather_fn, tp)
    embed_w, vtp = _vocab_param(gather_fn, params.embed, "embed", tp, 0)
    x = _embed(embed_w, tokens, embeds, vtp)
    b, t, _ = x.shape
    positions = _default_positions(b, t, x.device)
    x = _add_positions(cfg, x, positions)
    caches = []
    for kind, block in zip(params.kinds, params.layers):
        x, c = gathered(gather_fn, block, "unit", _prefill_with, kind, cfg,
                        x, positions, max_len, use_kernel, moe_strategy,
                        enc_out, keep=keep_gathered(moe_strategy), kind=kind,
                        tp=tp)
        caches.append(c)
    x = gathered(gather_fn, params.final_norm, "final_norm", _norm_with,
                 cfg.norm_kind, x[:, -1:])
    return _logits(cfg, params, x, embed_w, tp, gather_fn), \
        {"layers": caches}


def _prefill_with(p, kind, cfg, x, positions, max_len, use_kernel,
                  moe_strategy, enc_out, tp=None):
    return prefill_block(kind, cfg, p, x, positions, max_len,
                         use_kernel=use_kernel, moe_strategy=moe_strategy,
                         enc_out=enc_out, tp=tp)


# ---------------------------------------------------------------------------
# Decode (one token against a cache).
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """An empty cache of ``max_len`` slots an attention layer, on
    ``device`` (None = CUDA); a recurrent layer's zero state; an
    encoder-decoder's ``cross_kv`` zeros of ``encoder_seq`` rows, which
    ``serve_step.fill_cross_kv`` replaces."""
    _check_model(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    return {"layers": [init_block_cache(kind, cfg, batch, max_len, dt, dev)
                       for kind in layer_kinds(cfg)]}


def _decode_with(p, kind, cfg, x, cache, pos, flash):
    return decode_block(kind, cfg, p, x, cache, pos, flash)


def decode_step(cfg, params: LM, token: torch.Tensor, cache: dict,
                pos: torch.Tensor, unroll: bool = False,
                flash_decode: bool = False, gather_fn=None
                ) -> tuple[torch.Tensor, dict]:
    """token int32[B, 1]; pos int32[] (the token's global position);
    ``gather_fn`` the ZeRO-3 hook (parameters stored sharded).  Returns
    (logits f32[B, 1, V], cache), the cache updated in place."""
    embed_w = gathered_param(gather_fn, params.embed, "embed")
    x = embed_w[token.long()]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x = _add_positions(cfg, x, pos.reshape(1, 1).expand(token.shape))
    for kind, block, c in zip(params.kinds, params.layers,
                              cache["layers"]):
        x, _ = gathered(gather_fn, block, "unit", _decode_with, kind, cfg,
                        x, c, pos, flash_decode)
    x = gathered(gather_fn, params.final_norm, "final_norm", _norm_with,
                 cfg.norm_kind, x)
    return (x @ _head(cfg, params, embed_w, gather_fn)).float(), cache
