"""Attention: grouped-query attention (GQA) with its full-sequence,
prefill and single-token decode paths, full or sliding-window,
bidirectional (the Whisper encoder's), multi-head latent attention (MLA,
minicpm3) with its absorbed decode, and Whisper's cross-attention (the
reference's ``models/attention.py`` but for flash decoding).

The GQA paths (forward, prefill, cross-attention) take a ``tp``
(``models/tp.py``): the rank's query heads and the KV heads they need,
from its blocks of the weights, its input entering and its output leaving
over the model axis; the prefill's cache gathers the KV heads whole.
Decode is replicated over the model axis (``tp`` None).

Positions rotate q and k by RoPE (``rope_kind="rope"``) or by Qwen2-VL's
M-RoPE (``"mrope"``): positions [B, T] (text: three equal rows, which is
RoPE exactly) or [3, B, T] (temporal, height and width rows).  With
``rope_kind="none"`` (Whisper) nothing is rotated: the model adds
sinusoid positions to its input instead (``transformer._sinusoid``).

The GQA full-sequence forward and prefill call the flash_attention op
(``kernels/flash_attention``) when ``use_kernel`` is set, the default: on
a CUDA tensor that is a CUDA kernel, at every T (the bf16 one for bf16
models at head dim 64 or 128, the float32 one otherwise); on the CPU its
plain version.  ``use_kernel=False`` calls ``attention_ref`` in float32
on any device, as the reference's default does.

A config with a sliding window (``cfg.window``, mixtral) takes the
reference's window paths on every device, with ``use_kernel`` or without:
the forward ``_windowed_attention`` (a materialised [T, S] float32 mask),
the prefill ``blocked_attention`` (an online softmax over key blocks, the
[T, S] scores never whole) above T·T = ``BLOCKED_THRESHOLD`` and
``_windowed_attention`` below it.  No kernel runs on them: the reference
computes them outside its Pallas kernel.  Windowless configs keep the
flash op on every path: the CUDA kernel never materialises the scores, so
their prefill needs no blocked switch.

MLA runs no kernel either, on any device: its q·k width (nope + rope, 96
at minicpm3's width) is not its v width (64), which neither the
reference's Pallas kernel nor the port's flash op takes.  Its forward and
prefill take the reference's switch: ``attention_ref`` in float32 up to
T·T = ``BLOCKED_THRESHOLD``, ``blocked_attention`` above; both scale the
scores by 1/sqrt(nope + rope).

Decode keeps a cache per layer.  GQA: k/v [B, H_kv, slots, Dh] plus the
global position held by each slot (−1 = empty); a token at position p
goes to slot ``p % slots``.  ``slots`` is ``max_len``, or
``min(window, max_len)`` for a window: a ring that holds the last
``window`` positions, older slots overwritten.  MLA: the latent c [B,
max_len, kv_rank] and the shared rotated rope key kr [B, max_len, rope]
(288 values a token at minicpm3's width), slot p for position p; decode
absorbs the up-projections into the query and the output.  The port
writes the new token into the cache in place (the reference returns a new
cache): the returned dict is the one passed in.

Cross-attention (the decoder's queries against the encoder's K/V, which
:func:`encode_cross_kv` computes once and the decode cache keeps) runs
``attention_ref`` in float32 and casts back to x's type on every device,
as the reference's ``cross_attend`` does: the reference never sends it
through its Pallas kernel, and at decode (one query row against 1500
keys) a 128-row query tile would be mostly waste.  Products with a weight
take JAX's type promotion (``layers.mm``): the encoder's K/V of float32
frames stay float32 against bf16 weights.

``gqa_decode(flash=True)`` is the reference's flash decoding over a
sequence-sharded cache: under an ambient mesh with a ``"model"`` axis
(``launch/mesh.set_mesh``), each rank holds its block of the cache's
slots (and its data rows of the batch; ``launch/sharding.shard_cache``),
writes the new token where it owns the slot (decided on the device, no
host sync), and computes its partial (m, l, acc) over its slots; m is
all-reduced by max, then l·corr and acc·corr by sum (one all-reduce) over
the model axis.  Without an ambient mesh, or one without a
``"model"`` axis, it is the full decode, bit for bit, as the reference's
falls back.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import HEAD_DIMS as \
    FLASH_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import attention as flash_attn_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import (_param, apply_mrope, apply_rope,
                                       dtype_of, mm, normal_)


def _check_cfg(cfg) -> None:
    if cfg.rope_kind not in ("rope", "mrope", "none"):
        raise ValueError(f"rope_kind={cfg.rope_kind!r}")


class GQA(nn.Module):
    """wq [D, H·Dh], wk/wv [D, H_kv·Dh], wo [H·Dh, D] in the config dtype."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, dtype_of(cfg.dtype)
        self.wq = _param(d, cfg.n_heads * hd, dtype=dt, device=device)
        self.wk = _param(d, cfg.n_kv_heads * hd, dtype=dt, device=device)
        self.wv = _param(d, cfg.n_kv_heads * hd, dtype=dt, device=device)
        self.wo = _param(cfg.n_heads * hd, d, dtype=dt, device=device)


def init_gqa(attn: GQA, cfg, gen: torch.Generator) -> None:
    s = cfg.d_model ** -0.5
    normal_(attn.wq, s, gen)
    normal_(attn.wk, s, gen)
    normal_(attn.wv, s, gen)
    normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * hd)


def _positions_rope(cfg, q, k, positions):
    _check_cfg(cfg)
    if cfg.rope_kind == "none":       # sinusoid positions, added to x
        return q, k
    if cfg.rope_kind == "rope":
        return apply_rope(q, positions), apply_rope(k, positions)
    # mrope: positions [B, T] (text: three equal rows) or [3, B, T].
    pos3 = (positions if positions.dim() == 3
            else positions[None].expand((3,) + tuple(positions.shape)))
    pos3 = pos3[:, :, None]                      # [3, B, 1, T] per head
    return apply_mrope(q, pos3), apply_mrope(k, pos3)


def _heads(cfg, tp) -> tuple[int, int]:
    """(query heads, KV heads) the rank computes: the config's, or the
    plan's for rank ``tp``."""
    if tp is None:
        return cfg.n_heads, cfg.n_kv_heads
    return tp.plan.q_heads(tp.index)[1], tp.plan.kv_heads(tp.index)[1]


def gqa_qkv(cfg, params: GQA, x: torch.Tensor, positions: torch.Tensor,
            tp=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> q [B, H, T, Dh], k and v [B, H_kv, T, Dh], q and k
    rotated (positions [B, T], or [3, B, T] for mrope), all in x's
    dtype; with ``tp`` the rank's heads from its weight blocks."""
    hd = cfg.hd
    h, h_kv = _heads(cfg, tp)
    q = _split_heads(mm(x, params.wq), h, hd)
    k = _split_heads(mm(x, params.wk), h_kv, hd)
    v = _split_heads(mm(x, params.wv), h_kv, hd)
    q, k = _positions_rope(cfg, q, k, positions)
    return q, k, v


def _attend(q, k, v, causal: bool, use_kernel: bool) -> torch.Tensor:
    """Attention on contiguous [B, H, T, Dh] operands, back in q's dtype.
    The op takes bf16 operands as they are where its bf16 kernel takes the
    head dim (it computes in float32 with P rounded to bf16, as the
    reference's Pallas kernel does on bf16); everything else, and the plain
    path, runs in float32."""
    if use_kernel and q.dtype == torch.bfloat16 and \
            q.shape[-1] in FLASH_HEAD_DIMS[torch.bfloat16]:
        return flash_attn_op(*(t.contiguous() for t in (q, k, v)),
                             causal=causal)
    args = [t.float().contiguous() for t in (q, k, v)]
    if use_kernel:
        out = flash_attn_op(*args, causal=causal)
    else:
        out = attention_ref(*args, causal=causal)
    return out.to(q.dtype)


def gqa_train(cfg, params: GQA, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, use_kernel: bool = True, tp=None
              ) -> torch.Tensor:
    """x [B, T, D]; positions [B, T] (or [3, B, T] for mrope).  ``tp``:
    the rank's heads (module docstring)."""
    if tp is not None:
        x = tp.enter(x)
    q, k, v = gqa_qkv(cfg, params, x, positions, tp)
    if cfg.window and causal:
        out = _windowed_attention(q, k, v, cfg.window)
    else:
        out = _attend(q, k, v, causal, use_kernel)
    y = mm(_merge_heads(out), params.wo)
    return y if tp is None else tp.exit(y)


def _windowed_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window attention in float32 with a materialised mask
    (the reference's); back in q's dtype.  The scores are scaled and
    masked in place, so the peak is the scores and their softmax."""
    b, h, t, hd = q.shape
    _, h_kv, s, _ = k.shape
    group = h // h_kv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    scores.div_(hd ** 0.5)
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = (rows >= cols) & (rows - cols < window)
    scores.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores
    return torch.einsum("bhts,bhsd->bhtd", probs, v.float()).to(q.dtype)


BLOCKED_THRESHOLD = 4096 * 8192   # T·S above this ⇒ blocked attention


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      block_k: int = 2048, unroll: bool = False
                      ) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks
    carrying (m, l, acc) in float32, so the [T, S] score matrix never
    materialises (the reference's ``lax.scan``; ``unroll`` is accepted and
    ignored).  q [B, H, T, D], k [B, H_kv, S, D], v [B, H_kv, S, Dv];
    query t and key s are positions t and s.  Back in q's dtype."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    dv = v.shape[-1]
    group = h // h_kv
    nb = -(-s // block_k)
    pad = nb * block_k - s
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, h_kv, group, t, d).float()
    rows = torch.arange(t, device=q.device)[:, None]      # query positions
    scale = 1.0 / (d ** 0.5)
    m = torch.full((b, h_kv, group, t), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h_kv, group, t), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, h_kv, group, t, dv), dtype=torch.float32,
                      device=q.device)
    for j in range(nb):
        kblk = k[:, :, j * block_k:(j + 1) * block_k].float()
        vblk = v[:, :, j * block_k:(j + 1) * block_k].float()
        sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kblk) * scale
        cols = j * block_k + torch.arange(block_k, device=q.device)[None, :]
        mask = cols < s
        if causal:
            mask = mask & (rows >= cols)
        if window:
            mask = mask & (rows - cols < window)
        sc = torch.where(mask, sc, -1e30)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        del sc
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bhgts,bhsd->bhgtd", p, vblk))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, t, dv).to(q.dtype)


# ---- decode -----------------------------------------------------------

def _slots(cfg, max_len: int) -> int:
    return min(cfg.window, max_len) if cfg.window else max_len


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device=None
                   ) -> dict:
    """Full cache of ``max_len`` slots, or a ring of ``min(window,
    max_len)`` for a window; empty (pos −1)."""
    _check_cfg(cfg)
    slots = _slots(cfg, max_len)
    shape = (batch, cfg.n_kv_heads, slots, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
    }


def _flash_mesh():
    """The ambient mesh where it has a ``"model"`` axis, else None."""
    from repro_torch.launch.mesh import axis_names, get_mesh
    mesh = get_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return None
    return mesh


def gqa_decode(cfg, params: GQA, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, flash: bool = False
               ) -> tuple[torch.Tensor, dict]:
    """x [B, 1, D]; pos int32[] — global index of the new token.  Writes
    the token's k/v and position into ``cache`` in place.  ``flash``:
    flash decoding over the model axis's blocks of the cache's slots
    under an ambient mesh (module docstring)."""
    b = x.shape[0]
    posb = pos.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = gqa_qkv(cfg, params, x, posb)
    mesh = _flash_mesh() if flash else None
    slots = cache["k"].shape[2]
    new = {"k": k_new.to(cache["k"].dtype), "v": v_new.to(cache["v"].dtype),
           "pos": posb.to(torch.int32)}
    if mesh is None:
        slot = (pos % slots).reshape(1).long()
    else:   # this rank's block of the slots; another rank's slot: unchanged
        from repro_torch.launch.mesh import axis_group, model_axis_size
        group, m = axis_group(mesh, "model")
        slot = pos % (slots * model_axis_size(mesh))
        owned = slot // slots == m          # on the device: no host sync
        slot = torch.clamp(slot - m * slots, 0, slots - 1).reshape(1).long()
        for key, dim in (("k", 2), ("v", 2), ("pos", 1)):
            new[key] = torch.where(owned, new[key],
                                   cache[key].index_select(dim, slot))
    cache["k"].index_copy_(2, slot, new["k"])
    cache["v"].index_copy_(2, slot, new["v"])
    cache["pos"].index_copy_(1, slot, new["pos"])
    if mesh is None:
        out = _full_decode_attention(cfg, q, cache["k"], cache["v"],
                                     cache["pos"], pos)
    else:
        out = _flash_decode_attention(cfg, q, cache["k"], cache["v"],
                                      cache["pos"], pos, group)
    return _merge_heads(out) @ params.wo, cache


def _full_decode_attention(cfg, q, k, v, slot_pos, pos):
    hd = cfg.hd
    group = cfg.n_heads // cfg.n_kv_heads
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhqd,bhsd->bhqs", q.float(),
                          kx.float()) / (hd ** 0.5)
    valid = slot_pos >= 0
    if cfg.window:
        valid = valid & (slot_pos > pos - cfg.window)
    valid = valid & (slot_pos <= pos)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", probs, vx.float()).to(q.dtype)


def _flash_decode_attention(cfg, q, k, v, slot_pos, pos, group):
    """Attention of q over this rank's block of the slots, combined over
    ``group``: the partial (m, l, acc), m's max over the group, then
    l·corr and acc·corr summed (the reference's shard_map body)."""
    import torch.distributed as dist
    hd = cfg.hd
    group_size = cfg.n_heads // cfg.n_kv_heads
    kx = torch.repeat_interleave(k, group_size, dim=1)
    vx = torch.repeat_interleave(v, group_size, dim=1)
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kx.float()) / (hd ** 0.5)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window:
        valid = valid & (slot_pos > pos - cfg.window)
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    m = torch.amax(s, dim=-1)                       # [B, H, 1] local
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhqs,bhsd->bhqd", p, vx.float())
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    # l·corr and acc·corr summed in one all-reduce.
    both = torch.cat([(l * corr)[..., None], acc * corr[..., None]], -1)
    dist.all_reduce(both, group=group)
    l_g, acc_g = both[..., 0], both[..., 1:]
    return (acc_g / torch.clamp(l_g, min=1e-30)[..., None]).to(q.dtype)


def gqa_prefill(cfg, params: GQA, x: torch.Tensor, positions: torch.Tensor,
                max_len: int, unroll: bool = False, use_kernel: bool = True,
                tp=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode cache: k/v and
    positions of the last ``slots`` tokens of the prompt (all of them
    when it is shorter), each in its ring slot ``pos % slots``, where
    ``slots`` is ``max_len`` or ``min(window, max_len)``.  A window takes
    ``blocked_attention`` above ``BLOCKED_THRESHOLD`` and
    ``_windowed_attention`` below it.  ``unroll`` is accepted and ignored
    (eager PyTorch has no scan).  ``tp``: the rank's heads, the cache's KV
    heads gathered whole over the model axis."""
    hd = cfg.hd
    b, t, _ = x.shape
    if tp is not None:
        x = tp.enter(x)
    q, k, v = gqa_qkv(cfg, params, x, positions, tp)
    if not cfg.window:
        out = _attend(q, k, v, True, use_kernel)
    elif t * t > BLOCKED_THRESHOLD:
        out = blocked_attention(q, k, v, causal=True, window=cfg.window)
    else:
        out = _windowed_attention(q, k, v, cfg.window)
    y = _merge_heads(out) @ params.wo
    del q, out
    if tp is not None:
        y = tp.exit(y)
        k, v = tp.gather_heads(k), tp.gather_heads(v)

    slots = _slots(cfg, max_len)
    pos2 = positions if positions.dim() == 2 else positions[0]
    if t >= slots:          # keep the last ``slots`` positions (ring order)
        k_keep, v_keep = k[:, :, t - slots:], v[:, :, t - slots:]
        pos_keep = pos2[:, t - slots:]
    else:
        pad = slots - t
        k_keep = nn.functional.pad(k, (0, 0, 0, pad))
        v_keep = nn.functional.pad(v, (0, 0, 0, pad))
        pos_keep = nn.functional.pad(pos2, (0, pad), value=-1)
    # Ring slot per kept position; padding slots (-1) fall back to their own
    # index (no collision: live slots occupy pos % slots, and when padding
    # exists t < slots so live ring values are the identity on [0, t)).
    own = torch.arange(slots, dtype=torch.int64, device=x.device)[None, :]
    ring_safe = torch.where(pos_keep >= 0, pos_keep.long() % slots, own)
    bidx = torch.arange(b, device=x.device)[:, None]
    cache_k = torch.zeros((b, cfg.n_kv_heads, slots, hd), dtype=x.dtype,
                          device=x.device)
    cache_v = torch.zeros_like(cache_k)
    cache_k[bidx, :, ring_safe] = k_keep.transpose(1, 2).to(x.dtype)
    cache_v[bidx, :, ring_safe] = v_keep.transpose(1, 2).to(x.dtype)
    cache_pos = torch.full((b, slots), -1, dtype=torch.int32,
                           device=x.device)
    cache_pos[bidx, ring_safe] = torch.where(
        pos_keep >= 0, pos_keep, -1).to(torch.int32)
    return y, {"k": cache_k, "v": cache_v, "pos": cache_pos}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, minicpm3).
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """w_dq [D, q_rank], w_uq [q_rank, H·(nope + rope)], w_dkv [D,
    kv_rank], w_uk and w_uv [kv_rank, H·nope], w_kr [D, rope], wo [H·nope,
    D] in the config dtype; q_norm [q_rank] and kv_norm [kv_rank] float32
    (nope = ``cfg.hd``, rope = ``cfg.mla_rope_dim``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, dt = cfg.d_model, cfg.n_heads, dtype_of(cfg.dtype)
        nope, rope = cfg.hd, cfg.mla_rope_dim
        qr, kvr = cfg.mla_q_rank, cfg.mla_kv_rank
        self.w_dq = _param(d, qr, dtype=dt, device=device)
        self.w_uq = _param(qr, h * (nope + rope), dtype=dt, device=device)
        self.w_dkv = _param(d, kvr, dtype=dt, device=device)
        self.w_uk = _param(kvr, h * nope, dtype=dt, device=device)
        self.w_uv = _param(kvr, h * nope, dtype=dt, device=device)
        self.w_kr = _param(d, rope, dtype=dt, device=device)
        self.wo = _param(h * nope, d, dtype=dt, device=device)
        self.q_norm = _param(qr, dtype=torch.float32, device=device)
        self.kv_norm = _param(kvr, dtype=torch.float32, device=device)


def init_mla(attn: MLA, cfg, gen: torch.Generator) -> None:
    s = cfg.d_model ** -0.5
    normal_(attn.w_dq, s, gen)
    normal_(attn.w_uq, cfg.mla_q_rank ** -0.5, gen)
    normal_(attn.w_dkv, s, gen)
    normal_(attn.w_uk, cfg.mla_kv_rank ** -0.5, gen)
    normal_(attn.w_uv, cfg.mla_kv_rank ** -0.5, gen)
    normal_(attn.w_kr, s, gen)
    normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)
    attn.q_norm.fill_(1.0)
    attn.kv_norm.fill_(1.0)


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm in float32 with eps 1e-6 (the reference's MLA ``_rms``),
    back in x's dtype."""
    xf = x.float()
    r = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf / r * scale).to(x.dtype)


def _mla_forward(cfg, params: MLA, x: torch.Tensor, positions: torch.Tensor,
                 causal: bool
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [B, T, D], the latent c [B, T, kv_rank], the rotated rope key kr
    [B, T, rope]), all in x's dtype.  The rope key is one head, rotated,
    then broadcast across the H heads."""
    b, t, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    cq = _rms(x @ params.w_dq, params.q_norm)
    q = (cq @ params.w_uq).reshape(b, t, h, nope + rope).permute(0, 2, 1, 3)
    q_nope, q_rope = q[..., :nope], q[..., nope:]             # [B,H,T,·]
    c = _rms(x @ params.w_dkv, params.kv_norm)                # [B,T,kvr]
    k_nope = _split_heads(c @ params.w_uk, h, nope)
    v = _split_heads(c @ params.w_uv, h, nope)
    k_rope = apply_rope((x @ params.w_kr)[:, None],
                        positions[:, None])                   # [B,1,T,rope]
    q_rope = apply_rope(q_rope, positions[:, None])
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, h, t, rope)], dim=-1)
    if t * t > BLOCKED_THRESHOLD:
        out = blocked_attention(qf, kf, v, causal=causal)
    else:
        out = attention_ref(qf.float(), kf.float(), v.float(),
                            causal=causal).to(x.dtype)
    return _merge_heads(out) @ params.wo, c, k_rope[:, 0]


def mla_train(cfg, params: MLA, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, use_kernel: bool = True,
              unroll: bool = False) -> torch.Tensor:
    """x [B, T, D]; positions [B, T].  ``use_kernel`` and ``unroll`` are
    accepted and ignored: MLA runs no kernel (the module docstring)."""
    return _mla_forward(cfg, params, x, positions, causal)[0]


def mla_prefill(cfg, params: MLA, x: torch.Tensor, positions: torch.Tensor,
                max_len: int, unroll: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """MLA forward and the latent cache of the prompt: c and kr of its T
    tokens in slots 0..T-1 of ``max_len`` (>= T), zeros after."""
    t = x.shape[1]
    if max_len < t:
        raise ValueError(f"an MLA cache of {max_len} slots cannot hold a "
                         f"prompt of {t}")
    y, c, kr = _mla_forward(cfg, params, x, positions, True)
    pad = max_len - t
    return y, {"c": nn.functional.pad(c, (0, 0, 0, pad)).to(x.dtype),
               "kr": nn.functional.pad(kr, (0, 0, 0, pad)).to(x.dtype)}


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device=None
                   ) -> dict:
    return {
        "c": torch.zeros((batch, max_len, cfg.mla_kv_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, max_len, cfg.mla_rope_dim), dtype=dtype,
                          device=device),
    }


def mla_decode(cfg, params: MLA, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Absorbed-matmul MLA decode: x [B, 1, D], pos int32[].  Writes the
    token's c and kr into slot ``pos`` of ``cache`` in place; attention runs
    in latent space (w_uk absorbed into the query, w_uv into the output)
    over the slots up to ``pos``, in float32, the scores divided by
    sqrt(nope + rope)."""
    b = x.shape[0]
    h, nope, rope = cfg.n_heads, cfg.hd, cfg.mla_rope_dim
    kvr = cfg.mla_kv_rank
    cq = _rms(x @ params.w_dq, params.q_norm)
    q = (cq @ params.w_uq).reshape(b, 1, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]             # [B,1,H,·]
    posb = pos.reshape(1, 1).expand(b, 1)
    q_rope = apply_rope(q_rope.transpose(1, 2),
                        posb[:, None]).transpose(1, 2)
    c_new = _rms(x @ params.w_dkv, params.kv_norm)            # [B,1,kvr]
    kr_new = apply_rope((x @ params.w_kr)[:, None],
                        posb[:, None])[:, 0]                  # [B,1,rope]
    slot = pos.reshape(1).long()
    cache["c"].index_copy_(1, slot, c_new.to(cache["c"].dtype))
    cache["kr"].index_copy_(1, slot, kr_new.to(cache["kr"].dtype))
    cache_c = cache["c"].float()

    # Absorb w_uk into the query: q_c[b,h,r] = sum_n q_nope w_uk[r,(h,n)].
    w_uk = params.w_uk.reshape(kvr, h, nope)
    q_c = torch.einsum("bqhn,rhn->bhqr", q_nope.float(), w_uk.float())
    scores = (torch.einsum("bhqr,bsr->bhqs", q_c, cache_c)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             cache["kr"].float())
              ) / ((nope + rope) ** 0.5)
    valid = torch.arange(cache_c.shape[1], device=x.device) <= pos
    scores = scores.masked_fill(~valid[None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bhqr", probs, cache_c)      # [B,H,1,kvr]
    w_uv = params.w_uv.reshape(kvr, h, nope)
    out = torch.einsum("bhqr,rhn->bhqn", ctx, w_uv.float()).to(x.dtype)
    return _merge_heads(out) @ params.wo, cache


# ---------------------------------------------------------------------------
# Cross-attention (the Whisper decoder).
# ---------------------------------------------------------------------------

def init_cross(attn: GQA, cfg, gen: torch.Generator) -> None:
    """The cross-attention's wq, wk, wv, wo: a GQA's, with its scales."""
    init_gqa(attn, cfg, gen)


def cross_attend(cfg, params: GQA, x: torch.Tensor, enc_kv: tuple, tp=None
                 ) -> torch.Tensor:
    """x [B, T, D]; enc_kv = (k, v), each [B, H_kv, S_enc, Dh], from
    :func:`encode_cross_kv` (kept in the cache for the whole decode).
    Non-causal ``attention_ref`` in float32, back in x's type.  ``tp``:
    the rank's heads, ``enc_kv`` its KV heads."""
    if tp is not None:
        x = tp.enter(x)
    q = _split_heads(mm(x, params.wq), _heads(cfg, tp)[0], cfg.hd)
    k, v = enc_kv
    out = attention_ref(q.float(), k.float(), v.float(),
                        causal=False).to(x.dtype)
    y = mm(_merge_heads(out), params.wo)
    return y if tp is None else tp.exit(y)


def encode_cross_kv(cfg, params: GQA, enc_out: torch.Tensor, tp=None
                    ) -> tuple:
    """The encoder output [B, S_enc, D] -> (k, v), each [B, H_kv, S_enc,
    Dh], in the promoted type of ``enc_out`` and the weights (float32 for
    float32 frames against a bf16 model, as in the reference); with
    ``tp`` the rank's KV heads."""
    if tp is not None:
        enc_out = tp.enter(enc_out)
    h_kv = _heads(cfg, tp)[1]
    k = _split_heads(mm(enc_out, params.wk), h_kv, cfg.hd)
    v = _split_heads(mm(enc_out, params.wv), h_kv, cfg.hd)
    return (k, v)
