"""RG-LRU recurrent block (RecurrentGemma / Griffin; the reference's
``models/rglru.py``).

The Real-Gated Linear Recurrent Unit:

    r_t = σ(W_a x_t)             (recurrence gate)
    i_t = σ(W_x x_t)             (input gate)
    a_t = exp(−c·softplus(Λ)·r_t)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is linear in h, so the whole sequence is a scan over
(a, b) pairs under the associative combine (a1, b1)·(a2, b2) = (a2 a1,
a2 b1 + b2).  :func:`associative_scan` runs it as the reference's
``jax.lax.associative_scan`` does (its odd/even recursion): log2 T levels
of whole-tensor ops over the time axis, the products and sums in the
reference's order, never a T-step loop.  Decode carries h and the conv's
last ``conv_width - 1`` inputs: O(rnn_dim) state a sequence.

Block structure (Griffin): x → {gelu(W_gate·x)} ⊙ {RG-LRU(conv1d(W_in·x))}
→ W_out, with a causal depthwise conv of width ``cfg.conv_width``.
``w_in``, ``w_gate`` and ``w_out`` are in the config dtype, ``conv_w``,
``w_a``, ``w_x`` and ``lam`` (Λ) in float32; the recurrence runs in
float32 (float64 for a float64 model, :func:`layers.widen`).  The GELU is
the tanh form (``jax.nn.gelu``'s default) and softplus is
``logaddexp(x, 0)``, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _param, dtype_of, mm, normal_, widen

_C = 8.0  # Griffin's fixed gate sharpness


class RGLRU(nn.Module):
    """w_in, w_gate [D, R] and w_out [R, D] in the config dtype; conv_w
    [W, R], w_a, w_x [R, R] and lam [R] in float32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, r, dt = cfg.d_model, cfg.rnn_dim, dtype_of(cfg.dtype)
        f32 = torch.float32
        self.w_in = _param(d, r, dtype=dt, device=device)
        self.w_gate = _param(d, r, dtype=dt, device=device)
        self.conv_w = _param(cfg.conv_width, r, dtype=f32, device=device)
        self.w_a = _param(r, r, dtype=f32, device=device)
        self.w_x = _param(r, r, dtype=f32, device=device)
        self.lam = _param(r, dtype=f32, device=device)
        self.w_out = _param(r, d, dtype=dt, device=device)


def init_rglru(cell: RGLRU, cfg, gen: torch.Generator) -> None:
    """The reference's scales; Λ = linspace(0.9, 4.0, R), so that a ≈
    0.9..0.999 at r = 1 (Griffin's init range)."""
    d, r = cfg.d_model, cfg.rnn_dim
    normal_(cell.w_in, d ** -0.5, gen)
    normal_(cell.w_gate, d ** -0.5, gen)
    normal_(cell.conv_w, cfg.conv_width ** -0.5, gen)
    normal_(cell.w_a, r ** -0.5, gen)
    normal_(cell.w_x, r ** -0.5, gen)
    cell.lam.copy_(torch.linspace(0.9, 4.0, r, dtype=torch.float32))
    normal_(cell.w_out, r ** -0.5, gen)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))
    (torch's softplus is log1p(exp(x)) below its threshold)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, T, R], w [W, R]; the taps added in
    order, as the reference's."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return out


def _gates(params: RGLRU, u: torch.Tensor):
    """u [..., R] -> (a, b) of the linear recurrence h = a·h_prev + b."""
    r_gate = torch.sigmoid(mm(u, params.w_a))
    i_gate = torch.sigmoid(mm(u, params.w_x))
    log_a = -_C * _softplus(params.lam) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * u)
    return a, b


def _combine(e1, e2):
    """(a1, b1) then (a2, b2): (a2·a1, a2·b1 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along axis 1 (``even`` has as many rows as
    ``odd`` or one more)."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) [B, T, ...] over axis 1 under
    :func:`_combine`: ``jax.lax.associative_scan``'s recursion (JAX 0.9.0,
    ``loops.associative_scan._scan``), the same combines of the same
    elements.  Adjacent pairs are combined, the reduced sequence is
    scanned recursively (the odd outputs), the evens are the odd outputs
    combined with the next even input, with element 0 as it is, and the
    two are interleaved.  log2 T levels, each a few whole-tensor ops."""
    t = a.shape[1]
    if t < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    prev = odd if t % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(prev, (a[:, 2::2], b[:, 2::2]))
    return tuple(_interleave(torch.cat([x[:, :1], e], dim=1), o)
                 for x, e, o in zip((a, b), even, odd))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rglru_forward(cfg, params: RGLRU, x: torch.Tensor,
                  return_state: bool = False):
    """x [B, T, D] -> [B, T, D] in x's dtype; with ``return_state`` also
    the decode state {"h": h_T [B, R], "conv": the last W − 1 conv inputs
    [B, W − 1, R], zeros before the first}."""
    gate = _gelu(widen(mm(x, params.w_gate)))
    u_raw = widen(mm(x, params.w_in))
    u = _causal_conv(u_raw, params.conv_w)
    a, b = _gates(params, u)
    _, h = associative_scan(a, b)
    y = mm(h * gate, params.w_out).to(x.dtype)
    if not return_state:
        return y
    w = params.conv_w.shape[0]
    t = x.shape[1]
    if t >= w - 1:
        conv_state = u_raw[:, t - (w - 1):].clone()
    else:
        conv_state = F.pad(u_raw, (0, 0, w - 1 - t, 0))
    return y, {"h": h[:, -1].clone(), "conv": conv_state}


def init_rglru_state(cfg, batch: int, device=None) -> dict:
    r = cfg.rnn_dim
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                dtype=torch.float32, device=device)}


def rglru_decode(cfg, params: RGLRU, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """x [B, 1, D]: one step of the recurrence; the conv is an einsum over
    the history (the state's inputs and this one), as the reference's.
    Returns (y [B, 1, D], the new state)."""
    gate = _gelu(widen(mm(x[:, 0], params.w_gate)))
    u = widen(mm(x[:, 0], params.w_in))                        # [B, R]
    hist = torch.cat([state["conv"], u[:, None]], dim=1)
    u_conv = torch.einsum("bwr,wr->br", hist, params.conv_w.to(hist.dtype))
    a, b = _gates(params, u_conv)
    h = a * state["h"] + b
    y = mm(h * gate, params.w_out).to(x.dtype)[:, None]
    return y, {"h": h, "conv": hist[:, 1:].clone()}
