"""xLSTM blocks: chunked-parallel mLSTM and sequential sLSTM (the
reference's ``models/ssm.py``).

mLSTM (matrix memory): per head, ``C_t = f_t·C_{t−1} + i_t·k_t v_tᵀ`` with
stabilized exponential gating; ``h_t = C_t q_t / max(|n_t·q_t|, e^{−m_t})``.
The forward uses the **chunked-parallel form** (as in GLA / mamba-2):
within a chunk of ``cfg.mlstm_chunk`` tokens the contribution is a masked
attention-like product; across chunks only the boundary state (C, n, m)
recurs, in a Python loop over the chunks (the reference's ``lax.scan``).

Derivation used below (per head; g_s = ĩ_s − F_s, F = cumsum log f):
    M_c   = max(m₀, cummax_{s≤c} g_s)            (stabilizer, query c)
    w_cs  = exp(g_s − M_c)·[s ≤ c]               (intra-chunk weights)
    num_c = e^{m₀−M_c}·C₀ᵀq_c + Σ_s w_cs (k_s·q_c) v_s
    den_c = e^{m₀−M_c}·n₀·q_c + Σ_s w_cs (k_s·q_c)
    h_c   = num_c / max(|den_c|, e^{−(M_c+F_c)})
with the carry advanced to the chunk end the same way.

sLSTM (scalar memory, recurrent connection R·h_{t−1} inside the gates) is
sequential: a loop over time with block-diagonal per-head recurrent
weights (the reference's ``lax.scan``).  In eager PyTorch each step is a
handful of launches, so its forward is bound by the host.

Projections (``wq``, ``wk``, ``wv``, ``out_gate``, ``wo``, ``w_gates``)
are in the config dtype; ``w_if`` and ``r_gates`` and every state in
float32.  Each cast of the reference to float32 is :func:`layers.widen`,
so a float64 copy of a block computes in float64.

Under FakeTensorMode (the dry run, ``launch/dryrun.py``) each time loop,
the mLSTM's over chunks and the sLSTM's over steps, runs one trip and
repeats its output for the others: the dry run counts one trip, as XLA's
cost analysis counts a while body once, and ``launch/roofline.py``'s
``xlstm_correction`` adds the other trips, as for the reference.  Traced
in full, the sLSTM loop is T eager steps a layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (_param, dtype_of, is_fake, mm,
                                       normal_, widen)


# ---------------------------------------------------------------------------
# mLSTM.
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """wq, wk, wv, out_gate [D, H·hd] and wo [H·hd, D] in the config dtype;
    w_if [D, 2H] (input and forget gate pre-activations) in float32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hh, dt = cfg.d_model, cfg.n_heads * cfg.hd, dtype_of(cfg.dtype)
        self.wq = _param(d, hh, dtype=dt, device=device)
        self.wk = _param(d, hh, dtype=dt, device=device)
        self.wv = _param(d, hh, dtype=dt, device=device)
        self.w_if = _param(d, 2 * cfg.n_heads, dtype=torch.float32,
                           device=device)
        self.out_gate = _param(d, hh, dtype=dt, device=device)
        self.wo = _param(hh, d, dtype=dt, device=device)


def init_mlstm(cell: MLSTM, cfg, gen: torch.Generator) -> None:
    s = cfg.d_model ** -0.5
    for w in (cell.wq, cell.wk, cell.wv, cell.w_if, cell.out_gate):
        normal_(w, s, gen)
    normal_(cell.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)


def _mlstm_chunk_body(carry, inp):
    """One chunk: carry (C [B,H,hd,hd], n [B,H,hd], m [B,H]); inp (q, k, v
    [B,CH,H,hd], log_i, log_f [B,CH,H]).  Returns (carry', out
    [B,CH,H,hd])."""
    C0, n0, m0 = carry
    qc, kc, vc, log_i, log_f = inp
    F_ = torch.cumsum(log_f, dim=1)                        # [B,CH,H]
    g = log_i - F_                                         # [B,CH,H]
    M = torch.maximum(m0[:, None], torch.cummax(g, dim=1).values)

    scores_qk = torch.einsum("bchd,bshd->bcsh", qc, kc)    # [B,CQ,CS,H]
    ch = qc.shape[1]
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=qc.device))
    w = torch.where(mask[None, :, :, None],
                    torch.exp(g[:, None] - M[:, :, None]), 0.0)
    scores = scores_qk * w                                 # [B,CQ,CS,H]
    inter_decay = torch.exp(m0[:, None] - M)               # [B,CH,H]
    num = (torch.einsum("bchd,bhde->bche", qc, C0) * inter_decay[..., None]
           + torch.einsum("bcsh,bshd->bchd", scores, vc))
    den = (torch.einsum("bchd,bhd->bch", qc, n0) * inter_decay
           + torch.sum(scores, dim=2))
    floor = torch.exp(-(M + F_))
    out = num / torch.maximum(torch.abs(den), floor)[..., None]

    # Advance carry to chunk end.
    F_L = F_[:, -1]                                        # [B,H]
    M_L = torch.maximum(m0, torch.amax(g, dim=1))
    k_decay = torch.exp(g - M_L[:, None])                  # [B,CH,H]
    C_new = (torch.exp(m0 - M_L)[..., None, None] * C0
             + torch.einsum("bshd,bshe->bhde", kc * k_decay[..., None], vc))
    n_new = (torch.exp(m0 - M_L)[..., None] * n0
             + torch.einsum("bshd,bsh->bhd", kc, k_decay))
    return (C_new, n_new, M_L + F_L), out


def mlstm_forward(cfg, params: MLSTM, x: torch.Tensor,
                  return_state: bool = False):
    """x [B, T, D] -> [B, T, D] (T padded up to a chunk multiple; causal,
    so trailing padding never affects real positions, and the padding
    steps are identity on the carried state: f = 1, i = 0, so the returned
    state is the state after the last real token)."""
    b, t_orig, d = x.shape
    h, hd, ch = cfg.n_heads, cfg.hd, cfg.mlstm_chunk
    pad = (-t_orig) % ch
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, d))], dim=1)
    t = x.shape[1]
    nc = t // ch
    q = widen(mm(x, params.wq)).reshape(b, nc, ch, h, hd)
    k = widen(mm(x, params.wk)).reshape(b, nc, ch, h, hd) / hd ** 0.5
    v = widen(mm(x, params.wv)).reshape(b, nc, ch, h, hd)
    gates = mm(widen(x), params.w_if).reshape(b, nc, ch, 2, h)
    log_i = gates[..., 0, :]
    log_f = F.logsigmoid(gates[..., 1, :])
    if pad:
        # Padding steps must be identity on the carried state: f=1 (no
        # decay), i=0 (no injection); otherwise the returned prefill
        # state would have been forgotten ``pad`` extra times.
        is_pad = (torch.arange(t, device=x.device) >= t_orig).reshape(
            1, nc, ch, 1)
        log_f = torch.where(is_pad, 0.0, log_f)
        log_i = torch.where(is_pad, -1e30, log_i)

    dt = q.dtype
    carry = (torch.zeros((b, h, hd, hd), dtype=dt, device=x.device),
             torch.zeros((b, h, hd), dtype=dt, device=x.device),
             torch.zeros((b, h), dtype=dt, device=x.device))
    outs = []
    trips = 1 if is_fake(x) else nc     # the dry run's one trip
    for c in range(trips):
        carry, out = _mlstm_chunk_body(
            carry, (q[:, c], k[:, c], v[:, c], log_i[:, c], log_f[:, c]))
        outs.append(out)
    outs = _repeat_last(torch.stack(outs, dim=1), 1, nc)
    outs = outs.reshape(b, t, h * hd)
    gate = torch.sigmoid(widen(mm(x, params.out_gate)))
    y = mm(outs * gate, params.wo).to(x.dtype)[:, :t_orig]
    if return_state:
        C, n, m = carry
        return y, {"C": C, "n": n, "m": m}
    return y


def _repeat_last(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with its last entry along ``dim`` repeated up to ``n``
    entries (the dry run's one trip standing for the others)."""
    if x.shape[dim] == n:
        return x
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, last.expand(shape)], dim=dim)


def init_mlstm_state(cfg, batch: int, device=None) -> dict:
    h, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.zeros((batch, h), dtype=f32, device=device)}


def mlstm_decode(cfg, params: MLSTM, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """x [B, 1, D]: one recurrent step (a one-delta stratum over the
    mutable state).  Returns (y [B, 1, D], the new state)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    q = widen(mm(x, params.wq)).reshape(b, h, hd)
    k = widen(mm(x, params.wk)).reshape(b, h, hd) / hd ** 0.5
    v = widen(mm(x, params.wv)).reshape(b, h, hd)
    gates = mm(widen(x), params.w_if).reshape(b, 2, h)
    log_i, log_f = gates[:, 0], F.logsigmoid(gates[:, 1])
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    C = f_s[..., None, None] * state["C"] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)),
                        torch.exp(-m_new))
    out = (num / den[..., None]).reshape(b, 1, h * hd)
    gate = torch.sigmoid(widen(mm(x, params.out_gate)))
    y = mm(out * gate, params.wo).to(x.dtype)
    return y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM.
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """w_gates [D, 4·H·hd] (the i, f, z, o gates' input part) and wo
    [H·hd, D] in the config dtype; r_gates [4, H, hd, hd] (the recurrent
    part, block-diagonal by head) in float32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, hd, dt = cfg.d_model, cfg.n_heads, cfg.hd, dtype_of(cfg.dtype)
        self.w_gates = _param(d, 4 * h * hd, dtype=dt, device=device)
        self.r_gates = _param(4, h, hd, hd, dtype=torch.float32,
                              device=device)
        self.wo = _param(h * hd, d, dtype=dt, device=device)


def init_slstm(cell: SLSTM, cfg, gen: torch.Generator) -> None:
    normal_(cell.w_gates, cfg.d_model ** -0.5, gen)
    normal_(cell.r_gates, cfg.hd ** -0.5, gen)
    normal_(cell.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)


def _recurrent_weight(params: SLSTM, dtype) -> torch.Tensor:
    """r_gates [4, H, hd, hd] as [H, hd, 4·hd] (head, input, gate-major
    output), so that one batched product a step gives every gate's
    recurrent part."""
    g, h, hd, _ = params.r_gates.shape
    return params.r_gates.to(dtype).permute(1, 2, 0, 3).reshape(h, hd,
                                                                g * hd)


def _slstm_step(r: torch.Tensor, carry, wx_t: torch.Tensor):
    """carry: (c, n, h, m) each [H, B, hd] (head-major); wx_t [H, B,
    4·hd]; r from :func:`_recurrent_weight`.  The pre-activations are
    wx_t + the reference's ``einsum("ghde,bhd->bghe", r_gates, h)``, one
    ``baddbmm`` (the float32 product, then the sum rounded once, as the
    reference's two steps round)."""
    c, n, hprev, m = carry
    h, b, hd = hprev.shape
    pre = torch.baddbmm(wx_t, hprev, r)                    # [H, B, 4·hd]
    i_t, f_t, z_t, o_t = pre.view(h, b, 4, hd).unbind(2)
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_t)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def _gate_inputs(params: SLSTM, x: torch.Tensor) -> torch.Tensor:
    """The gates' input part of x [B, T, D]: [T, H, B, 4·hd], each step's
    slice head-major."""
    b, t, _ = x.shape
    g, h, hd, _ = params.r_gates.shape
    wx = mm(widen(x), widen(params.w_gates)).reshape(b, t, g, h, hd)
    return wx.permute(1, 3, 0, 2, 4).reshape(t, h, b, g * hd)


def slstm_forward(cfg, params: SLSTM, x: torch.Tensor,
                  return_state: bool = False):
    """x [B, T, D] -> [B, T, D]: the gates' input part for every step at
    once, then T sequential steps."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    wx = _gate_inputs(params, x)
    r = _recurrent_weight(params, wx.dtype)
    carry = tuple(torch.zeros((h, b, hd), dtype=wx.dtype, device=x.device)
                  for _ in range(4))
    hs = []
    steps = 1 if is_fake(x) else t      # the dry run's one trip
    for i in range(steps):
        carry = _slstm_step(r, carry, wx[i])
        hs.append(carry[2])
    hs = _repeat_last(torch.stack(hs, dim=2), 2, t)
    hs = hs.permute(1, 2, 0, 3).reshape(b, t, h * hd)
    y = mm(hs, params.wo).to(x.dtype)
    if return_state:
        return y, dict(zip("cnhm", (s.transpose(0, 1) for s in carry)))
    return y


def init_slstm_state(cfg, batch: int, device=None) -> dict:
    shape = (batch, cfg.n_heads, cfg.hd)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}


def slstm_decode(cfg, params: SLSTM, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """x [B, 1, D]: one step.  Returns (y [B, 1, D], the new state, each
    [B, H, hd])."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    wx = _gate_inputs(params, x)[0]
    carry = tuple(state[k].transpose(0, 1) for k in "cnhm")
    new = _slstm_step(_recurrent_weight(params, wx.dtype), carry, wx)
    y = mm(new[2].transpose(0, 1).reshape(b, 1, h * hd), params.wo
           ).to(x.dtype)
    return y, dict(zip("cnhm", (s.transpose(0, 1) for s in new)))
