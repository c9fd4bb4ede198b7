"""Plain torch versions of the flash_attention kernels: the materialised-
scores attention of ``repro/kernels/flash_attention/ref.py``, the bf16
forward kernel's statistic, and the gradient in the steps of the backward
kernels; and, for the tests of the bf16 backward, that gradient with the
kernel's roundings and the bound they need."""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
# bf16 keeps 8 significant bits: rounding to nearest moves a value by at
# most 2^-9 of itself; the bounds take 2^-8.
BF16_ULP = 2.0 ** -8


def _scores(q, k, causal: bool) -> torch.Tensor:
    """q k^T / sqrt(D) over the GQA-repeated k, masked to -inf above the
    bottom-right aligned diagonal when causal."""
    _, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    k = torch.repeat_interleave(k, h // h_kv, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / (d ** 0.5)
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(
            s - t)
        scores = scores.masked_fill(~mask, float("-inf"))
    return scores


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q f32[B, H, T, D]; k/v f32[B, H_kv, S, D].  GQA by head repeat; the
    causal mask keeps ``s <= t + (S - T)`` (bottom-right aligned)."""
    group = q.shape[1] // k.shape[1]
    v = torch.repeat_interleave(v, group, dim=1)
    probs = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


def lse2_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True
             ) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled, masked scores in the log2
    domain, [B, H, T]: the statistic the bf16 forward kernel writes."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1) * LOG2E


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _probs(q, k, v, o, do, causal):
    """P = exp(scores - lse) and dS = P * (do v^T - Delta), [B, H, T, S]."""
    group = q.shape[1] // k.shape[1]
    scores = _scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse)
    delta = (do * o).sum(-1, keepdim=True)
    vx = torch.repeat_interleave(v, group, dim=1)
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do, vx) - delta)
    return p, ds


def _bwd(q, k, v, o, do, causal, rnd):
    """(dq, dk, dv), each product's operand P or dS and each result passed
    through ``rnd`` (the identity, or a rounding to bf16)."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    group = h // h_kv
    p, ds = _probs(q, k, v, o, do, causal)
    kx = torch.repeat_interleave(k, group, dim=1)
    dv = torch.einsum("bhts,bhtd->bhsd", rnd(p), do)
    ds = rnd(ds)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kx) / (d ** 0.5)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q) / (d ** 0.5)
    return (rnd(dq), rnd(dk.reshape(b, h_kv, group, s, d).sum(2)),
            rnd(dv.reshape(b, h_kv, group, s, d).sum(2)))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`attention_ref` at (q, k, v) against ``do``,
    given its output ``o`` -> (dq, dk, dv), computed as the kernels do:
    (1) the rows' log-sum-exp of the scores and Delta = rowsum(do * o),
    (2) dV = P^T do and dK = dS^T q / sqrt(D), summed over each KV head's
    query heads, (3) dQ = dS k / sqrt(D), where P = exp(scores - lse) and
    dS = P * (do v^T - Delta).  Materialises the [B, H, T, S] scores."""
    return _bwd(q, k, v, o, do, causal, lambda x: x)


def attention_bwd_rounded(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                          causal: bool = True, roundings: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`attention_bwd_ref` with the bf16 backward kernel's roundings
    (``roundings``): P rounded to bf16 before P^T do, dS (computed from the
    unrounded P) before dS k and dS^T q, and dq, dk, dv once at the end,
    each product summed in the input dtype.  Used by the tests only; with
    ``roundings`` off it is :func:`attention_bwd_ref`."""
    return _bwd(q, k, v, o, do, causal,
                _round_bf16 if roundings else (lambda x: x))


def bf16_rounding_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What rounding P and dS to bf16 before their products can move each
    gradient, elementwise, in the dtype of the inputs (float32 for the
    bounds) -> (dq, dk, dv) terms: 2^-8 scale |dS| |k| for dq, 2^-8 scale
    sum_heads |dS|^T |q| for dk and 2^-8 sum_heads |P|^T |do| for dv
    (scale = 1/sqrt(D); the sums over each KV head's query heads).  Each
    rounded operand is off by at most 2^-9 of itself, so each product by at
    most 2^-9 of the product of magnitudes; 2^-8 leaves a factor 2."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    group = h // h_kv
    p, ds = _probs(q, k, v, o, do, causal)
    ds = ds.abs()
    kx = torch.repeat_interleave(k.abs(), group, dim=1)
    scale = BF16_ULP / math.sqrt(d)
    tq = torch.einsum("bhts,bhsd->bhtd", ds, kx) * scale
    tk = torch.einsum("bhts,bhtd->bhsd", ds, q.abs()) * scale
    tv = torch.einsum("bhts,bhtd->bhsd", p, do.abs()) * BF16_ULP
    return (tq, tk.reshape(b, h_kv, group, s, d).sum(2),
            tv.reshape(b, h_kv, group, s, d).sum(2))
