"""Plain torch versions of the flash_attention kernels: the materialised-
scores attention of ``repro/kernels/flash_attention/ref.py``, and its
gradient in the three steps of the backward kernel."""
from __future__ import annotations

import torch


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


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`attention_ref` at (q, k, v) against ``do``,
    given its output ``o`` -> (dq, dk, dv), computed as the kernel does:
    (1) the rows' log-sum-exp of the scores and Delta = rowsum(do * o),
    (2) dV = P^T do and dK = dS^T q / sqrt(D), summed over each KV head's
    query heads, (3) dQ = dS k / sqrt(D), where P = exp(scores - lse) and
    dS = P * (do v^T - Delta).  Materialises the [B, H, T, S] scores."""
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    group = h // h_kv
    scores = _scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - lse)
    delta = (do * o).sum(-1, keepdim=True)
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    dv = torch.einsum("bhts,bhtd->bhsd", p, do)
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do, vx) - delta)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kx) / (d ** 0.5)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q) / (d ** 0.5)
    return (dq, dk.reshape(b, h_kv, group, s, d).sum(2),
            dv.reshape(b, h_kv, group, s, d).sum(2))
