"""Plain torch version of the flash_attention kernel: the materialised-
scores attention of ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q f32[B, H, T, D]; k/v f32[B, H_kv, S, D].  GQA by head repeat; the
    causal mask keeps ``s <= t + (S - T)`` (bottom-right aligned)."""
    _, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    group = h // h_kv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / (d ** 0.5)
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(
            s - t)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)
