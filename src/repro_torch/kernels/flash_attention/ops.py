"""Public op: attention through the flash_attention kernel.

On a CUDA tensor :func:`attention` launches the kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).  On either device it takes the kernel's contract:
D in {16, 32, 64, 128}, H a multiple of H_kv, and T = S when causal (the
kernel aligns the diagonal top-left, the plain version bottom-right; they
agree only at T = S).  Any T and S otherwise: the kernel masks its ragged
edges, so there is no block-multiple condition.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
TILE = 64              # query rows of one block

launches = 0           # kernel launches since the last reset


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q [B, H, T, D] and k, v "
                         f"[B, H_kv, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    bk, h_kv, s, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q is {tuple(q.shape)} but k is {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got D={d}")
    if h_kv < 1 or h % h_kv:
        raise ValueError(f"H={h} must be a multiple of H_kv={h_kv} (GQA)")
    if causal and t != s:
        raise ValueError(f"causal attention needs T == S, got T={t} S={s}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q f32[B, H, T, D]; k/v f32[B, H_kv, S, D] -> f32[B, H, T, D]."""
    _check_shapes(q, k, v, causal)
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal)
    b, h, t, d = q.shape
    _, h_kv, s, _ = k.shape
    if b * h >= 2 ** 31 or -(-t // TILE) >= 2 ** 16:
        raise ValueError(f"grid too large: B*H={b * h}, T={t}")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    out = torch.empty_like(q)
    p = _build.ptr
    err = lib.flash_attention(
        p(q, torch.float32, "q"), p(k, torch.float32, "k"),
        p(v, torch.float32, "v"), b, h, h_kv, t, s, d, int(causal),
        out.data_ptr(), _build.stream_of(q))
    _build.check(err, "flash_attention")
    launches += 1
    return out
