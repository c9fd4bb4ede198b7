"""Public op: fold a delta buffer into dense state through the
delta_scatter kernel.

On a CUDA tensor :func:`delta_scatter` launches the kernel
(``csrc/delta_scatter.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import DeltaBuffer
from repro_torch.kernels.delta_scatter.ref import delta_scatter_ref

OPS = {"add": 0, "min": 1, "max": 2}

launches = 0         # kernel launches since the last reset


def delta_scatter(state: torch.Tensor, keys: torch.Tensor,
                  payload: torch.Tensor, combiner: str = "add",
                  key_base: int = 0) -> torch.Tensor:
    """state f32[N, W]; keys int32[C]; payload f32[C, W].  Returns the new
    state (the input is not modified): delta i lands in row
    ``keys[i] - key_base`` when that row is in [0, N) and is dropped
    otherwise, the PAD_KEY (-1) padding with it.  A shard passes its
    incoming buffer's global keys and ``key_base = shard_id * block``.  Add
    for any W, min/max for W = 1."""
    key_base = int(key_base)
    if key_base < 0:
        raise ValueError(f"key_base must be >= 0, got {key_base}")
    if not state.is_cuda:
        return delta_scatter_ref(state, keys, payload, combiner, key_base)
    if combiner not in OPS:
        raise ValueError(f"unsupported combiner {combiner!r}")
    n, w = state.shape
    if combiner != "add" and w != 1:
        raise ValueError("min/max combiners support W=1 payloads")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    out = torch.empty((n, w), dtype=torch.float32, device=state.device)
    if out.data_ptr() % 16:
        raise ValueError("delta_scatter: the output must be 16-byte aligned")
    out.copy_(state)
    err = lib.delta_scatter(
        out.data_ptr(), _build.ptr(keys, torch.int32, "keys"),
        _build.ptr(payload, torch.float32, "payload"), n, w, keys.shape[0],
        key_base, OPS[combiner], _build.stream_of(state))
    _build.check(err, "delta_scatter")
    launches += 1
    return out


def apply_delta(state: torch.Tensor, db: DeltaBuffer, combiner: str = "add"
                ) -> torch.Tensor:
    """Fold a DeltaBuffer (keys index rows) into dense state[N] or
    state[N, W]."""
    squeeze = state.dim() == 1
    st = state[:, None] if squeeze else state
    out = delta_scatter(st.contiguous(), db.keys.contiguous(),
                        db.payload[:, :st.shape[1]].contiguous(), combiner)
    return out[:, 0] if squeeze else out
