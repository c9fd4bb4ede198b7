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


def delta_scatter(state: torch.Tensor, idx: torch.Tensor,
                  payload: torch.Tensor, combiner: str = "add"
                  ) -> torch.Tensor:
    """state f32[N, W]; idx int32[C] (out-of-range = padding); payload
    f32[C, W].  Returns the new state (the input is not modified): add for
    any W, min/max for W = 1."""
    if not state.is_cuda:
        return delta_scatter_ref(state, idx, payload, combiner)
    if combiner not in OPS:
        raise ValueError(f"unsupported combiner {combiner!r}")
    n, w = state.shape
    if combiner != "add" and w != 1:
        raise ValueError("min/max combiners support W=1 payloads")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    out = torch.empty((n, w), dtype=torch.float32, device=state.device)
    out.copy_(state)
    err = lib.delta_scatter(
        out.data_ptr(), _build.ptr(idx, torch.int32, "idx"),
        _build.ptr(payload, torch.float32, "payload"), n, w, idx.shape[0],
        OPS[combiner], _build.stream_of(state))
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
