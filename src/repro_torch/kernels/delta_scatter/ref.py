"""Plain torch version of the delta_scatter kernel: the keys made local as
``emission.to_local_keys`` makes them, then ``emission.fold``, the function
behind ``emission.scatter_local``."""
from __future__ import annotations

import torch

from repro_torch.algorithms.emission import fold
from repro_torch.core.delta import PAD_KEY


def delta_scatter_ref(state: torch.Tensor, keys: torch.Tensor,
                      payload: torch.Tensor, combiner: str = "add",
                      key_base: int = 0) -> torch.Tensor:
    """Same contract as ``ops.delta_scatter``: a new f32[N, W] with delta i
    folded into row ``keys[i] - key_base``; rows outside [0, N) (the -1
    padding included) are dropped.  Adds land in slot order."""
    local = torch.where(keys == PAD_KEY, -1, keys - key_base)
    return fold(state, local, payload, combiner)
