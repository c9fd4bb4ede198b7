"""Plain torch version of the delta_scatter kernel: ``emission.fold``, the
function behind ``emission.scatter_local``."""
from __future__ import annotations

import torch

from repro_torch.algorithms.emission import fold


def delta_scatter_ref(state: torch.Tensor, idx: torch.Tensor,
                      payload: torch.Tensor, combiner: str = "add"
                      ) -> torch.Tensor:
    """Same contract as ``ops.delta_scatter``: a new f32[N, W] with each
    delta folded into row ``idx``; out-of-range idx (-1 padding included)
    are dropped.  Adds land in slot order."""
    return fold(state, idx, payload, combiner)
