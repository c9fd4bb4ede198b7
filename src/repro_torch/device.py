"""Device choice for the port's entry points.

``device=None`` means ``"cuda"``.  Without CUDA an entry point raises: it
never carries on quietly on the CPU.  Callers that want the CPU (the tests)
ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
