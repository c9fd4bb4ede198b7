"""PyTorch/CUDA port of the REX reproduction (``repro``).

Mirrors ``repro``'s layout (``core/``, ``algorithms/``, ``data/``,
``kernels/<name>/``).  Imports torch and numpy only; CUDA kernels are built
and loaded on first use (``kernels/_build.py``).  Entry points take
``device=None``, which means ``"cuda"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
