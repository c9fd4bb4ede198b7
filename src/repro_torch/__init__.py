"""PyTorch/CUDA port of the REX reproduction (``repro``).

Mirrors ``repro``'s layout (``core/``, ``algorithms/``, ``data/``,
``kernels/<name>/``).  Imports torch and numpy only; CUDA kernels are built
and loaded on first use (``kernels/_build.py``).  Entry points take
``device=None``, which means ``"cuda"``.

Importing the package itself loads no torch: a launch worker
(``python -m repro_torch.launch._worker``) imports the stdlib and
``launch/channel.py`` only, and this module is imported first.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from repro_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
