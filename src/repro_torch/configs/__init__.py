"""Architecture configs: the reference's dense, MoE, MLA, VLM and
recurrent LMs and its Whisper encoder-decoder (``configs/base.py``)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, Shape, all_archs,
                                      cells, get_arch, register)

__all__ = ["SHAPES", "ArchConfig", "Shape", "all_archs", "cells",
           "get_arch", "register"]
