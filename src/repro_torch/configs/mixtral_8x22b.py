"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088; hf].

Sliding-window attention (4096) bounds the decode KV cache to a ring of
``window`` slots (models/attention.py).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16_384,
    vocab=32_768, head_dim=128,
    unit=("moe",), n_experts=8, top_k=2, window=4096,
    rope_kind="rope", norm_kind="rmsnorm",
    long_context_ok=True, decode_ok=True,
))
