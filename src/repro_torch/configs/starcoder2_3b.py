"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12_288,
    vocab=49_152, head_dim=128,
    unit=("dense",), rope_kind="rope", norm_kind="layernorm",
    long_context_ok=False, decode_ok=True,
))
