"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab=128_256, head_dim=128,
    unit=("dense",), rope_kind="rope", norm_kind="rmsnorm",
    long_context_ok=False, decode_ok=True,
))
