"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304 —
non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50_304, head_dim=128,
    unit=("dense",), rope_kind="rope", norm_kind="nonparam_ln",
    tie_embeddings=True,
    long_context_ok=False, decode_ok=True,
))
