"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
[hf:openbmb/MiniCPM3-4B; hf].

Multi-head Latent Attention: queries from a rank-768 projection, K/V from a
shared rank-256 latent plus a 32-dim decoupled RoPE key.  The decode cache
stores (latent, rope-key) — 288 floats/token instead of 2·H·Dh = 5120 —
MLA's serving advantage, realized in models/attention.py.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73_448, head_dim=64,
    unit=("mla",), mla_q_rank=768, mla_kv_rank=256, mla_rope_dim=32,
    rope_kind="rope", norm_kind="rmsnorm",
    long_context_ok=False, decode_ok=True,
))
