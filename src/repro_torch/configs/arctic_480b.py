"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every block runs a small dense FFN *in parallel* with the
top-2-of-128 MoE FFN (``moe_dense_residual``).  Expert dispatch is the REX
rehash pattern (tokens = deltas keyed by expert; see models/moe.py).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32_000, head_dim=128,
    unit=("moe",), n_experts=128, top_k=2, moe_dense_residual=True,
    rope_kind="rope", norm_kind="rmsnorm",
    long_context_ok=False, decode_ok=True,
))
