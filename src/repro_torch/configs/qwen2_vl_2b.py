"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub (the caller supplies
precomputed patch embeddings as ``embeds`` alongside text tokens).  M-RoPE
splits the rotary dims into (temporal, height, width) sections driven by
3-row position ids.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151_936, head_dim=128,
    unit=("dense",), rope_kind="mrope", norm_kind="rmsnorm",
    frontend="vision_stub", tie_embeddings=True,
    long_context_ok=False, decode_ok=True,
))
