"""whisper-large-v3 [audio]: 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866 — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Encoder-decoder: 32 bidirectional encoder layers over 1500 precomputed
frame embeddings (the conv frontend is a STUB — the caller supplies the
frames), 32 decoder layers with causal self-attn + cross-attn.
Decode shapes run (the decoder IS autoregressive); long_500k is skipped
(full attention decoder).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51_866, head_dim=64,
    unit=("dec_cross",), encoder_layers=32, encoder_seq=1500,
    rope_kind="none", norm_kind="layernorm", frontend="audio_stub",
    long_context_ok=False, decode_ok=True,
))
