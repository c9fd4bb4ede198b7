"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

Griffin pattern: repeating unit (recurrent, recurrent, local-attention);
26 = 8·3 + 2 ⇒ 8 full units + a (recurrent, recurrent) tail, kept exact.
RG-LRU recurrence (width 2560) is a linear scan ⇒ associative-scan
parallel over time; local attention window 2048.  Constant-size state +
bounded window ⇒ long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256,
    unit=("rec", "rec", "attn_local"), window=2048, rnn_dim=2560,
    conv_width=4, rope_kind="rope", norm_kind="rmsnorm",
    long_context_ok=True, decode_ok=True,
))
