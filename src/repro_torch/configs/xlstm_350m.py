"""xlstm-350m [ssm]: 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Alternating (mLSTM, sLSTM) units.  mLSTM's matrix memory is computed in
chunked-parallel form (see models/ssm.py); sLSTM's recurrent connection
forces a sequential time scan.  Constant-size state ⇒ long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50_304, head_dim=256,
    unit=("mlstm", "slstm"), rope_kind="none", norm_kind="layernorm",
    mlstm_chunk=64,
    long_context_ok=True, decode_ok=True,
))
