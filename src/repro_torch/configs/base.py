"""Architecture configs and shape registry (the reference's
``configs/base.py``, copied: same fields, defaults and ``reduced()``).

All ten of the reference's configs are registered: the dense
``olmo-1b``, ``llama3-8b`` and ``starcoder2-3b``, the MoE ``arctic-480b``
and ``mixtral-8x22b``, ``minicpm3-4b`` (MLA), ``qwen2-vl-2b`` (M-RoPE,
vision stub), ``whisper-large-v3`` (encoder-decoder, sinusoid positions,
audio stub), ``recurrentgemma-2b`` (RG-LRU and local attention, a
two-layer tail) and ``xlstm-350m`` (mLSTM and sLSTM).

Shape semantics (LM family):
  train_4k     — train_step,  seq 4096,   global batch 256
  prefill_32k  — serve prefill, seq 32768, global batch 32
  decode_32k   — serve_step: ONE new token against a 32768 KV cache, batch 128
  long_500k    — serve_step at 524288 context, batch 1 — requires
                 sub-quadratic attention; skipped for pure full-attention
                 archs (recorded per-config in ``long_context_ok``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # Block pattern: repeating unit of layer kinds; n_layers = unit·U + tail.
    unit: Tuple[str, ...] = ("dense",)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False      # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    # attention
    window: int = 0               # 0 = full attention; >0 = sliding window
    rope_kind: str = "rope"       # rope|mrope|none
    # MLA (minicpm3)
    mla_kv_rank: int = 0
    mla_q_rank: int = 0
    mla_rope_dim: int = 0
    # recurrent dims
    rnn_dim: int = 0              # RG-LRU recurrence width
    conv_width: int = 4
    mlstm_chunk: int = 64
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0          # frames after conv frontend (stub)
    # norms
    norm_kind: str = "rmsnorm"    # rmsnorm|layernorm|nonparam_ln
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # capability flags
    long_context_ok: bool = False # sub-quadratic decode path exists
    decode_ok: bool = True        # False for encoder-only models
    # frontend stubs
    frontend: str = "none"        # none|vision_stub|audio_stub
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def tail(self) -> Tuple[str, ...]:
        """Layers beyond the last full unit (kept exact, e.g. 26 = 8·3 + 2)."""
        return self.unit[: self.n_layers % len(self.unit)]

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_unit = len(self.unit)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            n_layers=2 * n_unit if self.n_layers % n_unit == 0
            else 2 * n_unit + len(self.tail),
            d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
            d_ff=128 if self.d_ff else 0, vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            mla_kv_rank=32 if self.mla_kv_rank else 0,
            mla_q_rank=48 if self.mla_q_rank else 0,
            mla_rope_dim=8 if self.mla_rope_dim else 0,
            rnn_dim=64 if self.rnn_dim else 0,
            window=min(self.window, 16) if self.window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=32 if self.encoder_seq else 0,
            mlstm_chunk=8, dtype="float32", remat=False)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_archs() -> Sequence[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # Import side-effect registers every ported config.
    from repro_torch.configs import (arctic_480b, llama3_8b,  # noqa
                                     minicpm3_4b, mixtral_8x22b, olmo_1b,
                                     qwen2_vl_2b, recurrentgemma_2b,
                                     starcoder2_3b, whisper_large_v3,
                                     xlstm_350m)


def cells() -> list[tuple[str, str, str]]:
    """All (arch, shape, skip_reason) dry-run cells, the reference's:
    decode cells of an encoder-only config and long_500k of a
    full-attention one carry their reason."""
    out = []
    for arch in all_archs():
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            reason = ""
            if shape.kind == "decode" and not cfg.decode_ok:
                reason = "encoder-only: no decode step"
            elif shape.name == "long_500k" and not cfg.long_context_ok:
                reason = "full attention is quadratic at 500k"
            out.append((arch, shape.name, reason))
    return out
