"""Serving: prefill and batched greedy decode steps (the reference's
``train/serve_step.py``).

``prefill``    — builds a cache by teacher-forcing the prompt one decode
                 step at a time, as the reference's does (its runnable
                 examples use it at small shapes).  The serving driver,
                 ``launch/serve.py``, prefills with
                 ``transformer.prefill_forward`` instead: one full-sequence
                 pass through the flash kernel.
``serve_step`` — one token for every sequence in the batch against the
                 cache; greedy (argmax, ties to the first index).
``generate``   — ``prefill`` then ``n_new`` serve steps.
``fill_cross_kv`` — an encoder-decoder's (Whisper's) per-layer
                 cross-attention K/V from the encoder output, into the
                 cache; ``prefill`` and ``generate`` call it when given
                 ``enc_out``.

The cache is updated in place (``transformer.decode_step``); a
``ServeState`` passed to ``serve_step`` shares its cache with the one
returned.  Decode writes only the self-attention cache: ``cross_kv`` is
read and never written.  Each function runs under
``torch.inference_mode()``, so serving records no autograd graph, even of
parameters that ask for gradients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import transformer


class ServeState(NamedTuple):
    cache: dict
    pos: torch.Tensor          # int32[] — next write position
    last_token: torch.Tensor   # int32[B, 1]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]


@torch.inference_mode()
def prefill(cfg, params, tokens: torch.Tensor, max_len: int, enc_out=None
            ) -> tuple[torch.Tensor, ServeState]:
    """Teacher-force ``tokens`` int32[B, T] through ``decode_step``, the
    cross-attention K/V of ``enc_out`` filled first for an encoder-decoder;
    returns (the last step's logits f32[B, 1, V], the state after the
    prompt)."""
    b, t = tokens.shape
    dev = tokens.device
    cache = transformer.init_cache(cfg, b, max_len, device=dev)
    if cfg.encoder_layers and enc_out is not None:
        cache = fill_cross_kv(cfg, params, cache, enc_out)
    logits = torch.zeros((b, 1, cfg.vocab), dtype=torch.float32, device=dev)
    for i in range(t):
        logits, cache = transformer.decode_step(
            cfg, params, tokens[:, i:i + 1], cache,
            torch.tensor(i, dtype=torch.int32, device=dev))
    return logits, ServeState(
        cache=cache, pos=torch.tensor(t, dtype=torch.int32, device=dev),
        last_token=_greedy(logits))


@torch.inference_mode()
def fill_cross_kv(cfg, params, cache: dict, enc_out: torch.Tensor) -> dict:
    """Each ``"dec_cross"`` layer's cross-attention (k, v) of the encoder
    output ``enc_out`` [B, S_enc, D], replacing the cache's ``cross_kv``
    (not copied into it: the K/V keep their own dtype, float32 for float32
    frames against a bf16 model, as the reference's do).  Returns the
    cache, changed in place."""
    for block, c in zip(params.layers, cache["layers"]):
        if "cross_kv" in c:
            c["cross_kv"] = attn.encode_cross_kv(cfg, block.cross, enc_out)
    return cache


@torch.inference_mode()
def serve_step(cfg, params, state: ServeState
               ) -> tuple[torch.Tensor, ServeState]:
    """One decode step for the whole batch: returns (token int32[B, 1],
    state')."""
    logits, cache = transformer.decode_step(
        cfg, params, state.last_token, state.cache, state.pos)
    nxt = _greedy(logits)
    return nxt, ServeState(cache=cache, pos=state.pos + 1, last_token=nxt)


@torch.inference_mode()
def generate(cfg, params, prompt: torch.Tensor, n_new: int, max_len: int,
             enc_out=None) -> torch.Tensor:
    """Greedy generation: int32[B, T + n_new], the prompt and the
    ``n_new`` tokens of ``n_new`` serve steps after ``prefill`` (with
    ``enc_out`` for an encoder-decoder)."""
    _, state = prefill(cfg, params, prompt, max_len, enc_out=enc_out)
    toks = []
    for _ in range(n_new):
        tok, state = serve_step(cfg, params, state)
        toks.append(tok)
    return torch.cat([prompt, *toks], dim=1)
