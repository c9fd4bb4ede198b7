"""Serving driver: prefill and batched greedy decode on one device (the
reference's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 8 --prompt-len 2048 --new-tokens 64

Weights are random, from ``--seed`` (``transformer.init_params``); prompts
come from the synthetic ``TokenPipeline``.  The prefill is one
full-sequence pass (``transformer.prefill_forward``, through the
flash_attention kernel on the card), then ``new_tokens - 1`` greedy
``serve_step``s: ``new_tokens`` new tokens in all.  An encoder-decoder
(``--arch whisper-large-v3``) first encodes float32 frames [B,
encoder_seq, d_model] drawn from ``--seed`` (the audio frontend is a
stub, as the reference's ``main`` draws its frames), and its prefill
fills each layer's cross-attention K/V from them.  The recurrent configs
(``--arch recurrentgemma-2b``, ``xlstm-350m``) serve the same way: their
prefill leaves each recurrent layer's state, and each local-attention
layer's ring, in the cache.  ``--device`` defaults to CUDA; ``--device cpu
--reduced`` runs a tiny config on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.serve_step import ServeState, serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor           # int32[B, new_tokens]
    prefill_logits: torch.Tensor   # f32[B, 1, V], the prompt's last position
    prefill_s: float               # host clock, ends in a device sync
    decode_s: float                # the decode steps, likewise
    decode_steps: int
    encode_s: float = 0.0          # the encoder (encoder-decoders), likewise


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg, params, prompt: torch.Tensor, new_tokens: int,
          frames: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompt`` int32[B, T] into a cache of ``T + new_tokens``
    slots, then decode greedily to ``new_tokens`` new tokens, under
    ``torch.inference_mode()`` (no autograd graph).  An encoder-decoder
    encodes ``frames`` [B, encoder_seq, D] first (timed apart) and
    prefills with the encoder output."""
    b, t = prompt.shape
    dev = prompt.device
    enc_out, encode_s = None, 0.0
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: serve "
                             f"takes its frames")
        t0 = time.perf_counter()
        enc_out = transformer.encode(cfg, params, frames)
        _sync(dev)
        encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, cache = transformer.prefill_forward(cfg, params, prompt,
                                                t + new_tokens,
                                                enc_out=enc_out)
    nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
    state = ServeState(cache=cache,
                       pos=torch.tensor(t, dtype=torch.int32, device=dev),
                       last_token=nxt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    toks = [nxt]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        tok, state = serve_step(cfg, params, state)
        toks.append(tok)
    _sync(dev)
    return ServeResult(tokens=torch.cat(toks, dim=1), prefill_logits=logits,
                       prefill_s=prefill_s,
                       decode_s=time.perf_counter() - t0,
                       decode_steps=new_tokens - 1, encode_s=encode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompt = TokenPipeline(cfg.vocab, args.prompt_len, args.batch,
                           seed=args.seed + 1, device=dev
                           ).batch_at(0)["tokens"]
    frames = None
    if cfg.encoder_layers:
        frames = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
    res = serve(cfg, params, prompt, args.new_tokens, frames=frames)
    if cfg.encoder_layers:
        print(f"encode [{args.batch}x{cfg.encoder_seq}] {res.encode_s:.2f}s")
    print(f"prefill [{args.batch}x{args.prompt_len}] {res.prefill_s:.2f}s")
    print(f"decoded {res.decode_steps} steps in {res.decode_s:.2f}s "
          f"({args.batch * res.decode_steps / max(res.decode_s, 1e-9):.1f} "
          f"tok/s)")
    print("sample tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
