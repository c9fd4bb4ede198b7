#!/usr/bin/env python3
"""Where the dense-LM phases' device time goes, on one CUDA card.

    PYTHONPATH=src python3 tools/profile_lm.py [--seed 0] [--steps 8]
        [--arch llama3-8b] [--serve-only]

Serving: Llama-3-8B (or ``--arch``, e.g. minicpm3-4b or qwen2-vl-2b) at
full width and depth (bf16, random weights from the port's seeded init),
the shapes of
``chip_smoke.py``'s LM phases: one full-sequence forward at 2 x 4096
tokens, then ``--steps`` greedy decode steps against the cache of 8
prompts of 2048 tokens.  Training (left out with ``--serve-only``): one
step of
``chip_smoke.py``'s ``lm_train`` (OLMo-1B at full width and depth, bf16,
remat, 16 x 2048 tokens in 4 microbatches, its lr), through the train
step ``launch/train.py`` runs.  Each runs once to warm up and once under
``torch.profiler`` (CPU and CUDA activity).  Prints the host wall time,
the summed device time of the kernels, and the operators and kernels by
device time.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def profiled(label, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # "Command Buffer Full" rows are the host waiting for launch-queue
    # space, not kernel time; kept out of the sum whatever their type.
    kernels = sum(e.self_device_time_total for e in events
                  if e.device_type.name == "CUDA"
                  and e.key != "Command Buffer Full") / 1e6
    print(f"{label}: wall {wall:.4f} s under the profiler, kernels "
          f"{kernels:.4f} s of device time ({kernels / wall:.1%} of the "
          f"wall)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=20,
                       max_name_column_width=60))


def train_profile(seed, dev) -> None:
    """One lm_train step of chip_smoke.py, warmed up and then profiled."""
    import torch
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import WARMUP_STEPS
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sh = get_arch(cs.TRAIN_ARCH), cs.TRAIN_SHAPES
    tcfg = TrainConfig(adamw=AdamWConfig(lr=cs.TRAIN_LR,
                                         warmup_steps=WARMUP_STEPS,
                                         total_steps=sh["steps"]),
                       microbatches=sh["microbatches"])
    state = [init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(seed), dev)]
    step = make_train_step(cfg, tcfg)
    batch = TokenPipeline(cfg.vocab, sh["seq"], sh["batch"], seed=seed,
                          device=dev).batch_at(0)

    def one():
        state[0], _ = step(state[0], batch)

    profiled(f"lm_train step [{cfg.name}, {sh['batch']}x{sh['seq']}, "
             f"{sh['microbatches']} microbatches]", one)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", default="llama3-8b", help="serving model")
    ap.add_argument("--serve-only", action="store_true",
                    help="profile serving only, no training step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.serve.serve_step import ServeState, serve_step

    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__)
    cfg = get_arch(args.arch)
    print(cfg.name)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    tokens = TokenPipeline(cfg.vocab, 4096, 2, seed=args.seed,
                           device=dev).batch_at(0)["tokens"]
    profiled("forward [2x4096]",
             lambda: transformer.forward(cfg, params, tokens))

    prompt = TokenPipeline(cfg.vocab, 2048, 8, seed=args.seed + 1,
                           device=dev).batch_at(0)["tokens"]
    logits, cache = transformer.prefill_forward(cfg, params, prompt,
                                                2048 + 2 * args.steps)
    state = ServeState(cache, torch.tensor(2048, dtype=torch.int32,
                                           device=dev),
                       torch.argmax(logits[:, 0], -1).to(torch.int32)[:,
                                                                      None])

    def decode():
        nonlocal state
        for _ in range(args.steps):
            _, state = serve_step(cfg, params, state)

    profiled(f"decode [8x2048, {args.steps} steps]", decode)
    del params, cache, state
    torch.cuda.empty_cache()
    if not args.serve_only:
        train_profile(args.seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
