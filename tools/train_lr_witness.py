#!/usr/bin/env python3
"""Trains OLMo-1B at full width and depth for a few steps at each of some
learning rates, through three attention paths from the same weights and
batches, and prints each run's losses.

    python3 tools/train_lr_witness.py

Each run is chip_smoke.py's ``lm_train`` (``launch/train.py``'s schedule,
a warm-up of 10 steps; 6 steps of 16 x 2048 tokens in 4 microbatches;
the weights and batches of seed 0) with the learning rate (LRS:
``launch/train.py``'s default and chip_smoke.py's TRAIN_LR) and the path
varied:

* ``kernel_bf16``: the bf16 flash kernels forward and backward, as
  ``lm_train`` runs;
* ``plain_bf16``: the plain attention path (``use_flash_kernel=False``),
  which computes attention in float32 and keeps no P in bf16, as the
  reference's training does;
* ``kernel_f32``: the float32 flash kernels on a float32 copy of the
  model (TF32 off), whose parameters need no rounding back to bf16.

Beside each step's training loss (on that step's own batch) it prints the
loss of one held-out microbatch (the first of step 10,000's batch) under
the weights before the step, so that a rise shared by every batch shows
apart from one batch being harder than the last.  A rise that all three
paths share comes from the learning rate, not from the bf16 kernels or the
bf16 parameters.

Prints the card and one JSON line.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LRS = (3e-3, 4e-4)
PATHS = ("kernel_bf16", "plain_bf16", "kernel_f32")
HELD_OUT_STEP = 10_000
SEED = 0


def run(cfg, path: str, lr: float, steps: int, shapes: dict, seed: int,
        dev) -> dict:
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import WARMUP_STEPS
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_loss_fn, make_train_step)

    if path == "kernel_f32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=lr, warmup_steps=WARMUP_STEPS,
                          total_steps=steps),
        microbatches=shapes["microbatches"],
        use_flash_kernel=path != "plain_bf16")
    T, B = shapes["seq"], shapes["batch"]
    pipe = TokenPipeline(cfg.vocab, T, B, seed=seed, device=dev)
    held = {k: v[:B // tcfg.microbatches]
            for k, v in pipe.batch_at(HELD_OUT_STEP).items()}
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(seed), dev)
    step_fn = make_train_step(cfg, tcfg)
    loss_fn = make_loss_fn(cfg, tcfg)
    out = dict(path=path, lr=lr, losses=[], held_out=[], grad_norm=[],
               step_lr=[], walls=[])
    for step in range(steps):
        with torch.no_grad():
            out["held_out"].append(float(loss_fn(state.params, held)[1][0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.batch_at(step))
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["step_lr"].append(float(metrics["lr"]))
    with torch.no_grad():
        out["held_out"].append(float(loss_fn(state.params, held)[1][0]))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_lr_witness: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(cs.TRAIN_ARCH)
    runs = []
    for lr in LRS:
        for path in PATHS:
            r = run(cfg, path, lr, cs.TRAIN_SHAPES["steps"],
                    cs.TRAIN_SHAPES, SEED, torch.device("cuda"))
            runs.append(r)
            print(f"lr {lr:g} {path}: losses "
                  f"{[round(x, 4) for x in r['losses']]} held-out "
                  f"{[round(x, 4) for x in r['held_out']]} grad_norm "
                  f"{[round(x, 3) for x in r['grad_norm']]} step walls "
                  f"{[round(x, 3) for x in r['walls']]} s", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
