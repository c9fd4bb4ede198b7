#!/usr/bin/env python3
"""Where a rank's time goes in a layer split over "model", on one CUDA card.

    PYTHONPATH=src python3 tools/profile_tp.py [--seed 0] [--sizes 1 16]

Llama-3-8B's layer 0 at full width (bf16, random weights from the port's
seeded init) on ``chip_smoke.py``'s ``tp_layer`` input, 2 x 4096 tokens:
for each model axis size M, rank 0's block (``models/tp.py``: its blocks
of the weights, contiguous, ``TP(plan, 0)`` with no group, so its
collectives are the identity), forward alone and forward + backward, each
run once to warm up and once under ``torch.profiler`` (CPU and CUDA
activity).  M = 1 is the whole layer.  Prints, for each, the host wall,
the summed device time of the kernels, and the operators by device time.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 16])
    args = ap.parse_args(argv)
    import dataclasses
    import torch
    if not torch.cuda.is_available():
        print("profile_tp: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from profile_lm import profiled
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.sharding import tp_plan
    from repro_torch.models import tp as tpm
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(cs.LM_ARCH), n_layers=1)
    B, T = cs.TP_SHAPES["batch"], cs.TP_SHAPES["seq"]
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(cfg, g, dev)
    block = params.layers[0]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                           device=dev).batch_at(0)["tokens"]
    x = params.embed[tokens.long()].detach()
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    w = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    print(f"card: {cs.card_line()}", flush=True)
    for m in args.sizes:
        plan = tp_plan(cfg, m)
        p0 = tpm.rank_params("dense", block, plan, 0, leaves=True)
        tp0 = tpm.TP(plan, 0) if plan.splits else None
        leaves = [t for n, t in p0.items()
                  if tpm.param_block("dense", n, plan, 0) is not None
                  or tp0 is None]

        def layer(p, xx):
            return transformer.apply_block("dense", cfg, p, xx, pos,
                                           tp=tp0)[0]

        def forward():
            with torch.no_grad():
                tpm.call_with(block, p0, layer, x)

        def step():
            xr = x.clone().requires_grad_()
            y = tpm.call_with(block, p0, layer, xr)
            torch.autograd.grad(torch.sum(y.float() * w.float()),
                                [xr] + leaves)
        profiled(f"M={m} rank 0 forward", forward)
        profiled(f"M={m} rank 0 forward + backward", step)
        del p0, leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
