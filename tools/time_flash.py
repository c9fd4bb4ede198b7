#!/usr/bin/env python3
"""Times the flash_attention kernel alone at chip_smoke.py's four shapes.

    python3 tools/time_flash.py [--src DIR] [--reps 20] [--seed 0]

``--src`` is the directory holding the ``repro_torch`` package to time
(default: this checkout's ``src``), so that two versions of the kernel can
be timed on one card in one session, each in a process of its own.  The
inputs are random normal float32 from ``--seed``.  Prints the card and one
JSON line of milliseconds per shape: CUDA events around ``--reps``
launches after one warm-up, divided by ``--reps``.  Exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# label: (B, H, H_kv, T, S, D, causal), as in chip_smoke.py's flash rows.
SHAPES = {
    "forward": (2, 32, 8, 4096, 4096, 128, True),
    "prefill": (8, 32, 8, 2048, 2048, 128, True),
    "ragged": (2, 32, 8, 1000, 1000, 128, True),
    "noncausal": (2, 16, 16, 512, 768, 64, False),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_flash: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flash_attention import ops

    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print("kernel source:", Path(ops.__file__).resolve().parents[1] /
          "csrc" / "flash_attention.cu")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {}
    for label, (b, h, h_kv, t, s, d, causal) in SHAPES.items():
        q = torch.randn(b, h, t, d, generator=g, device=dev)
        k = torch.randn(b, h_kv, s, d, generator=g, device=dev)
        v = torch.randn(b, h_kv, s, d, generator=g, device=dev)
        ops.attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            ops.attention(q, k, v, causal=causal)
        end.record()
        torch.cuda.synchronize()
        out[label] = start.elapsed_time(end) / args.reps
        del q, k, v
    print(json.dumps({"flash_attention_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
