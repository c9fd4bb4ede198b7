#!/usr/bin/env python3
"""Times the dry run's trace of xlstm-350m's train and prefill cells with
its time loops traced in full against one trip of each, at cut sequence
lengths, and extrapolates the full trace to train_4k and prefill_32k.

    python3 tools/xlstm_trace_time.py [--device cuda|cpu] [--seq 128 256]

Each trace is ``launch/dryrun.py``'s program on a fake (16, 16) world at
the production batch (256 train rows, 32 prefill rows) with T cut to each
``--seq``.  "one trip" is the dry run as it runs (``models/ssm.py`` runs
one trip of the mLSTM's chunk loop and the sLSTM's step loop on fake
tensors); "full" makes ``ssm.is_fake`` answer False, so both loops run
every trip.  The full trace's seconds grow with T (the loops' eager steps);
the extrapolation is the line through the two cut lengths, after one
untimed trace (the first pays for imports and caches).  Prints the
host, then one JSON line.  ``--device cuda`` (the default) needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def trace_seconds(kind: str, t: int, batch: int, device: str) -> float:
    from repro_torch.configs import Shape, get_arch
    from repro_torch.launch import dryrun
    with dryrun.fake_world((16, 16), ("data", "model"), device) as (mesh, _):
        cell = dryrun.build_cell(get_arch("xlstm-350m"),
                                 Shape("cut", t, batch, kind), mesh, 0,
                                 device)
        return dryrun.trace(cell.fn, cell.args)["seconds"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, nargs=2, default=(128, 256))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("xlstm_trace_time: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import SHAPES
    from repro_torch.models import ssm
    print(f"host: {platform.node()} {platform.processor()} "
          f"torch {torch.__version__}", flush=True)
    out = {}
    real_is_fake = ssm.is_fake
    trace_seconds("train", args.seq[0], 256, args.device)    # warm-up
    for name, kind, batch in (("train_4k", "train", 256),
                              ("prefill_32k", "prefill", 32)):
        for mode in ("one_trip", "full"):
            ssm.is_fake = real_is_fake if mode == "one_trip" else \
                (lambda t: False)
            try:
                secs = [trace_seconds(kind, t, batch, args.device)
                        for t in args.seq]
            finally:
                ssm.is_fake = real_is_fake
            (t0, t1), (s0, s1) = args.seq, secs
            full_t = SHAPES[name].seq_len
            at_full = s1 + (s1 - s0) / (t1 - t0) * (full_t - t1)
            out[f"{name}/{mode}"] = {"seq": list(args.seq), "seconds": secs,
                                     "extrapolated_s": at_full}
            print(f"{name} {mode}: T={t0} {s0:.2f} s, T={t1} {s1:.2f} s; "
                  f"at T={full_t} about {at_full:.0f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
