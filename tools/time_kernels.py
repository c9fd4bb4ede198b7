#!/usr/bin/env python3
"""Times edge_propagate, kmeans_assign and flash_attention as chip_smoke.py's
rows do, for any tree.

    python3 tools/time_kernels.py [--src DIR] [--sass] [--phases]

``--src`` is the directory holding the ``repro_torch`` package to time
(default: this checkout's ``src``), so that two versions of the kernels can
be timed on one card in one call, each in a process of its own.  The rows,
their inputs and the phases are chip_smoke.py's own, imported from this
checkout, on its graph and its points:

* edge_propagate add (PageRank's first dense stratum) and min (SSSP's
  first) over shard 0's CSC of the 3.3 M-vertex graph;
* kmeans_assign on the 382 M points and their initial centroids; the SM
  clock and the power draw are read from ``nvidia-smi`` while a queue of
  calls runs;
* flash_attention at the four shapes of chip_smoke.py's flash rows, on
  standard normal inputs (chip_smoke.py's forward and prefill rows take
  layer 0's q, k and v of the model instead).

Each row is held to its plain version, and timed beside it and beside the
one torch call where there is one, by chip_smoke.py's ``time_ms`` (CUDA
events around at least 5 calls and 20 ms of them, after one warm-up).

* ``--sass``: the instructions of the constant-table kmeans kernel at
  K = 32 (``cuobjdump -sass`` on the built library), by opcode, and per
  (point, centroid) pair.
* ``--phases``: three walls each of the phases these kernels carry
  (``nodelta``, ``sssp_nodelta``, ``cc_nodelta``, ``kmeans_delta``,
  ``kmeans_nodelta``) at chip_smoke.py's settings, after one untimed run;
  host clock, ending in a synchronise.

Prints the card and one JSON line.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASE_RUNS = 3
SASS_KERNEL = "ka_table_kernelILi32E"   # ka_table_kernel<32>, mangled
PAIR_OPS = ("FMUL", "FFMA", "FADD", "FSETP", "FSEL", "FMNMX", "SEL")


def sass_counts(lib: Path, csrc: Path, k: int) -> dict:
    """Opcodes of SASS_KERNEL in ``lib``: the total, the counts of
    PAIR_OPS and of loads, and both over the pairs of one thread (``k``
    times the source's ``kTablePoints``)."""
    per = re.search(r"constexpr int kTablePoints = (\d+);",
                    (csrc / "kmeans_assign.cu").read_text())
    pairs = k * (int(per.group(1)) if per else 1)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops: collections.Counter = collections.Counter()
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = SASS_KERNEL in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m and m.group(1) != "NOP":
            ops[m.group(1)] += 1
    if not ops:
        return {"kernel": SASS_KERNEL, "found": False}
    total = sum(ops.values())
    pair = sum(ops[o] for o in PAIR_OPS)
    return {"kernel": SASS_KERNEL, "found": True, "instructions": total,
            "pairs": pairs, "pair_ops": pair,
            "pair_ops_per_pair": pair / pairs,
            "instructions_per_pair": total / pairs,
            "loads": {o: ops[o] for o in ("LDG", "LDS", "LDC", "ULDC")
                      if ops[o]},
            "ops": dict(ops.most_common())}


def walls(fn) -> list:
    """PHASE_RUNS host-clock walls of ``fn`` after one untimed run."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(PHASE_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    # The package under --src first; chip_smoke's own path entry then no
    # longer decides which repro_torch its builders import.
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print("card:", card)
    print("kernel sources:", _build.CSRC)
    lib = _build.build()
    dev = torch.device("cuda")
    rows = []
    out: dict = {"card": card, "src": str(Path(args.src).resolve())}
    size = cs.parse_args([])   # chip_smoke.py's sizes and seed

    _, _, graph, snap = cs.make_graph(size.n, size.shards, size.seed, dev)
    csc = cs.shard0_csc(graph, snap)
    rows.append(cs.pagerank_edge_row(graph, snap, csc))
    rows.append(cs.sssp_edge_row(graph, snap, csc))
    del csc
    if args.phases:
        out["phase_walls_s"] = {
            name: walls(cs.graph_phase(name, graph, snap, dev)[2])
            for name in ("nodelta", "sssp_nodelta", "cc_nodelta")}
    del graph
    torch.cuda.empty_cache()

    points, init = cs.make_points(size.points, dev)
    rows.append(cs.kmeans_kernel_check(points, init))
    from repro_torch.kernels import kmeans_assign as ka
    for _ in range(100):   # ~0.3 s of queued work on the card
        ka.assign(points, init)
    time.sleep(0.15)
    clock, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].split(", ")
    torch.cuda.synchronize()
    out["kmeans_under_load"] = {"sm_clock": clock, "power_draw": power}
    if args.phases:
        sharded = points.view(size.shards, -1, 2)
        for mode in ("delta", "nodelta"):
            out["phase_walls_s"][f"kmeans_{mode}"] = walls(
                cs.kmeans_phase(mode, sharded, init, dev))
        del sharded
    del points, init
    torch.cuda.empty_cache()

    cfg, sh = get_arch(cs.LM_ARCH), cs.LM_SHAPES
    heads = (cfg.n_heads, cfg.n_kv_heads)
    shapes = {"forward": ((sh["fwd_batch"], *heads, sh["fwd_seq"],
                           sh["fwd_seq"], cfg.hd), True),
              "prefill": ((sh["serve_batch"], *heads, sh["prompt"],
                           sh["prompt"], cfg.hd), True),
              **cs.FLASH_OFF_PATH}
    g = torch.Generator(device=dev).manual_seed(size.seed)
    for label, (shape, causal) in shapes.items():
        rows.append(cs.flash_row(label, None, *cs.random_qkv(shape, g),
                                 causal))
        torch.cuda.empty_cache()

    out["rows"] = {cs.row_name(r): {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "err", "shape")}
        for r in rows}
    if args.sass:
        out["kmeans_sass"] = sass_counts(lib, _build.CSRC, cs.KMEANS_K)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
