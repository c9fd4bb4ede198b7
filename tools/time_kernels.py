#!/usr/bin/env python3
"""Times edge_propagate, kmeans_assign, flash_attention and delta_scatter as
chip_smoke.py's rows do, for any tree.

    python3 tools/time_kernels.py [--src DIR] [--sass] [--phases] [--dist]
                                  [--flash]

``--src`` is the directory holding the ``repro_torch`` package to time
(default: this checkout's ``src``), so that two versions of the kernels can
be timed on one card in one call, each in a process of its own; its
flash_attention op must take bfloat16 (the bf16 rows).  The rows,
their inputs and the phases are chip_smoke.py's own, imported from this
checkout, on its graph and its points:

* edge_propagate add (PageRank's first dense stratum) and min (SSSP's
  first) over shard 0's CSC of the 3.3 M-vertex graph;
* kmeans_assign on the 382 M points and their initial centroids; the SM
  clock and the power draw are read from ``nvidia-smi`` while a queue of
  calls runs;
* flash_attention at the shapes of chip_smoke.py's flash rows, on
  standard normal inputs (chip_smoke.py's forward and prefill rows take
  layer 0's q, k and v of the model instead): the bf16 kernel at the
  forward's and the prefill's shapes, the float32 kernel at the
  forward's, and both at the ragged and the non-causal shapes;
* delta_scatter at the inputs of chip_smoke.py's three rows (PageRank's
  first stratum on the top rung, add at W = 1; ``sssp_auto``'s busiest
  stratum on its widest rung, min; ``adsorption_auto``'s first stratum
  on its widest rung, add at W = 4; ``sssp_auto``, ``adsorption_auto``
  and ``adsorption_sort`` run once to find them), each a shard's
  incoming buffer: ``kernel_ms`` is the kernel alone on keys made local
  beforehand, ``seq_ms`` the conversion (``to_local_keys``) and then the
  kernel on the local keys, and ``ms`` the single launch on global keys
  with ``key_base`` (null for a tree whose op takes no ``key_base``),
  each held to the plain version (not timed).

Each row is held to its plain version, and timed beside it and beside the
one torch call where there is one, by chip_smoke.py's ``time_ms`` (CUDA
events around at least 5 calls and 20 ms of them, after one warm-up).

* ``--sass``: the instructions of the constant-table kmeans kernel at
  K = 32 (``cuobjdump -sass`` on the built library), by opcode, and per
  (point, centroid) pair; and those of the bf16 flash_attention kernels at
  D = 128 and 64, by opcode (HGMMA: the tensor-core products, UTMALDG: the
  TMA loads, MUFU: the exponentials), with their registers and stack; and
  those
  of the delta_scatter kernels of the three rows (add and min at W = 1,
  add at W = 4), with their loads and atomics in full.
* ``--phases``: three walls each of the phases these kernels carry
  (``nodelta``, ``sssp_nodelta``, ``cc_nodelta``, ``kmeans_delta``,
  ``kmeans_nodelta``) and delta_scatter carries (``delta_auto``,
  ``sssp_auto``, ``cc_auto``, ``adsorption_auto``) at chip_smoke.py's
  settings, after one untimed run; host clock, ending in a synchronise.
  Then each compiled rule phase of chip_smoke.py's RULES_PHASES that has
  a handwritten twin runs in turns with it (twin, rules, rules, twin,
  PAIR_ROUNDS times, after one untimed run of each), with the largest
  difference of a rules answer from the twin's first and of the twin's
  answers from each other; then one more run of each under
  torch.profiler: the CUDA kernels, memsets and copies it launched (from
  the profiler's Chrome trace), their summed device time, and the
  ``aten`` operators it called, nested ones included.  The rule phases
  need a tree whose ``repro_torch`` has the frontend.
* flash_attention_bwd at ``lm_train``'s layer shape (chip_smoke.py's
  TRAIN_SHAPES and olmo-1b's heads, standard normal inputs) in bf16 and
  float32, and at FLASH_BWD_OFF_PATH, by chip_smoke.py's
  ``flash_bwd_row`` (its error against the plain version and the SDPA
  backward's time), with each of its three launches' device time from
  torch.profiler's trace; for a tree whose op has no
  ``attention_with_lse`` (a backward that recomputes the statistic), its
  time and launch split alone.  With ``--sass`` also the bf16 backward's dK dV and dQ kernels
  by opcode (HGMMA, UTMALDG, UBLKCP: the bulk copies of the statistic
  and Delta, MUFU, USETMAXREG, and STL / LDL: spills), with their
  resources.
* ``--flash``: the flash rows alone (forward and backward), without the
  graph, delta_scatter and kmeans rows.  Both modes also time
  chip_smoke.py's D = 64 rows (Whisper's encoder and prefill shapes, the
  float32 kernel at the encoder's, and the backward at the gradient
  phase's encoder) where the tree's bf16 kernels take D = 64.
* ``--dist``: each phase of chip_smoke.py's DIST_PHASES (the shard_map
  backend on a world of one rank over NCCL, its group on a ``file://``
  store under ``build/``) in turns with its simulated twin, as the rule
  phases are above; needs a tree with ``repro_torch.launch.mesh``.

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
PAIR_ROUNDS = 2   # rounds of (twin, rules, rules, twin)
SASS_KERNEL = "ka_table_kernelILi32E"   # ka_table_kernel<32>, mangled
# The bf16 flash kernels by head dim, each by the substrings of its mangled
# name (its file's anonymous namespace, then the instance: the float32
# backward's templates have the same kernel names); each later tuple is
# the name in a tree from before the head-dim template (one D = 128
# kernel), tried when the first finds nothing.
FLASH_SASS_KERNELS = {
    "d128": [("bf16_cu", "fa_bf16_kernelILi128E"),
             ("bf16_cu", "fa_bf16_kernelE")],
    "d64": [("bf16_cu", "fa_bf16_kernelILi64E")]}
BWD_SASS_KERNELS = {
    "dkdv_d128": [("bwd_bf16_cu", "bwd_dkdvILi128E"),
                  ("bwd_bf16_cu", "bwd_dkdvE14CUtensorMap")],
    "dq_d128": [("bwd_bf16_cu", "bwd_dqILi128E"),
                ("bwd_bf16_cu", "bwd_dqE14CUtensorMap")],
    "dkdv_d64": [("bwd_bf16_cu", "bwd_dkdvILi64E")],
    "dq_d64": [("bwd_bf16_cu", "bwd_dqILi64E")]}
# ds_kernel<OP, V, FW, ALIGNED>, mangled: add at W = 1, min at W = 1, add
# at W = 4 with an aligned payload.
SCATTER_SASS_KERNELS = {"add_w1": "ds_kernelILi0ELi1ELi1ELb1E",
                        "min_w1": "ds_kernelILi1ELi1ELi1ELb1E",
                        "add_w4": "ds_kernelILi0ELi4ELi4ELb1E"}
PAIR_OPS = ("FMUL", "FFMA", "FADD", "FSETP", "FSEL", "FMNMX", "SEL")


def opcodes(sass: str, kernel) -> collections.Counter:
    """Opcode counts (NOP left out) of the function of ``sass`` whose
    mangled name holds ``kernel`` (a string, or a tuple of strings it
    holds all of)."""
    parts = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    ops: collections.Counter = collections.Counter()
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = all(part in line for part in parts)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m and m.group(1) != "NOP":
            ops[m.group(1)] += 1
    return ops


def library_sass(lib: Path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_counts(sass: str, csrc: Path, k: int) -> dict:
    """Opcodes of SASS_KERNEL: the total, the counts of PAIR_OPS and of
    loads, and both over the pairs of one thread (``k`` times the source's
    ``kTablePoints``)."""
    per = re.search(r"constexpr int kTablePoints = (\d+);",
                    (csrc / "kmeans_assign.cu").read_text())
    pairs = k * (int(per.group(1)) if per else 1)
    ops = opcodes(sass, SASS_KERNEL)
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


def flash_sass_counts(sass: str, lib: Path, names: list) -> dict:
    """Opcodes of the first kernel of ``names`` (tuples of substrings of
    mangled names) found in ``sass``: the total, and the tensor-core
    products, TMA loads, bulk copies, exponentials, register
    reallocations and spills; and its resources as ``cuobjdump
    -res-usage`` reports them (registers at entry, stack, local memory)."""
    kernel, ops = names[0], collections.Counter()
    for kernel in names:
        ops = opcodes(sass, kernel)
        if ops:
            break
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage = subprocess.run([tool, "-res-usage", str(lib)],
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout.splitlines()
    res = next((usage[i + 1].strip() for i, line in enumerate(usage[:-1])
                if all(part in line for part in kernel)), None)
    return {"kernel": "*".join(kernel), "found": bool(ops),
            "instructions": sum(ops.values()),
            **{o: ops[o] for o in ("HGMMA", "UTMALDG", "UBLKCP", "MUFU",
                                   "USETMAXREG", "STL", "LDL")},
            "resources": res, "ops": dict(ops.most_common())}


# The backward's launches, by the kernel names torch.profiler reports
# (float32: statistics, dK dV, dQ; bf16: Delta, dK dV, dQ).
BWD_KERNELS = {"bwd_stats": "statistics", "bwd_delta": "Delta",
               "bwd_dkdv": "dK dV", "bwd_dq": "dQ"}


def bwd_split(fn, reps: int = 5) -> dict:
    """Device ms a call of each BWD_KERNELS kernel ``fn`` launches, from
    the Chrome trace of torch.profiler over ``reps`` calls after one
    warm-up (as chip_smoke.py's busy_share reads kernels).  Measured in a
    process of its own: late in chip_smoke.py's run the profiler's trace
    holds no kernel events."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        name = next((n for n in BWD_KERNELS if n in str(e.get("name"))),
                    None)
        if e.get("cat") == "kernel" and name:
            out[BWD_KERNELS[name]] = (out.get(BWD_KERNELS[name], 0.0) +
                                      e.get("dur", 0.0) / 1e3 / reps)
    return out


def bwd_rows(cs, dev, seed) -> dict:
    """flash_attention_bwd at lm_train's layer shape (bf16 and float32)
    and at FLASH_BWD_OFF_PATH: chip_smoke.py's rows with each launch's
    device time, or for a tree before the forward's statistic the time
    and launch split alone."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    cfg, sh = get_arch(cs.TRAIN_ARCH), cs.TRAIN_SHAPES
    layer = (sh["batch"] // sh["microbatches"], cfg.n_heads, cfg.n_kv_heads,
             sh["seq"], sh["seq"], cfg.hd)
    shapes = {"train": (layer, True, cfg.dtype),
              "train_f32": (layer, True, "float32"),
              **cs.FLASH_BWD_OFF_PATH,
              **{k[4:]: v for k, v in whisper_shapes(cs).items()
                 if k.startswith("bwd_")}}
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for label, (shape, causal, dtype) in shapes.items():
        q, k, v = cs.random_qkv(shape, g, dtype)
        stat = (hasattr(fa, "attention_with_lse") and
                q.dtype == torch.bfloat16)
        o, lse = (fa.attention_with_lse(q, k, v, causal=causal) if stat
                  else (fa.attention(q, k, v, causal=causal), None))
        do = torch.randn(o.shape, generator=g, device=dev).to(q.dtype)
        kw = {"lse": lse} if stat else {}
        run = lambda: fa.attention_bwd(q, k, v, o, do, causal=causal, **kw)
        name = f"flash_attention_bwd/{label}"
        if hasattr(fa, "attention_with_lse"):
            r = cs.flash_bwd_row(label, None, q, k, v, causal, g)
            out[name] = {key: r[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "err", "shape")}
        else:
            out[name] = {"ms": cs.time_ms(run), "shape": (
                f"{tuple(q.shape)} {tuple(k.shape)} {q.dtype}")}
        out[name]["split"] = bwd_split(run)
        del o, do, lse
        del q, k, v
        torch.cuda.empty_cache()
    return out


def scatter_sass_counts(sass: str) -> dict:
    """Opcodes of each SCATTER_SASS_KERNELS variant, and its loads and
    atomics in full (their width shows in the suffix: .128, F32x4)."""
    out = {}
    for label, kernel in SCATTER_SASS_KERNELS.items():
        lines, inside = [], False
        for line in sass.splitlines():
            if "Function :" in line:
                inside = kernel in line
            elif inside and re.search(r"\b(LDG|RED|ATOM)\w*", line):
                lines.append(re.sub(r"\s+", " ", line.split(";")[0]).strip())
        ops = opcodes(sass, kernel)
        out[label] = {"kernel": kernel, "found": bool(ops),
                      "instructions": sum(ops.values()),
                      "memory": lines, "ops": dict(ops.most_common())}
    return out


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


def device_activity(fn) -> dict:
    """One run of ``fn`` under torch.profiler: device activities launched,
    their summed device seconds, and torch operators called."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and str(e.get("name", "")).startswith("aten::")]
    return {"device_activities": len(device),
            "device_s": sum(e.get("dur", 0.0) for e in device) / 1e6,
            "aten_ops": len(ops)}


def twin_pair(twin, twin_fn, name, fn) -> dict:
    """Phase ``name`` and its twin in turns (see the module docstring):
    host-clock walls, answer differences, one profiled run of each."""
    import torch
    runs = {twin: twin_fn, name: fn}
    for fn in runs.values():
        fn()
        torch.cuda.synchronize()
    walls = {label: [] for label in runs}
    answers = {label: [] for label in runs}
    for _ in range(PAIR_ROUNDS):
        for label in (twin, name, name, twin):
            t0 = time.perf_counter()
            vals, _ = runs[label]()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            answers[label].append(vals)
    first = answers[twin][0]

    def spread(vs):   # equal infinities differ by 0
        return max(float(torch.where(v == first, 0.0, (v - first).abs())
                         .max()) for v in vs)

    pair = {"walls_s": walls,
            "max_abs_diff_vs_twin": spread(answers[name]),
            "twin_spread": spread(answers[twin][1:]),
            "profiled": {label: device_activity(fn)
                         for label, fn in runs.items()}}
    print(f"{name} vs {twin}: " + "; ".join(
        f"{label} walls {[round(w, 4) for w in ws]} "
        f"{pair['profiled'][label]}" for label, ws in walls.items())
        + f"; max|{name} - twin| {pair['max_abs_diff_vs_twin']:.3e}, twin "
        f"spread {pair['twin_spread']:.3e}", flush=True)
    del answers
    torch.cuda.empty_cache()
    return pair


def scatter_inputs(cs, graph, snap, dev) -> list:
    """(label, state, incoming buffer, shard, combiner) of chip_smoke.py's
    three delta_scatter rows, taken from its check functions in place of
    the rows they build."""
    from unittest import mock
    from repro_torch.algorithms import adsorption, pagerank, sssp
    from repro_torch.core.engine import ShardedExecutor
    cap = cs.capacities(snap)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")
    found = []

    def take(state, db, shard, combiner, group=None, label=None):
        found.append((label or f"delta_scatter/{combiner}", state, db, shard,
                      combiner))

    with mock.patch.object(cs, "delta_scatter_row", take):
        cs.pagerank_kernel_checks(graph, snap, ex, pagerank.make_algorithm(
            snap, cs.RUN_SETTINGS["pagerank"]["threshold"],
            cap["src_capacity"], cap["edge_capacity"]))
        _, res = cs.graph_phase("sssp_auto", graph, snap, dev)[2]()
        cs.sssp_kernel_checks(graph, snap, ex, sssp.make_algorithm(
            snap, cap["src_capacity"], cap["edge_capacity"]), res.stats)
        seeds = cs.make_seeds(snap, dev)
        stats = {}
        for name in ("adsorption_auto", "adsorption_sort"):
            mode, route, _ = cs.ADSORPTION_PHASES[name]
            stats[name] = adsorption.run(
                graph, snap, seeds, mode=mode, route_strategy=route,
                device=dev, **cs.RUN_SETTINGS["adsorption"], **cap)[1].stats
        cs.adsorption_kernel_checks(graph, snap, ex, adsorption.make_algorithm(
            snap, cs.ADS_LABELS, cs.RUN_SETTINGS["adsorption"]["threshold"],
            cap["src_capacity"], cap["edge_capacity"]), seeds, stats)
    return found


def scatter_row(cs, state, db, shard, combiner) -> dict:
    """kernel_ms, seq_ms and ms (see the module's docstring) of one
    shard's incoming buffer ``db``, each result held to the plain version;
    bound_ms as chip_smoke.py's row counts it."""
    import inspect
    from repro_torch.algorithms import emission
    from repro_torch.kernels import delta_scatter as ds
    B, W = state.shape
    keys, pay = db.keys.contiguous(), db.payload.contiguous()
    local = emission.to_local_keys(db, shard, B).contiguous()
    ref = ds.delta_scatter_ref(state, local, pay, combiner)
    calls = {"kernel_ms": lambda: ds.delta_scatter(state, local, pay,
                                                   combiner),
             "seq_ms": lambda: ds.delta_scatter(
                 state, emission.to_local_keys(db, shard, B).contiguous(),
                 pay, combiner)}
    if "key_base" in inspect.signature(ds.delta_scatter).parameters:
        calls["ms"] = lambda: ds.delta_scatter(state, keys, pay, combiner,
                                               key_base=shard * B)
    out = {"ms": None}
    for name, fn in calls.items():
        cs.compare(f"delta_scatter/{combiner} {name}", [fn()], [ref],
                   float_idx=(0,) if combiner == "add" else ())
        out[name] = cs.time_ms(fn)
    live = int(((local >= 0) & (local < B)).sum())
    out["bound_ms"] = cs.bound(cs.nbytes(keys) + live * 4 * W
                               + 2 * cs.nbytes(state), live * W)[0]
    out["shape"] = f"N={B} C={keys.numel()} live={live} W={W} shard={shard}"
    return out


def dist_pairs(cs, graph, snap, dev) -> dict:
    """Each DIST_PHASES phase in turns with its simulated twin, on a world
    of one rank over NCCL."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.launch.mesh import flat_mesh, init_shard_group
    cap = cs.capacities(snap)
    compiled = cs.compiled_programs()
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        init_shard_group("nccl", f"file://{d}/store", world_size=1, rank=0)
        try:
            mesh = flat_mesh(snap.num_shards, device=dev)
            for name, (twin, _) in cs.DIST_PHASES.items():
                ex = ShardedExecutor(
                    snapshot=snap, seg_capacity=cap["edge_capacity"],
                    edge_capacity=cap["edge_capacity"],
                    src_capacity=cap["src_capacity"], ladder_tiers=4,
                    route_strategy="sort" if twin == "sssp_sort" else "auto",
                    backend="shard_map", mesh=mesh)
                twin_fn = (cs.rules_phase(twin, compiled, graph, snap, dev)
                           if twin in cs.RULES_PHASES else
                           cs.graph_phase(twin, graph, snap, dev)[2])
                out[name] = twin_pair(twin, twin_fn, name, cs.dist_phase(
                    name, graph, snap, dev, ex))
        finally:
            dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--flash", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    # The package under --src first; chip_smoke's own path entry then no
    # longer decides which repro_torch its builders import.
    sys.path.insert(0, str(Path(args.src).resolve()))
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
    if not args.flash:
        graph_and_points(args, cs, dev, size, rows, out)
    flash_rows(cs, dev, size, rows)
    out["rows"] = {cs.row_name(r): {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "err", "shape")}
        for r in rows}
    out["bwd_rows"] = bwd_rows(cs, dev, size.seed)
    if args.sass:
        sass = library_sass(lib)
        out["kmeans_sass"] = sass_counts(sass, _build.CSRC, cs.KMEANS_K)
        out["flash_bf16_sass"] = {
            name: flash_sass_counts(sass, lib, names)
            for name, names in FLASH_SASS_KERNELS.items()}
        out["flash_bwd_sass"] = {
            name: flash_sass_counts(sass, lib, names)
            for name, names in BWD_SASS_KERNELS.items()}
        out["delta_scatter_sass"] = scatter_sass_counts(sass)
    print(json.dumps(out))
    return 0


def graph_and_points(args, cs, dev, size, rows, out) -> None:
    """The edge_propagate, delta_scatter and kmeans rows, and the phases
    of ``--phases`` and ``--dist``."""
    import torch
    _, _, graph, snap = cs.make_graph(size.n, size.shards, size.seed, dev)
    csc = cs.shard0_csc(graph, snap)
    rows.append(cs.pagerank_edge_row(graph, snap, csc))
    rows.append(cs.sssp_edge_row(graph, snap, csc))
    del csc
    out["delta_scatter"] = {
        label: scatter_row(cs, state, db, shard, combiner)
        for label, state, db, shard, combiner in scatter_inputs(
            cs, graph, snap, dev)}
    torch.cuda.empty_cache()
    if args.phases:
        from repro_torch.algorithms import adsorption
        out["phase_walls_s"] = {
            name: walls(cs.graph_phase(name, graph, snap, dev)[2])
            for name in ("nodelta", "sssp_nodelta", "cc_nodelta",
                         "delta_auto", "sssp_auto", "cc_auto")}
        seeds = cs.make_seeds(snap, dev)
        out["phase_walls_s"]["adsorption_auto"] = walls(
            lambda: adsorption.run(
                graph, snap, seeds, mode="delta", route_strategy="auto",
                device=dev, **cs.RUN_SETTINGS["adsorption"],
                **cs.capacities(snap)))
        compiled = cs.compiled_programs()
        out["rules_pairs"] = {
            name: twin_pair(
                twin, cs.graph_phase(twin, graph, snap, dev)[2], name,
                cs.rules_phase(name, compiled, graph, snap, dev))
            for name, (_, _, _, twin, _) in cs.RULES_PHASES.items()
            if twin is not None}
    if args.dist:
        out["dist_pairs"] = dist_pairs(cs, graph, snap, dev)
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


def whisper_shapes(cs) -> dict:
    """chip_smoke.py's D = 64 flash rows (whisper-large-v3's encoder layer
    and decoder prefill, and the backward at the gradient phase's
    encoder): label -> ((B, H, H_kv, T, S, D), causal, dtype); none for a
    tree whose bf16 kernels take no D = 64."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    import torch
    if 64 not in fa_ops.HEAD_DIMS[torch.bfloat16]:
        return {}
    sh = cs.WHISPER_SHAPES
    heads = (20, 20)        # whisper-large-v3's, head dim 64
    enc = (sh["fwd_batch"], *heads, 1500, 1500, 64)
    return {"encoder_d64": (enc, False, "bfloat16"),
            "prefill_d64": ((sh["fwd_batch"], *heads, sh["prompt"],
                             sh["prompt"], 64), True, "bfloat16"),
            "encoder_d64_f32": (enc, False, "float32"),
            "bwd_encoder_d64": ((sh["grad_batch"], *heads, 1500, 1500, 64),
                                False, "bfloat16")}


def flash_rows(cs, dev, size, rows) -> None:
    """flash_attention at chip_smoke.py's forward shapes, random inputs
    (and Whisper's D = 64 rows, for a tree whose bf16 kernels take it)."""
    import torch
    from repro_torch.configs import get_arch
    cfg, sh = get_arch(cs.LM_ARCH), cs.LM_SHAPES
    heads = (cfg.n_heads, cfg.n_kv_heads)
    fwd = (sh["fwd_batch"], *heads, sh["fwd_seq"], sh["fwd_seq"], cfg.hd)
    shapes = {"forward": (fwd, True, cfg.dtype),
              "prefill": ((sh["serve_batch"], *heads, sh["prompt"],
                           sh["prompt"], cfg.hd), True, cfg.dtype),
              "forward_f32": (fwd, True, "float32"),
              **cs.FLASH_OFF_PATH,
              **{k: v for k, v in whisper_shapes(cs).items()
                 if not k.startswith("bwd_")}}
    g = torch.Generator(device=dev).manual_seed(size.seed)
    for label, (shape, causal, dtype) in shapes.items():
        rows.append(cs.flash_row(label, None,
                                 *cs.random_qkv(shape, g, dtype), causal))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
