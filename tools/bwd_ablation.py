#!/usr/bin/env python3
"""What holds the bf16 flash-attention backward back, on one CUDA card.

    python3 tools/bwd_ablation.py [--seed 0]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu`` as it
is and in variants that take one part out or change one setting, each as a
library of its own (nvcc, sm_90a, into a temporary directory), and times
each variant's three launches (Delta, dK dV, dQ) by their device time in
torch.profiler's trace, at ``lm_train``'s layer shape (chip_smoke.py's
TRAIN_SHAPES and olmo-1b's heads; standard normal bf16 inputs, the forward
kernel's log-sum-exp).  The variants that take work out compute wrong
gradients and are times only; the others must give the kernel's gradients
bit for bit, and are checked so:

* ``as_is``: the kernel;
* ``no_exp``: P without its exponential (the score's exponent itself);
* ``scores_only``: no dV, dK or dQ products (and so no P or dS);
* ``updates_only``: no score products (S and dP read as 0);
* ``stages_3``, ``stages_4``: a deeper ring in the dK dV pass (dQ's
  128-row K and V tiles leave room for 2; checked bit for bit);
* ``head_major``: a 1-D grid whose neighbouring blocks are one head's
  tiles, heaviest first within the head (checked bit for bit).

Prints one line a variant and one JSON line with the card.  Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
KERNELS = ("bwd_delta", "bwd_dkdv", "bwd_dq")
# Variants that must give the kernel's gradients bit for bit.
EXACT = ("as_is", "stages_3", "stages_4", "head_major")
HEAD_MAJOR = [
    ("  const int bhk = blockIdx.x;",
     "  const int n_k = (S + kBig - 1) / kBig;\n"
     "  const int bhk = blockIdx.x / n_k;"),
    ("  const int k0 = blockIdx.y * kBig;             // heaviest tiles "
     "first",
     "  const int k0 = (blockIdx.x % n_k) * kBig;"),
    ("  const int bh = blockIdx.x;\n"
     "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBig;",
     "  const int n_qt = Tp / kBig;\n"
     "  const int bh = blockIdx.x / n_qt;\n"
     "  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * kBig;"),
    ("bwd_dkdv<<<dim3((unsigned)(B * H_kv), (unsigned)((S + kBig - 1) / "
     "kBig)),",
     "bwd_dkdv<<<(unsigned)(B * H_kv * ((S + kBig - 1) / kBig)),"),
    ("bwd_dq<<<dim3((unsigned)(B * H), (unsigned)(tp / kBig)),",
     "bwd_dq<<<(unsigned)(B * H * (tp / kBig)),"),
]


def variant(name: str, src: str) -> str:
    """The kernel's source with ``name``'s change applied."""
    subs: list = []
    if name == "no_exp":
        subs = [("float p0 = ex2(", "float p0 = ("),
                ("float p1 = ex2(", "float p1 = (")]
    elif name == "scores_only":
        subs = [(ln, "") for ln in (
            "update<kSmall>(acc_dv, pb, do_addr);",
            "update<kSmall>(acc_dk, dsb, q_addr);",
            "update<kBig>(acc, dsb, k_addr);")]
    elif name == "updates_only":
        for call, n in (("scores(st, k_addr, kBigChunk, q_addr);", 32),
                        ("scores(dpt, v_addr, kBigChunk, do_addr);", 32),
                        ("scores(sc, q_addr, kBigChunk, k_addr);", 64),
                        ("scores(dp, do_addr, kBigChunk, v_addr);", 64)):
            acc = call.split("(")[1].split(",")[0]
            subs.append((call, f"for (int z = 0; z < {n}; ++z) "
                               f"{acc}[z] = 0.f;"))
    elif name.startswith("stages_"):
        return kv_stages(src, int(name[-1]))
    elif name == "head_major":
        subs = HEAD_MAJOR
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def kv_stages(src: str, n: int) -> str:
    """The source with an n-stage ring in the dK dV pass alone: its
    layout constants and kernel read kKvStages in place of kStages."""
    src = src.replace("constexpr int kStages = 2;",
                      f"constexpr int kStages = 2;\n"
                      f"constexpr int kKvStages = {n};", 1)
    for start, end in (("// dK dV: K, V", "// dQ: Q, dO"),
                       ("    bwd_dkdv(const __grid_constant__",
                        "// ---- 3. dQ")):
        i, j = src.index(start), src.index(end)
        src = src[:i] + re.sub(r"\bkStages\b", "kKvStages",
                               src[i:j]) + src[j:]
    return src


def build(name: str, src: str, tmp: Path):
    """The variant's library, loaded, and its register and spill lines."""
    from repro_torch.kernels import _build
    cu = tmp / f"bwd_{name}.cu"
    cu.write_text(src)
    lib = tmp / f"libbwd_{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                        "-Xptxas", "-v", "-shared", "-o", str(lib), str(cu),
                        "-lcudart"], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_bf16
    fn.argtypes = _build.SIGNATURES["flash_attention_bwd_bf16"]
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in r.stderr.splitlines() if "spill" in ln]


def device_ms(run, reps: int = 20) -> dict:
    """Device ms a call of each of KERNELS, from the profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    out = {k: 0.0 for k in KERNELS}
    for e in events:
        for k in KERNELS:
            if e.get("cat") == "kernel" and k in str(e.get("name")):
                out[k] += e.get("dur", 0.0) / 1e3 / reps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bwd_ablation: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    cfg, sh = get_arch(cs.TRAIN_ARCH), cs.TRAIN_SHAPES
    b, h, h_kv, t = (sh["batch"] // sh["microbatches"], cfg.n_heads,
                     cfg.n_kv_heads, sh["seq"])
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = cs.random_qkv((b, h, h_kv, t, t, cfg.hd), g, cfg.dtype)
    o, lse = fa.attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=g, device=dev).to(q.dtype)
    want = fa.attention_bwd(q, k, v, o, do, lse=lse)
    base = (CSRC / "flash_attention_bwd_bf16.cu").read_text()
    out: dict = {"card": cs.card_line(),
                 "shape": [b, h, h_kv, t, t, cfg.hd]}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("as_is", "no_exp", "scores_only", "updates_only",
                     "stages_3", "stages_4", "head_major"):
            fn, spills = build(name, variant(name, base), Path(tmp))
            grads = [torch.empty_like(x) for x in (q, k, v)]
            delta = torch.empty_like(lse)

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), lse.data_ptr(), b, h,
                         h_kv, t, t, cfg.hd, 1,
                         *(x.data_ptr() for x in grads), delta.data_ptr(),
                         dev.index or 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            ms = device_ms(run)
            row = {"ms": {k: round(x, 4) for k, x in ms.items()},
                   "spills": spills}
            if name in EXACT:
                row["bitwise_equal"] = all(
                    torch.equal(a, w) for a, w in zip(grads, want))
            out[name] = row
            print(name, row, flush=True)
    print(json.dumps(out))
    return 0 if all(out[n]["bitwise_equal"] for n in EXACT) else 1


if __name__ == "__main__":
    sys.exit(main())
