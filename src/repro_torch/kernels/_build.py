"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens on first use, into ``build/kernels/`` at the
repository root, and is named by a hash of the sources so an edited source
is rebuilt.  Nothing here includes PyTorch's headers, which keeps a build
to seconds.

C entry points take pointers as ``void*`` (``ctypes.c_void_p``), sizes as
``long long``, the stream last, and return ``cudaGetLastError()``; the
wrappers raise when that is not 0 (see :func:`check`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# Seconds the last build took in this process (0.0 when it was cached).
build_seconds = 0.0

P, I64 = ctypes.c_void_p, ctypes.c_longlong
# C signatures: name -> argtypes (all return int = cudaError_t).
SIGNATURES = {
    # keys, payload, local, owners, C, W, S, B, cap, op,
    # slab, occ, tile_cnt, tile_off, out_keys, out_payload, out_ann,
    # per_owner, stream
    "scatter_route": [P, P, P, P, I64, I64, I64, I64, I64, I64,
                      P, P, P, P, P, P, P, P, P],
    # keys, payload, ann, owners, C, W, S, cap,
    # tile_hist, tile_off, out_keys, out_payload, out_ann, per_owner, stream
    "delta_route": [P, P, P, P, I64, I64, I64, I64,
                    P, P, P, P, P, P, P],
    # out (state copy, updated in place), keys, payload, N, W, C, key_base,
    # op, stream
    "delta_scatter": [P, P, P, I64, I64, I64, I64, I64, P],
    # payload, indptr, src, weight, heavy, n_dst, n_heavy, heavy_edges, op,
    # out, stream
    "edge_propagate": [P, P, P, P, P, I64, I64, I64, I64, P, P],
    # points, centroids, N, D, K, table (NULL: shared-memory kernel),
    # assign, dist, stream
    "kmeans_assign": [P, P, I64, I64, I64, P, P, P, P],
    # q, k, v, B, H, H_kv, T, S, D, causal, out, stream
    "flash_attention": [P, P, P, I64, I64, I64, I64, I64, I64, I64, P, P],
    # the same, then lse2 (NULL: not written), device, stream
    "flash_attention_bf16": [P, P, P, I64, I64, I64, I64, I64, I64, I64, P,
                             P, I64, P],
    # q, k, v, o, do, B, H, H_kv, T, S, D, causal, dq, dk, dv,
    # lse, delta (scratch), stream
    "flash_attention_bwd": [P, P, P, P, P, I64, I64, I64, I64, I64, I64,
                            I64, P, P, P, P, P, P],
    # q, k, v, o, do, lse2 (the forward's), B, H, H_kv, T, S, D, causal,
    # dq, dk, dv, delta (scratch), device, stream
    "flash_attention_bwd_bf16": [P, P, P, P, P, P, I64, I64, I64, I64, I64,
                                 I64, I64, P, P, P, P, I64, P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash is not built yet; returns
    the library path."""
    global build_seconds
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + f"_{lib.stem[-16:]}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib.with_suffix(".so.tmp")
    subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp),
                    *map(str, objs), "-lcudart"], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def stream_of(t) -> int:
    """The current CUDA stream handle for tensor ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t, dtype, name: str) -> int:
    """Device pointer of a contiguous CUDA tensor of ``dtype``; raises on
    anything the kernels do not take."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: kernel takes a contiguous CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()
