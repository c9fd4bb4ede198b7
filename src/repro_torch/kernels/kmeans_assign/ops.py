"""Public op: nearest centroid per point through the kmeans_assign kernel.

On a CUDA tensor :func:`assign` launches the kernel
(``csrc/kmeans_assign.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).  Any N: the kernel masks nothing and pads nothing.
:func:`uses_table` picks, by shape alone, which of the source's two
kernels a call runs: the constant-table kernel at D = 2 and K up to
``TABLE_K``, the shared-memory kernel at any other shape.

The constant table is one per process and card, so the constant-table
kernel runs on the default stream only (a call from another stream
raises), and a call holds a lock from the table's copy to the kernel's
launch, so two threads cannot interleave them on the stream.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

SMEM_BYTES = 232_448   # opt-in shared memory of one block on Hopper
TABLE_K = 32           # rows of the constant table (kTableK), at D = 2

launches = 0           # kernel launches since the last reset

_table_lock = threading.Lock()


def uses_table(k: int, d: int) -> bool:
    """Whether K centroids of D dimensions run the constant-table kernel
    (else the shared-memory kernel)."""
    return d == 2 and k <= TABLE_K


def assign(points: torch.Tensor, centroids: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """points f32[N, D]; centroids f32[K, D] -> (assign int32[N], d2
    f32[N]): argmin_k of ``|p|^2 - 2 p.c_k + |c_k|^2``, ties to the first
    k, and its value."""
    if not points.is_cuda:
        return kmeans_assign_ref(points, centroids)
    n, d = points.shape
    k, dc = centroids.shape
    if d != dc:
        raise ValueError(f"points have D={d}, centroids D={dc}")
    if k < 1:
        raise ValueError("kmeans_assign needs at least one centroid")
    table = uses_table(k, d)
    if not table and k * (d + 1) * 4 > SMEM_BYTES:
        raise ValueError(
            f"kmeans_assign keeps K*(D+1) floats in shared memory: K={k}, "
            f"D={d} needs {k * (d + 1) * 4} bytes, more than {SMEM_BYTES}")
    from repro_torch.kernels import _build
    global launches
    stream = _build.stream_of(points)
    if table and stream != torch.cuda.default_stream(
            points.device).cuda_stream:
        raise RuntimeError(
            "kmeans_assign at D = 2, K <= 32 keeps its centroids in one "
            "constant table per process and runs on the default stream "
            "only")
    lib = _build.library()
    out_assign = torch.empty((n,), dtype=torch.int32, device=points.device)
    out_d2 = torch.empty((n,), dtype=torch.float32, device=points.device)
    # The constant-table kernel's scratch: (c_0, c_1, |c|^2, unused) a row.
    scratch = (torch.empty((TABLE_K, 4), dtype=torch.float32,
                           device=points.device) if table else None)
    p = _build.ptr
    with _table_lock:
        err = lib.kmeans_assign(
            p(points, torch.float32, "points"),
            p(centroids, torch.float32, "centroids"), n, d, k,
            scratch.data_ptr() if table else None, out_assign.data_ptr(),
            out_d2.data_ptr(), stream)
    _build.check(err, "kmeans_assign")
    launches += 1
    return out_assign, out_d2
