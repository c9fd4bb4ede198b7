"""Public op: nearest centroid per point through the kmeans_assign kernel.

On a CUDA tensor :func:`assign` launches the kernel
(``csrc/kmeans_assign.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``).  Any N: the kernel masks nothing and pads nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

SMEM_BYTES = 232_448   # opt-in shared memory of one block on Hopper

launches = 0           # kernel launches since the last reset


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
    if k * (d + 1) * 4 > SMEM_BYTES:
        raise ValueError(
            f"kmeans_assign keeps K*(D+1) floats in shared memory: K={k}, "
            f"D={d} needs {k * (d + 1) * 4} bytes, more than {SMEM_BYTES}")
    from repro_torch.kernels import _build
    global launches
    lib = _build.library()
    out_assign = torch.empty((n,), dtype=torch.int32, device=points.device)
    out_d2 = torch.empty((n,), dtype=torch.float32, device=points.device)
    p = _build.ptr
    err = lib.kmeans_assign(
        p(points, torch.float32, "points"),
        p(centroids, torch.float32, "centroids"), n, d, k,
        out_assign.data_ptr(), out_d2.data_ptr(), _build.stream_of(points))
    _build.check(err, "kmeans_assign")
    launches += 1
    return out_assign, out_d2
