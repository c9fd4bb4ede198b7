"""Plain torch version of the kmeans_assign kernel: the expression of
``repro/kernels/kmeans_assign/ref.py`` in the same order."""
from __future__ import annotations

import torch


def kmeans_d2(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """f32[N, K]: ``|p|^2 - 2 p.c + |c|^2`` for every point and centroid."""
    return ((points ** 2).sum(-1, keepdim=True)
            - 2.0 * points @ centroids.T
            + (centroids ** 2).sum(-1))


def kmeans_assign_ref(points: torch.Tensor, centroids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """points f32[N, D]; centroids f32[K, D] -> (assign int32[N], d2 f32[N]):
    the nearest centroid by :func:`kmeans_d2` (ties to the first k) and
    that value."""
    d2 = kmeans_d2(points, centroids)
    return torch.argmin(d2, -1).to(torch.int32), d2.min(-1).values
