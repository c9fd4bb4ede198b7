"""Point sets for k-means (paper §6 "Data": DBPedia geo coordinates,
328,232 points enlarged up to 382M by simulating extra points around each
original).  The same construction as the reference's ``data/points.py``: a
base set of cluster centers with Gaussian clouds, plus a jitter term that
models the enlargement.  The numpy streams are the reference's, so the
points are equal bit for bit."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_geo_points(n_points: int, n_true_clusters: int = 32,
                    spread: float = 3.0, jitter: float = 0.15, seed: int = 0,
                    device=None) -> torch.Tensor:
    """f32[n_points, 2] (lon/lat-like) drawn around ``n_true_clusters``
    centers, on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-90, 90, size=(n_true_clusters, 2))
    assign = rng.integers(0, n_true_clusters, size=n_points)
    # In place: the reference's `centers[assign] + normal` and `+= jitter`
    # round alike, and the host holds one float64 array fewer.
    pts = centers[assign]
    del assign
    pts += rng.normal(0.0, spread, size=(n_points, 2))
    pts += rng.normal(0.0, jitter, size=pts.shape)
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


def sample_initial_centroids(points: torch.Tensor, k: int, seed: int = 1
                             ) -> torch.Tensor:
    """KMSampleAgg (paper appendix): ``k`` distinct points, drawn as the
    reference draws them, on the points' device."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[0], size=k, replace=False)
    return points[torch.from_numpy(idx).to(points.device)]
