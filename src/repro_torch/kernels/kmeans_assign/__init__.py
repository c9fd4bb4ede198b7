from repro_torch.kernels.kmeans_assign.ops import assign
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref, kmeans_d2

__all__ = ["assign", "kmeans_assign_ref", "kmeans_d2"]
