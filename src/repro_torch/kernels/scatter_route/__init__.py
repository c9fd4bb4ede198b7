from repro_torch.kernels.scatter_route.ops import (scatter_route,
                                                   scatter_route_deltas)
from repro_torch.kernels.scatter_route.ref import scatter_route_ref

__all__ = ["scatter_route", "scatter_route_ref", "scatter_route_deltas"]
