from repro_torch.kernels.delta_route.ops import delta_route, route_deltas
from repro_torch.kernels.delta_route.ref import delta_route_ref

__all__ = ["delta_route", "delta_route_ref", "route_deltas"]
