from repro_torch.kernels.delta_scatter.ops import apply_delta, delta_scatter
from repro_torch.kernels.delta_scatter.ref import delta_scatter_ref

__all__ = ["delta_scatter", "apply_delta", "delta_scatter_ref"]
