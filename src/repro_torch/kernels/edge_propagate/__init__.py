from repro_torch.kernels.edge_propagate.ops import (HEAVY_EDGES, CSCCache,
                                                    RaggedCSC, build_csc,
                                                    edge_propagate)
from repro_torch.kernels.edge_propagate.ref import edge_propagate_ref

__all__ = ["CSCCache", "HEAVY_EDGES", "RaggedCSC", "build_csc", "edge_propagate",
           "edge_propagate_ref"]
