"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot spots.

Each subpackage has ``ops.py`` (the wrapper: launches the kernel on a CUDA
tensor or raises, runs the plain version on a CPU tensor, and counts its
launches in ``ops.launches``), ``ref.py`` (the plain torch version) and a
source under ``csrc/``:

  scatter_route   sort-free combine-route, add/min/max (slab + per-owner
                  scan)
  delta_route     stable per-owner bucketing (tile histograms + scan)
  delta_scatter   delta buffer -> dense keyed state (atomics)
  edge_propagate  pull over a ragged destination-grouped CSC (rows binned
                  once: a thread per light row, a warp per heavy row)
  kmeans_assign   nearest centroid per point (thread per point; centroids
                  in constant memory at D = 2, K <= 32, else in shared
                  memory)
  flash_attention blocked online-softmax attention, GQA, causal or not
                  (block per query tile, K/V tiles in shared memory, float32
                  FMA)

``csrc/common.cuh`` holds what several sources share: the integer-punned
float min/max atomics, the block scan and the segment clearing.

``_build.py`` compiles every source with nvcc into one library on first use.
"""
