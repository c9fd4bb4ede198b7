// edge_propagate: pull over a ragged destination-grouped CSC (Hopper).
//
// Replaces the Pallas kernel repro/kernels/edge_propagate/edge_propagate.py
// (edge_propagate, body _kernel): out[d] = combine over edges s->d of
// payload[s] * w, with combine in {add, min, max}; a destination with no
// edges gets the combiner's identity.
//
// What bounds it: bytes.  It reads (n_dst + 1)*4 bytes of indptr, E*8 of
// (src, w), the gathered payload (N_src*4, L2-resident) and writes
// n_dst*4.  The TPU kernel pads every destination tile to one uniform edge
// count and folds with a one-hot MXU contraction; on the power-law graphs
// of the paper's shape the head-biased destinations make that padding
// explode (the full DBPedia-shaped graph would need ~20 GB of padded CSC
// across 8 shards).  Here the CSC is ragged: destinations sorted, an
// indptr over destinations, src and w per edge, built once per graph (the
// immutable set).  One warp reduces one destination: lanes stride over
// its edges, then a fixed shuffle tree combines the lanes, so the result
// is deterministic and needs no atomics.
#include "common.cuh"

namespace {

__device__ __forceinline__ float combine(float a, float b, int op) {
  return op == 0 ? a + b : (op == 1 ? fminf(a, b) : fmaxf(a, b));
}

__global__ void ep_kernel(const float* __restrict__ payload,
                          const int* __restrict__ indptr,
                          const int* __restrict__ src,
                          const float* __restrict__ weight, long long n_dst,
                          int op, float* __restrict__ out) {
  const float identity =
      op == 0 ? 0.0f : (op == 1 ? __int_as_float(0x7f800000)
                                : __int_as_float(0xff800000));
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long d = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
       d < n_dst; d += warps) {
    const int lo = indptr[d];
    const int hi = indptr[d + 1];
    float acc = identity;
    for (int e = lo + lane; e < hi; e += 32)
      acc = combine(acc, payload[src[e]] * weight[e], op);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = combine(acc, __shfl_down_sync(0xffffffffu, acc, off), op);
    if (lane == 0) out[d] = acc;
  }
}

}  // namespace

// op: 0 = add, 1 = min, 2 = max.
extern "C" int edge_propagate(const void* payload, const void* indptr,
                              const void* src, const void* weight,
                              long long n_dst, long long op, void* out,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_dst > 0)
    ep_kernel<<<grid_for(n_dst * 32, 256), 256, 0, stream>>>(
        (const float*)payload, (const int*)indptr, (const int*)src,
        (const float*)weight, n_dst, (int)op, (float*)out);
  return (int)cudaGetLastError();
}
