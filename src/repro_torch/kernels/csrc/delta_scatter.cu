// delta_scatter: fold a delta buffer into dense keyed state (Hopper).
//
// Replaces the Pallas kernel repro/kernels/delta_scatter/delta_scatter.py
// (delta_scatter, bodies _kernel_add and _kernel_minmax).  out[N, W] holds
// a copy of the state on entry; each delta (idx[i], payload[i, :]) with
// idx in [0, N) is combined into row idx: add for any W, min/max for W=1.
// Out-of-range idx (the -1 padding included) are skipped.
//
// What bounds it: bytes.  It reads the C indices and the payload of each
// in-range delta (L of them), C*4 + L*4W bytes, and read-modify-writes at
// most L*W state words; the state copy the wrapper makes costs 2*N*W*4
// more.  The TPU kernel replaces the scatter with a
// one-hot (TILE_N x CHUNK) contraction on the MXU, O(N*C) work; on Hopper
// the scatter is direct: one thread per (delta, column) and an atomic in
// L2.  Min/max use the integer-punned float atomics of common.cuh, which
// order floats exactly.  Add atomics land in any order, so add results
// match the plain version to rounding.
#include "common.cuh"

namespace {

__global__ void ds_kernel(float* __restrict__ out, const int* __restrict__ idx,
                          const float* __restrict__ payload, long long N,
                          int W, long long C, int op) {
  const long long total = C * W;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = W == 1 ? e : e / W;  // skip the 64-bit divide
    const int d = idx[i];
    if (d < 0 || d >= N) continue;
    atomic_combine(&out[(long long)d * W + (e - i * W)], payload[e], op);
  }
}

}  // namespace

// op: 0 = add, 1 = min, 2 = max (min/max need W == 1).
extern "C" int delta_scatter(void* out, const void* idx, const void* payload,
                             long long N, long long W, long long C,
                             long long op, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (C > 0)
    ds_kernel<<<grid_for(C * W, 256), 256, 0, stream>>>(
        (float*)out, (const int*)idx, (const float*)payload, N, (int)W, C,
        (int)op);
  return (int)cudaGetLastError();
}
