// kmeans_assign: nearest centroid per point, and its squared distance
// (Hopper).
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign/kmeans_assign.py
// (kmeans_assign, body _kernel): for each point p of points[N, D],
//   d2_k = (|p|^2 - 2 p.c_k) + |c_k|^2,  assign = argmin_k d2_k (ties to
//   the first k),  dist = min_k d2_k.
// The TPU kernel forms the cross term as a [TILE_P, D] x [D, K] MXU
// product per point tile with the centroid table resident in VMEM.
//
// What bounds it: bytes.  It reads N*D*4 bytes of points and K*D*4 of
// centroids and writes N*8 (assign + dist); the work is about N*K*(2D+3)
// float32 operations, 86 GFLOP at N = 382 M, D = 2, K = 32 (1.28 ms at
// 67 TFLOP/s) against 6.1 GB of traffic (1.82 ms at 3.35 TB/s).  Design:
// one thread per point (grid-stride), the K*D centroids and their K norms
// staged once per block in shared memory (every lane reads the same
// centroid, a broadcast), a strict `<` scan over k so ties go to the first
// index as jnp.argmin / torch.argmin do.  D = 2, the paper's geo points,
// is a compile-time case with the point held in registers; any other D
// runs the generic loop.
//
// Rounding follows the plain version (kmeans_assign/ref.py on the card):
// |p|^2 and |c|^2 are sums of rounded squares in order over d, the cross
// term accumulates (2p_d) * c_d by fused multiply-adds in order over d as a
// float32 GEMM does, and d2 rounds the subtraction and then the addition.
// Every step is an explicit _rn intrinsic, so the compiler contracts
// nothing.  A different association would move d2 by an ulp of |p|^2
// (about 2e-3 at coordinates of +-95) and flip near-tied assignments.
#include <math.h>

#include "common.cuh"

namespace {

// kDim > 0: the dimension is known at compile time; 0: read it from d.
template <int kDim>
__global__ void ka_kernel(const float* __restrict__ points,
                          const float* __restrict__ cents, long long N,
                          int d_rt, int K, int* __restrict__ assign,
                          float* __restrict__ dist) {
  extern __shared__ float smem[];  // K*D centroids, then K norms
  const int D = kDim > 0 ? kDim : d_rt;
  float* c = smem;
  float* c2 = smem + K * D;
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) c[i] = cents[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < D; ++j)
      s = __fadd_rn(s, __fmul_rn(c[k * D + j], c[k * D + j]));
    c2[k] = s;
  }
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x) {
    const float* p = points + i * D;
    float p2 = 0.0f;
    float twice[kDim > 0 ? kDim : 1];  // 2p, held for the compile-time D
    if constexpr (kDim > 0) {
#pragma unroll
      for (int j = 0; j < kDim; ++j) {
        const float v = p[j];
        p2 = __fadd_rn(p2, __fmul_rn(v, v));
        twice[j] = 2.0f * v;  // exact
      }
    } else {
      for (int j = 0; j < D; ++j) p2 = __fadd_rn(p2, __fmul_rn(p[j], p[j]));
    }
    int best = 0;
    float best_d = INFINITY;
    for (int k = 0; k < K; ++k) {
      const float* ck = c + k * D;
      float cross = 0.0f;
      if constexpr (kDim > 0) {
#pragma unroll
        for (int j = 0; j < kDim; ++j)
          cross = __fmaf_rn(twice[j], ck[j], cross);
      } else {
        for (int j = 0; j < D; ++j)
          cross = __fmaf_rn(2.0f * p[j], ck[j], cross);
      }
      const float d2 = __fadd_rn(__fsub_rn(p2, cross), c2[k]);
      if (d2 < best_d) {
        best_d = d2;
        best = k;
      }
    }
    assign[i] = best;
    dist[i] = best_d;
  }
}

}  // namespace

// points f32[N, D], centroids f32[K, D] -> assign i32[N], dist f32[N].
// The wrapper has checked K*(D+1)*4 bytes against the opt-in shared memory.
extern "C" int kmeans_assign(const void* points, const void* cents,
                             long long N, long long D, long long K,
                             void* assign, void* dist, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (size_t)(K * (D + 1));
  const int blocks = grid_for(N, 256);
  if (D == 2) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ka_kernel<2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    ka_kernel<2><<<blocks, 256, smem, stream>>>(
        (const float*)points, (const float*)cents, N, 2, (int)K,
        (int*)assign, (float*)dist);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ka_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    ka_kernel<0><<<blocks, 256, smem, stream>>>(
        (const float*)points, (const float*)cents, N, (int)D, (int)K,
        (int*)assign, (float*)dist);
  }
  return (int)cudaGetLastError();
}
