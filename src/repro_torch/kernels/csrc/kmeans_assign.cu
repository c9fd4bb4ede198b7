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
// threads over the points and a strict `<` scan over k, so ties go to the
// first index as jnp.argmin / torch.argmin do.  In practice it is bound
// by instruction issue: each (point, centroid) pair needs four rounded
// float ops, a compare and two selects, and anything more per pair
// (operand loads, loop control) is paid 12 G times at N = 382 M, K = 32.
// Two kernels, chosen by shape:
//   - D = 2, K <= 32 (the paper's geo points; bench_kmeans.py's k is 32):
//     a first tiny launch writes (c_0, c_1, |c|^2) per centroid to a
//     scratch table of 32 rows, the rows past K padded with |c|^2 = +inf,
//     which is copied device-to-device on the stream into __constant__
//     memory.  The kernel is compiled for K rounded up to 8, 16 or 32: a
//     padded row's d2 is +inf (or NaN where the point is not finite) and
//     never passes the strict `<`, so it changes nothing.  A thread takes
//     kTablePoints points with no loop over points and an unrolled k
//     loop, so the pairs run the seven instructions above with no
//     shared-memory load and no loop control;
//     ptxas stages the centroids from the constant bank in uniform
//     registers, about 0.3 ULDC a pair at 8 points a thread (a grid-stride
//     loop over points made it reload them every iteration, 10.3
//     instructions a pair in all against 7.9 here).  The constant table is
//     one per process (per card), so two calls must not overlap between
//     the copy and the kernel: the wrapper runs this kernel on the default
//     stream only and holds a lock across the call.
//   - any other shape: the K*D centroids and their K norms staged once per
//     block in shared memory, D = 2 a compile-time case with the point in
//     registers, any other D the generic loop.
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

constexpr int kTableK = 32;  // rows of the constant table: K <= 32, D = 2
constexpr int kTablePoints = 8;  // its points a thread (of 1, 2, 4, 8:
                                 // the fastest)
__constant__ float4 kc_table[kTableK];  // (c_0, c_1, |c|^2, unused)

// One block of kTableK threads: centroid k's row of the table, |c|^2
// rounded as ka_kernel rounds it; rows K.. are (0, 0, +inf).
__global__ void ka_fill_table(const float* __restrict__ cents, int K,
                              float4* __restrict__ table) {
  const int k = threadIdx.x;
  if (k >= K) {
    table[k] = make_float4(0.0f, 0.0f, INFINITY, 0.0f);
    return;
  }
  const float c0 = cents[2 * k], c1 = cents[2 * k + 1];
  float s = 0.0f;
  s = __fadd_rn(s, __fmul_rn(c0, c0));
  s = __fadd_rn(s, __fmul_rn(c1, c1));
  table[k] = make_float4(c0, c1, s, 0.0f);
}

// ka_kernel<2>'s arithmetic with the first kK rows of kc_table.  The cross
// term starts with a product instead of an FMA onto 0: the two differ
// only in the sign of a zero, which p2 - cross cannot see (p2 >= +0).
// kTablePoints points a thread, 256 apart (coalesced), with no loop over
// points: each centroid is fetched once a thread and serves all its
// points.
template <int kK>
__global__ void __launch_bounds__(256)
    ka_table_kernel(const float* __restrict__ points, long long N,
                    int* __restrict__ assign, float* __restrict__ dist) {
  const long long first =
      (long long)blockIdx.x * (256 * kTablePoints) + threadIdx.x;
  float p2[kTablePoints], t0[kTablePoints], t1[kTablePoints];
  float best_d[kTablePoints];
  int best[kTablePoints];
#pragma unroll
  for (int j = 0; j < kTablePoints; ++j) {
    const long long i = min(first + j * 256, N - 1);  // the tail: unwritten
    const float v0 = points[2 * i], v1 = points[2 * i + 1];
    p2[j] = 0.0f;
    p2[j] = __fadd_rn(p2[j], __fmul_rn(v0, v0));
    p2[j] = __fadd_rn(p2[j], __fmul_rn(v1, v1));
    t0[j] = 2.0f * v0;  // exact
    t1[j] = 2.0f * v1;
    best[j] = 0;
    best_d[j] = INFINITY;
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int j = 0; j < kTablePoints; ++j) {
      const float cross = __fmaf_rn(t1[j], kc_table[k].y,
                                    __fmul_rn(t0[j], kc_table[k].x));
      const float d2 = __fadd_rn(__fsub_rn(p2[j], cross), kc_table[k].z);
      if (d2 < best_d[j]) {
        best_d[j] = d2;
        best[j] = k;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTablePoints; ++j) {
    const long long i = first + j * 256;
    if (i < N) {
      assign[i] = best[j];
      dist[i] = best_d[j];
    }
  }
}

}  // namespace

// points f32[N, D], centroids f32[K, D] -> assign i32[N], dist f32[N].
// table: NULL for the shared-memory kernel, whose K*(D+1)*4 bytes the
// wrapper has checked against the opt-in shared memory; else a device
// scratch of kTableK float4, and K <= kTableK, D = 2 (the constant-table
// kernel).
extern "C" int kmeans_assign(const void* points, const void* cents,
                             long long N, long long D, long long K,
                             void* table, void* assign, void* dist,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N <= 0) return (int)cudaGetLastError();
  if (table) {
    if (K < 1 || K > kTableK || D != 2) return (int)cudaErrorInvalidValue;
    ka_fill_table<<<1, kTableK, 0, stream>>>((const float*)cents, (int)K,
                                             (float4*)table);
    cudaError_t err = cudaMemcpyToSymbolAsync(
        kc_table, table, sizeof(float4) * kTableK, 0,
        cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (N + 256 * kTablePoints - 1) /
                             (256 * kTablePoints);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const float* pts = (const float*)points;
    if (K <= 8)
      ka_table_kernel<8><<<(int)blocks, 256, 0, stream>>>(
          pts, N, (int*)assign, (float*)dist);
    else if (K <= 16)
      ka_table_kernel<16><<<(int)blocks, 256, 0, stream>>>(
          pts, N, (int*)assign, (float*)dist);
    else
      ka_table_kernel<32><<<(int)blocks, 256, 0, stream>>>(
          pts, N, (int*)assign, (float*)dist);
    return (int)cudaGetLastError();
  }
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
