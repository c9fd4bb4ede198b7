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
// immutable set).
//
// Rows are binned by length, once, when the CSC is built: a destination
// with more than heavy_edges edges (the wrapper's HEAVY_EDGES, a warp's
// width) is heavy and is listed in `heavy`; the wrapper derives that list
// from indptr with the same threshold it passes here.  On the
// DBPedia shape a shard's 3.3 M destinations hold 1.8 edges on average:
// 3.27 M light rows (29 % of all rows empty) hold 1.2 each, 33,000 heavy
// rows 62, so a warp per row would leave most lanes idle.  One launch
// covers both bins:
//   - the first blocks give each heavy row a warp: lanes stride over its
//     edges, then a fixed shuffle tree combines them (any length; heavy
//     rows go first so that the longest work starts first);
//   - the remaining blocks give every destination a thread, which folds
//     its edges in edge order and writes out[d], and skips heavy rows.
// Every out[d] is written once, there are no atomics, and the result is
// the same from run to run.  Products and adds are explicit _rn steps, so
// an add-combined light row equals the plain version's slot-order sum bit
// for bit.
#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

template <int kOp>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (kOp == 0) return __fadd_rn(a, b);
  if constexpr (kOp == 1) return fminf(a, b);
  return fmaxf(a, b);
}

template <int kOp>
__device__ __forceinline__ float identity() {
  if constexpr (kOp == 0) return 0.0f;
  if constexpr (kOp == 1) return __int_as_float(0x7f800000);   // +inf
  return __int_as_float(0xff800000);                           // -inf
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
    ep_kernel(const float* __restrict__ payload,
              const int* __restrict__ indptr, const int* __restrict__ src,
              const float* __restrict__ weight,
              const int* __restrict__ heavy, long long n_dst,
              long long n_heavy, int heavy_edges, int heavy_blocks,
              float* __restrict__ out) {
  if ((int)blockIdx.x < heavy_blocks) {  // a warp per heavy row
    const long long w =
        ((long long)blockIdx.x * kThreads + threadIdx.x) / kWarp;
    if (w >= n_heavy) return;  // the whole warp leaves together
    const int lane = threadIdx.x & (kWarp - 1);
    const int d = heavy[w];
    const int hi = indptr[d + 1];
    float acc = identity<kOp>();
    for (int e = indptr[d] + lane; e < hi; e += kWarp)
      acc = combine<kOp>(acc, __fmul_rn(payload[src[e]], weight[e]));
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc = combine<kOp>(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) out[d] = acc;
    return;
  }
  const long long d =
      (long long)(blockIdx.x - heavy_blocks) * kThreads + threadIdx.x;
  if (d >= n_dst) return;
  const int lo = indptr[d];
  const int hi = indptr[d + 1];
  if (hi - lo > heavy_edges) return;  // heavy: its warp writes it
  float acc = identity<kOp>();
  for (int e = lo; e < hi; ++e)
    acc = combine<kOp>(acc, __fmul_rn(payload[src[e]], weight[e]));
  out[d] = acc;
}

}  // namespace

// op: 0 = add, 1 = min, 2 = max.  heavy: the n_heavy destinations with
// more than heavy_edges edges, all of them; every other row is light.
extern "C" int edge_propagate(const void* payload, const void* indptr,
                              const void* src, const void* weight,
                              const void* heavy, long long n_dst,
                              long long n_heavy, long long heavy_edges,
                              long long op, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_dst <= 0) return (int)cudaGetLastError();
  const long long heavy_blocks =
      (n_heavy * kWarp + kThreads - 1) / kThreads;
  const long long blocks = heavy_blocks + (n_dst + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || heavy_edges < 0 || heavy_edges > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* p = (const float*)payload;
  const int* ip = (const int*)indptr;
  const int* s = (const int*)src;
  const float* w = (const float*)weight;
  const int* h = (const int*)heavy;
  float* o = (float*)out;
  const int hb = (int)heavy_blocks, he = (int)heavy_edges;
  if (op == 0)
    ep_kernel<0><<<(int)blocks, kThreads, 0, stream>>>(p, ip, s, w, h, n_dst,
                                                       n_heavy, he, hb, o);
  else if (op == 1)
    ep_kernel<1><<<(int)blocks, kThreads, 0, stream>>>(p, ip, s, w, h, n_dst,
                                                       n_heavy, he, hb, o);
  else
    ep_kernel<2><<<(int)blocks, kThreads, 0, stream>>>(p, ip, s, w, h, n_dst,
                                                       n_heavy, he, hb, o);
  return (int)cudaGetLastError();
}
