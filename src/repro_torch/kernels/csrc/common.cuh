// Shared device helpers for the port's kernels: order-exact float min/max
// atomics, a block-wide exclusive scan, the per-owner scan of tile counts,
// and the clearing of routed segments.
// Everything is in an anonymous namespace so each translation unit keeps
// its own copy and the objects link into one library without clashes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadKey = -1;
constexpr int kAnnAdjust = 3;
constexpr int kScanThreads = 1024;

inline int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  return (int)blocks;
}

// Float min/max as integer atomics.  A non-negative float orders like its
// bits read as a signed int, a negative one inversely to its bits read as
// unsigned; so atomicMin on int for v >= 0 and atomicMax on unsigned for
// v < 0 (and the mirror for max) order floats exactly, whatever the order
// in which the atomics land.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (!signbit(v))
    atomicMin((int*)addr, __float_as_int(v));
  else
    atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax((int*)addr, __float_as_int(v));
  else
    atomicMin((unsigned int*)addr, __float_as_uint(v));
}

// Combiner codes shared by the C entry points: 0 add, 1 min, 2 max.
__device__ __forceinline__ void atomic_combine(float* addr, float v, int op) {
  if (op == 0)
    atomicAdd(addr, v);
  else if (op == 1)
    atomic_min_float(addr, v);
  else
    atomic_max_float(addr, v);
}

// Exclusive scan of one int per thread over the whole block (blockDim.x a
// multiple of 32, at most 1024).  Returns the exclusive prefix; *total
// receives the block sum.  Must be reached by every thread of the block.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;  // inclusive prefix of warp sums
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// For each owner s (one block each): exclusive scan of
// tile_cnt[s * ntiles + t] over t into tile_off, and the owner's total into
// per_owner[s].
__global__ void owner_tile_scan(const int* __restrict__ tile_cnt,
                                int* __restrict__ tile_off,
                                int* __restrict__ per_owner, int ntiles) {
  const int s = blockIdx.x;
  const int* cnt = tile_cnt + (long long)s * ntiles;
  int* off = tile_off + (long long)s * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int v = t < ntiles ? cnt[t] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (t < ntiles) off[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) per_owner[s] = carry;
}

// Every slot of the S*cap routed segments starts empty (PAD key, zero
// payload, ann 0); the placement pass then writes the filled ones.  PAD
// is -1, all bytes 0xFF, so three memsets clear them at write bandwidth.
static_assert(kPadKey == -1, "segments are cleared with 0xFF bytes");
inline void clear_segments(void* keys, void* payload, void* ann,
                           long long slots, long long W,
                           cudaStream_t stream) {
  cudaMemsetAsync(keys, 0xFF, sizeof(int) * slots, stream);
  cudaMemsetAsync(payload, 0, sizeof(float) * slots * W, stream);
  cudaMemsetAsync(ann, 0, slots, stream);
}

}  // namespace
