// delta_route: stable per-owner bucketing of a delta buffer (Hopper).
//
// Replaces the Pallas kernel repro/kernels/delta_route/delta_route.py
// (delta_route, body _kernel_route).  Delta i with a live key and an owner
// in [0, S) goes to slot owner*cap + rank, where rank counts the earlier
// live deltas with the same owner (input order); deltas with rank >= cap
// are dropped but still take up ranks.  Keys, payload and ann travel
// together; per_owner receives each owner's live count.
//
// What bounds it: bytes.  It reads the C keys and the owner, payload and
// ann of each live delta (L of them), C*4 + L*(9 + 4W) bytes, twice
// (histogram pass, placement pass; the second mostly from L2), and writes
// S*cap*(5 + 4W) bytes of segments.  The TPU
// kernel ranks with a strict-lower-triangular one-hot contraction on the
// MXU (an O(CHUNK^2) matrix per chunk, S < 128 owner lanes, keys carried in
// f32 so below 2^24).  Here:
//   first   three memsets clear the segments (PAD / 0 / ann 0);
//   pass 1  each 1024-delta tile counts its deltas per owner in shared
//           memory (S ints, so S <= 12288 in the default 48 KB);
//   pass 2  one block per owner scans the tile counts across tiles;
//   pass 3  each tile re-ranks its deltas stably: warps take turns in
//           input order, and inside a warp __match_any_sync groups lanes
//           by owner, so a lane's rank is the owner's running count in
//           shared memory plus the popcount of lower peer lanes.
// Keys travel as int32, so there is no key bound and no owner-lane bound
// beyond shared memory.  All outputs are exact.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__device__ __forceinline__ bool live_of(const int* keys, const int* owners,
                                        long long i, long long C, int S,
                                        int* owner) {
  if (i >= C || keys[i] == kPadKey) return false;  // padding: owner unread
  const int o = owners[i];
  *owner = o;
  return o >= 0 && o < S;
}

__global__ void dr_histogram(const int* __restrict__ keys,
                             const int* __restrict__ owners, long long C,
                             int S, int ntiles, int* __restrict__ tile_hist) {
  extern __shared__ int cnt[];
  for (int s = threadIdx.x; s < S; s += blockDim.x) cnt[s] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  int o = 0;
  if (live_of(keys, owners, i, C, S, &o)) atomicAdd(&cnt[o], 1);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    tile_hist[(long long)s * ntiles + blockIdx.x] = cnt[s];
}

__global__ void dr_place(const int* __restrict__ keys,
                         const float* __restrict__ payload,
                         const int8_t* __restrict__ ann,
                         const int* __restrict__ owners, long long C, int W,
                         int S, long long cap, int ntiles,
                         const int* __restrict__ tile_off,
                         int* __restrict__ out_keys,
                         float* __restrict__ out_payload,
                         int8_t* __restrict__ out_ann) {
  extern __shared__ int cnt[];
  for (int s = threadIdx.x; s < S; s += blockDim.x) cnt[s] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  int o = 0;
  const bool live = live_of(keys, owners, i, C, S, &o);
  const int group = live ? o : -1;  // dead lanes group apart
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int rank = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (warp == w) {
      const unsigned peers = __match_any_sync(0xffffffffu, group);
      const int leader = __ffs(peers) - 1;
      const int before = __popc(peers & ((1u << lane) - 1u));
      const int base = live ? cnt[o] : 0;
      __syncwarp();
      if (live && lane == leader) cnt[o] = base + __popc(peers);
      rank = base + before;
    }
    __syncthreads();
  }
  if (!live) return;
  rank += tile_off[(long long)o * ntiles + blockIdx.x];
  if (rank >= cap) return;
  const long long slot = o * cap + rank;
  out_keys[slot] = keys[i];
  out_ann[slot] = ann[i];
  for (int w = 0; w < W; ++w) out_payload[slot * W + w] = payload[i * W + w];
}

}  // namespace

extern "C" int delta_route(const void* keys, const void* payload,
                           const void* ann, const void* owners, long long C,
                           long long W, long long S, long long cap,
                           void* tile_hist, void* tile_off, void* out_keys,
                           void* out_payload, void* out_ann, void* per_owner,
                           void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  clear_segments(out_keys, out_payload, out_ann, S * cap, W, stream);
  const int ntiles = C > 0 ? (int)((C + kTile - 1) / kTile) : 1;
  const size_t smem = sizeof(int) * S;
  dr_histogram<<<ntiles, kTile, smem, stream>>>(
      (const int*)keys, (const int*)owners, C, (int)S, ntiles,
      (int*)tile_hist);
  owner_tile_scan<<<(unsigned)S, kScanThreads, 0, stream>>>(
      (const int*)tile_hist, (int*)tile_off, (int*)per_owner, ntiles);
  dr_place<<<ntiles, kTile, smem, stream>>>(
      (const int*)keys, (const float*)payload, (const int8_t*)ann,
      (const int*)owners, C, (int)W, (int)S, cap, ntiles,
      (const int*)tile_off, (int*)out_keys, (float*)out_payload,
      (int8_t*)out_ann);
  return (int)cudaGetLastError();
}
