// scatter_route: sort-free combine-route for the add, min and max
// combiners (Hopper).
//
// Replaces the Pallas kernel repro/kernels/scatter_route/scatter_route.py
// (scatter_route, body _kernel_scatter_route), whose body is add-only; the
// reference routes min/max through scatter_route_ref, the contract of
// repro/kernels/scatter_route/ops.py:scatter_route_deltas.  For one source
// shard it merges C deltas per key and places each owner's merged keys in
// its segment in ascending-key order, slot owner*cap + rank; filled slots
// get ann 3, the rest PAD / 0 / ann 0.  Count and overflow come from the
// per-owner totals this kernel writes.
//
// What bounds it: bytes.  It reads the C keys and the local index, owner
// and payload of each live delta (L of them), C*4 + L*(8 + 4W) bytes,
// writes S*cap*(5 + 4W) bytes of segments, and touches the S*B-cell slab
// twice.  At the main path's top rung (C = 13.2 M, S*cap = 105.6 M, W = 1)
// the segment writes dominate.  The TPU kernel keeps a B <= 4096 slab in VMEM
// and contracts one-hot matrices on the MXU; here B = 412,500 cells a
// shard, which no shared memory holds, so the slab lives in global memory
// (L2-resident at 3.3 MB of payload + occupancy a shard) and:
//   first   three memsets clear the segments (PAD / 0 / ann 0), and the
//           slab starts at the combiner's identity (0, +inf or -inf: a
//           fill kernel, since a memset cannot write the infinities);
//   pass 1  combines payload into slab[owner*B + local] atomically (add,
//           or the integer-punned min/max of common.cuh) and marks the
//           cell occupied (a plain store: every writer stores 1);
//   pass 2  counts occupied cells per 1024-cell tile of each owner
//           (__syncthreads_count), then scans the tile counts per owner;
//   pass 3  ranks cells inside each tile with a block scan and writes
//           cell -> slot for rank < cap, decoding the key from the cell
//           index (owner*B + cell), so keys need no 2^24 bound.
// Float adds land in atomic order, so add-merged payloads match the plain
// version to rounding (1e-5 relative); min/max payloads and the integer
// outputs match exactly.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__global__ void sr_fill(float* __restrict__ slab, long long n, float v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    slab[i] = v;
}

__global__ void sr_accumulate(const int* __restrict__ keys,
                              const float* __restrict__ payload,
                              const int* __restrict__ local,
                              const int* __restrict__ owners, long long C,
                              int W, int S, long long B, int op,
                              float* __restrict__ slab,
                              int* __restrict__ occ) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < C;
       i += (long long)gridDim.x * blockDim.x) {
    if (keys[i] == kPadKey) continue;  // padding: owner and local unread
    const int o = owners[i];
    const int l = local[i];
    if (o < 0 || o >= S || l < 0 || l >= B) continue;
    const long long cell = o * B + l;
    for (int w = 0; w < W; ++w)
      atomic_combine(&slab[cell * W + w], payload[i * W + w], op);
    occ[cell] = 1;
  }
}

__global__ void sr_tile_count(const int* __restrict__ occ, long long B,
                              int ntiles, int* __restrict__ tile_cnt) {
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const long long cell = (long long)t * kTile + threadIdx.x;
  const int live = cell < B ? occ[s * B + cell] : 0;
  const int n = __syncthreads_count(live);
  if (threadIdx.x == 0) tile_cnt[(long long)s * ntiles + t] = n;
}

__global__ void sr_place(const int* __restrict__ occ,
                         const float* __restrict__ slab, long long B,
                         int ntiles, long long cap, int W,
                         const int* __restrict__ tile_off,
                         int* __restrict__ out_keys,
                         float* __restrict__ out_payload,
                         int8_t* __restrict__ out_ann) {
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int base = tile_off[(long long)s * ntiles + t];
  if (base >= cap) return;  // uniform per block: the segment is full
  const long long cell = (long long)t * kTile + threadIdx.x;
  const int live = cell < B ? occ[s * B + cell] : 0;
  int total;
  const int rank = base + block_exclusive_scan(live, &total);
  if (live && rank < cap) {
    const long long slot = s * cap + rank;
    out_keys[slot] = (int)(s * B + cell);
    out_ann[slot] = kAnnAdjust;
    for (int w = 0; w < W; ++w)
      out_payload[slot * W + w] = slab[(s * B + cell) * W + w];
  }
}

}  // namespace

// op: 0 = add, 1 = min, 2 = max (any W).
extern "C" int scatter_route(
    const void* keys, const void* payload, const void* local,
    const void* owners, long long C, long long W, long long S, long long B,
    long long cap, long long op, void* slab, void* occ, void* tile_cnt,
    void* tile_off, void* out_keys, void* out_payload, void* out_ann,
    void* per_owner, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  clear_segments(out_keys, out_payload, out_ann, S * cap, W, stream);
  const int ntiles = (int)((B + kTile - 1) / kTile);
  const long long cells = S * B * W;
  if (op == 0)
    cudaMemsetAsync(slab, 0, sizeof(float) * cells, stream);
  else if (cells > 0)
    sr_fill<<<grid_for(cells, 256), 256, 0, stream>>>(
        (float*)slab, cells, op == 1 ? INFINITY : -INFINITY);
  cudaMemsetAsync(occ, 0, sizeof(int) * S * B, stream);
  if (C > 0)
    sr_accumulate<<<grid_for(C, 256), 256, 0, stream>>>(
        (const int*)keys, (const float*)payload, (const int*)local,
        (const int*)owners, C, (int)W, (int)S, B, (int)op, (float*)slab,
        (int*)occ);
  const dim3 tiles(ntiles, (unsigned)S);
  sr_tile_count<<<tiles, kTile, 0, stream>>>((const int*)occ, B, ntiles,
                                             (int*)tile_cnt);
  owner_tile_scan<<<(unsigned)S, kScanThreads, 0, stream>>>(
      (const int*)tile_cnt, (int*)tile_off, (int*)per_owner, ntiles);
  sr_place<<<tiles, kTile, 0, stream>>>(
      (const int*)occ, (const float*)slab, B, ntiles, cap, (int)W,
      (const int*)tile_off, (int*)out_keys, (float*)out_payload,
      (int8_t*)out_ann);
  return (int)cudaGetLastError();
}
