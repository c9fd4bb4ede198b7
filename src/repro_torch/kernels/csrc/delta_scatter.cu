// delta_scatter: fold a delta buffer into dense keyed state (Hopper).
//
// Replaces the Pallas kernel repro/kernels/delta_scatter/delta_scatter.py
// (delta_scatter, bodies _kernel_add and _kernel_minmax).  out[N, W] holds
// a copy of the state on entry; delta i (keys[i], payload[i, :]) is
// combined into row r = keys[i] - key_base when r lies in [0, N): add for
// any W, min/max for W = 1.  Other deltas are dropped, the -1 padding with
// them (key_base >= 0).  Callers pass the routed buffer's global keys and
// their shard's first key, so no conversion pass over the buffer precedes
// the launch.
//
// What bounds it: bytes.  It reads the C keys (C*4 bytes) and the payload
// rows of the L in-range deltas (L*4W), and read-modify-writes their state
// rows; the wrapper's state copy reads and writes 2*N*W*4 more.  A routed
// buffer is mostly padding (about 2 % live on the widest rung), so the key
// stream is the traffic.  The TPU kernel replaces the scatter with a
// one-hot (TILE_N x CHUNK) contraction on the MXU, O(N*C) work; on Hopper
// the scatter is direct, and the design reads the keys at the memory's
// rate and spends little on each delta:
//  - One thread per group of 4 consecutive deltas: their keys in one
//    16-byte int4 load, streamed (ld.global.cs: each key is read once and
//    should not evict the state from L2).  A scalar head up to the first
//    16-byte boundary of `keys` and the C % 4 tail are read one key a
//    thread.  Each key is read once.
//  - The row, key - key_base, and its range test are computed in 64-bit
//    registers (row * W can pass 2^31).  No divide: a thread loops over
//    its 4 deltas and, in each, over the W columns.
//  - An in-range delta reads its payload row as float4 chunks at W % 4 ==
//    0 and as one float2 at W = 2 when the payload's base allows it
//    (scalars otherwise), and adds each chunk with one vector atomic
//    (atomicAdd on float4 / float2: red.global.add.v4.f32 / .v2.f32,
//    compute capability 9.x); other W add column by column.
//  - Min/max (W = 1) use common.cuh's integer-punned float atomics, which
//    order floats exactly.
// Atomics stay cheap: both routes combine per key within a source shard
// (scatter_route, or pre_aggregate + delta_route), so a row receives at
// most S deltas (one a source shard) per apply.  Add atomics land in any
// order, so add results match the plain version to rounding.
#include "common.cuh"

namespace {

template <int V> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

// V consecutive payload columns; ALIGNED: p is V*4-byte aligned.
template <int V, bool ALIGNED>
__device__ __forceinline__ typename VecOf<V>::T load_cols(const float* p) {
  if constexpr (V == 1 || ALIGNED)
    return __ldg(reinterpret_cast<const typename VecOf<V>::T*>(p));
  else if constexpr (V == 2)
    return make_float2(__ldg(p), __ldg(p + 1));
  else
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Folds delta i, of key `key`, into its row when the row is in range.
// OP: 0 add, 1 min, 2 max.  V: columns a load and an atomic take (W % V
// == 0).  FW: W when fixed at compile time, else 0 (W is read).
template <int OP, int V, int FW, bool ALIGNED>
__device__ __forceinline__ void fold_delta(float* __restrict__ out,
                                           const float* __restrict__ payload,
                                           long long i, int key,
                                           long long key_base, long long N,
                                           int W) {
  const long long r = (long long)key - key_base;
  if (r < 0 || r >= N) return;
  const int w = FW ? FW : W;
  const float* p = payload + i * w;
  float* o = out + r * w;
  if constexpr (OP == 1) {
    atomic_min_float(o, __ldg(p));
  } else if constexpr (OP == 2) {
    atomic_max_float(o, __ldg(p));
  } else {
#pragma unroll
    for (int c = 0; c < w; c += V)
      atomicAdd(reinterpret_cast<typename VecOf<V>::T*>(o + c),
                load_cols<V, ALIGNED>(p + c));
  }
}

// Item t < groups is the group of keys[head + 4t .. head + 4t + 3], read
// as one int4 (keys + head is 16-byte aligned); the `head` keys before the
// groups and the tail after them are the last items, one key each.
template <int OP, int V, int FW, bool ALIGNED>
__global__ void ds_kernel(float* __restrict__ out,
                          const int* __restrict__ keys,
                          const float* __restrict__ payload, long long N,
                          int W, long long C, long long key_base, int head) {
  const long long groups = (C - head) / 4;
  const long long items = C - 3 * groups;  // groups + head + tail
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < items; t += (long long)gridDim.x * blockDim.x) {
    if (t < groups) {
      const long long i = head + 4 * t;
      const int4 k = __ldcs(reinterpret_cast<const int4*>(keys + i));
      fold_delta<OP, V, FW, ALIGNED>(out, payload, i, k.x, key_base, N, W);
      fold_delta<OP, V, FW, ALIGNED>(out, payload, i + 1, k.y, key_base, N,
                                     W);
      fold_delta<OP, V, FW, ALIGNED>(out, payload, i + 2, k.z, key_base, N,
                                     W);
      fold_delta<OP, V, FW, ALIGNED>(out, payload, i + 3, k.w, key_base, N,
                                     W);
    } else {
      const long long j = t - groups;  // head keys first, then the tail
      const long long i = j < head ? j : 4 * groups + j;
      fold_delta<OP, V, FW, ALIGNED>(out, payload, i, __ldcs(keys + i),
                                     key_base, N, W);
    }
  }
}

template <int OP, int V, int FW, bool ALIGNED>
void launch(float* out, const int* keys, const float* payload, long long N,
            long long W, long long C, long long key_base, int head,
            cudaStream_t stream) {
  const long long items = C - 3 * ((C - head) / 4);
  ds_kernel<OP, V, FW, ALIGNED><<<grid_for(items, 256), 256, 0, stream>>>(
      out, keys, payload, N, (int)W, C, key_base, head);
}

}  // namespace

// op: 0 = add, 1 = min, 2 = max (min/max need W == 1).  out must be
// 16-byte aligned (the atomics write W/4 float4 chunks a row at W % 4 ==
// 0; the wrapper checks); keys and payload may start anywhere their type
// allows.
extern "C" int delta_scatter(void* out_ptr, const void* keys_ptr,
                             const void* payload_ptr, long long N,
                             long long W, long long C, long long key_base,
                             long long op, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* out = (float*)out_ptr;
  const int* keys = (const int*)keys_ptr;
  const float* payload = (const float*)payload_ptr;
  if (C <= 0) return (int)cudaGetLastError();
  // Keys before the first 16-byte boundary (int32 keys are 4-aligned).
  int h = (int)(((16 - ((uintptr_t)keys & 15)) & 15) / 4);
  if (h > C) h = (int)C;
  const bool al16 = ((uintptr_t)payload & 15) == 0;
  const bool al8 = ((uintptr_t)payload & 7) == 0;
  if (op == 1)
    launch<1, 1, 1, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (op == 2)
    launch<2, 1, 1, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W == 1)
    launch<0, 1, 1, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W == 4 && al16)
    launch<0, 4, 4, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W == 4)
    launch<0, 4, 4, false>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W % 4 == 0 && al16)
    launch<0, 4, 0, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W % 4 == 0)
    launch<0, 4, 0, false>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W == 2 && al8)
    launch<0, 2, 2, true>(out, keys, payload, N, W, C, key_base, h, stream);
  else if (W == 2)
    launch<0, 2, 2, false>(out, keys, payload, N, W, C, key_base, h, stream);
  else
    launch<0, 1, 0, true>(out, keys, payload, N, W, C, key_base, h, stream);
  return (int)cudaGetLastError();
}
