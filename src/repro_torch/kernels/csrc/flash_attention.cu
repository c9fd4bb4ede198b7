// flash_attention: blocked online-softmax attention, GQA, causal or not
// (Hopper, float32 on the CUDA cores).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention, body _kernel): for q f32[B, H, T, D] and k, v
// f32[B, H_kv, S, D], query head h reads KV head h / (H / H_kv), and
//   o[t] = sum_s softmax_s(q[t].k[s] / sqrt(D)) v[s],
// with masked scores at -1e30, causal blocks above the diagonal skipped, the
// denominator clamped at 1e-30, and the (m, l, acc) statistics of each query
// row kept on chip across the KV loop, so the [T, S] scores never reach HBM.
// The TPU kernel walks the KV blocks as the third, sequential grid axis with
// the statistics in VMEM scratch.
//
// What bounds it: operations.  The work is 4*B*H*T*S*D float32 operations
// (half that when causal), 275 GFLOP at B = 2, H = 32, T = S = 4096,
// D = 128 (4.1 ms at 67 TFLOP/s), against 335 MB of q, k, v and o (0.1 ms
// at 3.35 TB/s).  The contract is float32, so this kernel uses float32 FMA
// on the CUDA cores: no tensor cores and no TF32 (which keeps about three
// digits).
//
// Design: one block of 256 threads per (b*h, 64-row query tile), a loop over
// 64-row KV tiles inside the block in place of the TPU's sequential grid
// axis, heaviest (last) query tiles scheduled first.  The block stages Q
// once and each K/V tile in shared memory; Q and K are stored transposed
// ([D][64], row stride 68, written free of bank conflicts by a warp layout
// of 16 rows by 8 columns) so that each thread reads four rows of Q and four
// columns of K per step of d as two float4 loads and does 16 FMAs with
// them (a 4x4 register tile of the 64x64 scores).  The row max and row sum
// are reduced over the 16 lanes that share a query row by shuffles; m, l and
// the 4 x D/16 output accumulators of each thread stay in registers.  P is
// written transposed into the K region (K is dead by then) and multiplied
// with V from shared memory.  Shared memory is (2 * 68 + 64) * D floats at
// D >= 64, 100 KB at D = 128: two blocks an SM.  The kernel masks the
// ragged edges of T and S itself (zero-filled tiles, masked columns), so
// any T and S run.  Head dims 16, 32, 64 and 128 are template instances.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // query rows and KV rows per tile
constexpr int kLd = kTile + 4;      // row stride of the transposed tiles
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

// The K region also holds P^T [kTile][kLd], so it is at least that tall.
template <int D>
__host__ __device__ constexpr int kt_rows() {
  return D > kTile ? D : kTile;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return (D + kt_rows<D>()) * kLd + kTile * D;   // Qt, Kt / P^T, V
}

// Copies rows [row0, row0 + 64) of a [n_rows, D] matrix into shared memory
// transposed (dst[d * kLd + r]), zero past n_rows.  A warp takes 16 rows
// by two float4 columns: a store of component c lands in bank
// (16 * (d / 4) + 4 * c + r) % 32 (kLd = 68), so the warp's 32 stores hit
// 32 banks, and each row's two float4 are one 32-byte sector of the read.
// (A warp on one row and 32 columns, at D = 128, hit 2 banks: 16-way.)
template <int D>
__device__ __forceinline__ void load_transposed(float* dst,
                                                const float* __restrict__ src,
                                                int row0, int n_rows) {
  constexpr int kVec = D / 4;           // float4 columns, even at every D
  constexpr int kRowGroups = kTile / 16;
  static_assert(kVec % 2 == 0 && kThreads % 32 == 0, "warp layout");
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int lane = i % 32;
    const int w = i / 32;
    const int r = (w % kRowGroups) * 16 + lane % 16;
    const int d = ((w / kRowGroups) * 2 + lane / 16) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * D +
                                           d);
    dst[(d + 0) * kLd + r] = v.x;
    dst[(d + 1) * kLd + r] = v.y;
    dst[(d + 2) * kLd + r] = v.z;
    dst[(d + 3) * kLd + r] = v.w;
  }
}

// Copies rows [row0, row0 + 64) of a [n_rows, D] matrix into shared memory
// as they are (dst[r * D + d]), zero past n_rows.
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * D +
                                           (i % kVec) * 4);
    *reinterpret_cast<float4*>(dst + i * 4) = v;
  }
}

// Output column of a thread's accumulator j: groups of four adjacent
// columns, 16 lanes apart, when a thread holds four or more (float4 loads
// of V); otherwise the thread's D/16 adjacent columns.
template <int D>
__device__ __forceinline__ int out_col(int tx, int j) {
  constexpr int kCols = D / 16;
  if constexpr (kCols >= 4)
    return ((j / 4) * 16 + tx) * 4 + (j % 4);
  else
    return tx * kCols + j;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int group, int T, int S, int causal, float scale) {
  constexpr int kCols = D / 16;     // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                 // [D][kLd]
  float* kt = smem + D * kLd;       // [D][kLd]; P^T [kTile][kLd] later
  float* vs = kt + kt_rows<D>() * kLd;  // [kTile][D]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh % H) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16;  // score columns tx*4.., output columns
  const int ty = threadIdx.x / 16;  // query rows ty*4 .. ty*4+3

  const float* qb = q + (long long)bh * T * D;
  const long long kv_off = ((long long)b * (H / group) + hk) * S * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  load_transposed<D>(qt, qb, q0, T);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (S + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q0 / kTile + 1);  // none above the diagonal
  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();                // the last tile's P and V are consumed
    load_transposed<D>(kt, kb, k0, S);
    load_rows<D>(vs, vb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // Scale, mask, online softmax over this tile's 64 columns.
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < S && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                // every thread is done reading K
    float* pt = kt;                 // P^T [kTile][kLd]
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[kCols];
      if constexpr (kCols >= 4) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              vs + c * D + (g * 16 + tx) * 4);
          vv[g * 4 + 0] = w.x;
          vv[g * 4 + 1] = w.y;
          vv[g * 4 + 2] = w.z;
          vv[g * 4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) vv[j] = vs[c * D + tx * kCols + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + (long long)bh * T * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[(long long)row * D + out_col<D>(tx, j)] = acc[i][j] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int H_kv, int T, int S, int causal, cudaStream_t stream) {
  // 1/sqrt(D) rounded once, as the reference's Python-float scale is.
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fa_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid(B * H, (T + kTile - 1) / kTile);
  fa_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, H, H / H_kv, T, S, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32[B, H, T, D], k/v f32[B, H_kv, S, D] -> o f32[B, H, T, D].  The
// wrapper has checked D in {16, 32, 64, 128}, H % H_kv == 0, T = S when
// causal, B * H < 2^31 and ceil(T / 64) < 65536.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               long long B, long long H, long long H_kv,
                               long long T, long long S, long long D,
                               long long causal, void* o, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B * H * T == 0) return (int)cudaGetLastError();
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, B, H, H_kv, T, S, c, stream);
    case 32:
      return launch<32>(qf, kf, vf, of, B, H, H_kv, T, S, c, stream);
    case 64:
      return launch<64>(qf, kf, vf, of, B, H, H_kv, T, S, c, stream);
    case 128:
      return launch<128>(qf, kf, vf, of, B, H, H_kv, T, S, c, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
