// flash_attention_bwd: the gradient of blocked online-softmax attention
// (GQA, causal or not) with respect to float32 q, k and v, float32
// arithmetic on the CUDA cores.  bf16 operands go to
// flash_attention_bwd_bf16.cu (tensor cores, the forward's statistic).
//
// Replaces no Pallas kernel: the reference has no attention backward and
// trains through its plain attention_ref, which XLA differentiates
// (repro/kernels/flash_attention/ref.py, attention_ref; repro/train/
// train_step.py, use_flash_kernel=False).  The port's models run the flash
// forward kernels on the card, so their gradient needs this kernel; its plain
// version is attention_bwd_ref (kernels/flash_attention/ref.py).  For q
// [B, H, T, D], k and v [B, H_kv, S, D], o and do [B, H, T, D], query head h
// reading KV head h / (H / H_kv), scale = 1/sqrt(D):
//   P = softmax_s(q k^T scale)  (masked s > t when causal, T = S)
//   Delta[t] = sum_d do[t, d] o[t, d]
//   dV = P^T do,  dS = P * (do v^T - Delta),  dQ = dS k scale,
//   dK = dS^T q scale,
// dK and dV summed over the H / H_kv query heads of each KV head.
//
// What bounds it: operations.  A score pair (t, s) kept by the mask costs
// 2 D multiply-adds a product; this design computes q k^T three times and
// do v^T twice, so 8 products in all against the 5 that the function needs
// (10 D FLOP a pair): 172 GFLOP needed at B = 4, H = 16, T = S = 2048,
// D = 128, causal, which is 2.6 ms at the 67 TFLOP/s of float32 FMA,
// against 268 MB of float32 q, k, v, o, do, dq, dk, dv (0.08 ms at
// 3.35 TB/s).  It recomputes the softmax statistics because the float32
// forward kernel does not emit them.
//
// Design: three launches, no atomics, so a run is deterministic and
// independent of B.  Each block has 256 threads in a 16 x 16 layout; a
// thread owns a 4 x 4 tile of a 64 x 64 score block (rows ty*4.., columns
// tx*4..) and 4 rows of D/16 output columns.  Operands are staged in shared
// memory as float32: transposed ([D][68]) where a product contracts over d,
// so a thread reads its 4 rows and 4 columns as two float4 loads a step, and
// as rows ([64][D]) where it contracts over the 64 rows of a tile.
//   1. stats, per (b h, 64-row query tile): the row max m and sum l over
//      the row's keys (the forward's online softmax, without P V), stored as
//      lse = m + log l, and Delta from o and do.
//   2. dK dV, per (b h_kv, 64-row key tile): K and V stay in shared memory;
//      for each query head of the group and each query tile the causal mask
//      reaches, S^T and dP^T come from Q^T and dO^T, P^T = exp(S^T scale -
//      lse) and dS^T go to shared memory, Q and dO are reloaded as rows in
//      the space of their transposes, and dV += P^T dO, dK += dS^T Q stay in
//      registers.  174 KB of shared memory at D = 128.
//   3. dQ, per (b h, 64-row query tile), heaviest causal tiles first: Q^T
//      and dO^T stay; for each key tile, S and dP from K^T and V^T, dS to
//      shared memory, K reloaded as rows, dQ += dS K.  157 KB at D = 128.
// Ragged T and S are masked in the kernels (zero-filled tiles, masked
// pairs).  Not done here: one pass over the pairs for dK, dV and dQ; the
// forward's statistic (the float32 forward does not write it).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // query rows and key rows of a tile
constexpr int kLd = kTile + 4;      // row stride of the transposed tiles
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;   // the forward kernels' mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Rows [row0, row0 + 64) of a [n_rows, D] matrix into shared memory,
// transposed (dst[d * kLd + r]), zero past n_rows.  A warp takes 16 rows by
// two 4-column groups, so its 32 stores of one component land in 32 banks
// (flash_attention.cu's layout).
template <int D>
__device__ __forceinline__ void load_transposed(float* dst,
                                                const float* __restrict__ src,
                                                int row0, int n_rows) {
  constexpr int kVec = D / 4;
  constexpr int kRowGroups = kTile / 16;
  static_assert(kVec % 2 == 0, "warp layout");
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int lane = i % 32;
    const int w = i / 32;
    const int r = (w % kRowGroups) * 16 + lane % 16;
    const int d = ((w / kRowGroups) * 2 + lane / 16) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = load4(src + (long long)(row0 + r) * D + d);
    dst[(d + 0) * kLd + r] = v.x;
    dst[(d + 1) * kLd + r] = v.y;
    dst[(d + 2) * kLd + r] = v.z;
    dst[(d + 3) * kLd + r] = v.w;
  }
}

// Rows [row0, row0 + 64) of a [n_rows, D] matrix into shared memory as rows
// (dst[r * D + d]), zero past n_rows.
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = load4(src + (long long)(row0 + r) * D + (i % kVec) * 4);
    *reinterpret_cast<float4*>(dst + i * 4) = v;
  }
}

// Output column of a thread's accumulator j (flash_attention.cu's layout):
// groups of four adjacent columns, 16 lanes apart, at D >= 64.
template <int D>
__device__ __forceinline__ int out_col(int tx, int j) {
  constexpr int kCols = D / 16;
  if constexpr (kCols >= 4)
    return ((j / 4) * 16 + tx) * 4 + (j % 4);
  else
    return tx * kCols + j;
}

// The thread's D/16 columns of row c of a [64][D] row tile.
template <int D>
__device__ __forceinline__ void row_cols(const float* tile, int c, int tx,
                                         float* out) {
  constexpr int kCols = D / 16;
  if constexpr (kCols >= 4) {
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g) {
      const float4 w =
          *reinterpret_cast<const float4*>(tile + c * D + (g * 16 + tx) * 4);
      out[g * 4 + 0] = w.x;
      out[g * 4 + 1] = w.y;
      out[g * 4 + 2] = w.z;
      out[g * 4 + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[j] = tile[c * D + tx * kCols + j];
  }
}

// acc[i][j] += sum_d a[d][ty*4 + i] * b[d][tx*4 + j] over two transposed
// tiles ([D][kLd]): a 4 x 4 block of A B^T.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kLd + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + d * kLd + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// Stores v[i][j] (the thread's rows ty*4 + i, columns tx*4 + j) transposed:
// dst[(tx*4 + j) * kLd + ty*4 + i].
__device__ __forceinline__ void store_transposed(float* dst, int ty, int tx,
                                                 const float v[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kLd + ty * 4) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// ---- 1. row statistics ----------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_stats(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int H,
              int group, int Tq, int S, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* kt = qt + D * kLd;                      // [D][kLd]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh % H) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long q_off = (long long)bh * Tq * D;
  const float* kb = k + ((long long)b * (H / group) + hk) * S * D;

  // Delta: four threads a row, D/4 columns each.
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    float sum = 0.f;
    if (q0 + r < Tq) {
      const long long base = q_off + (long long)(q0 + r) * D + part * (D / 4);
#pragma unroll
      for (int d = 0; d < D / 4; d += 4) {
        const float4 x = load4(o + base + d);
        const float4 y = load4(dout + base + d);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0 && q0 + r < Tq) delta[(long long)bh * Tq + q0 + r] = sum;
  }

  load_transposed<D>(qt, q + q_off, q0, Tq);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int n_kv = (S + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q0 / kTile + 1);
  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();
    load_transposed<D>(kt, kb, k0, S);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(qt, kt, ty, tx, s);
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
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < Tq)
        lse[(long long)bh * Tq + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// ---- 2. dK and dV -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int H,
             int group, int Tq, int S, int causal, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* vt = kt + D * kLd;                      // [D][kLd]
  float* ra = vt + D * kLd;     // Q^T [D][kLd], then Q rows [64][D]
  float* rb = ra + D * kLd;     // dO^T [D][kLd], then dO rows [64][D]
  float* ps = rb + D * kLd;     // P as [query row][key row], [64][kLd]
  float* dss = ps + kTile * kLd;  // dS likewise

  const int bhk = blockIdx.x;
  const int h_kv = H / group;
  const int b = bhk / h_kv;
  const int hk = bhk % h_kv;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;  // query rows tx*4 .. of the score block
  const int ty = threadIdx.x / 16;  // key rows ty*4 .., output rows
  const long long kv_off = (long long)bhk * S * D;

  load_transposed<D>(kt, k + kv_off, k0, S);
  load_transposed<D>(vt, v + kv_off, k0, S);

  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int n_q = (Tq + kTile - 1) / kTile;
  const int q_first = causal ? k0 / kTile : 0;
  for (int hh = 0; hh < group; ++hh) {
    const long long bh = (long long)b * H + hk * group + hh;
    const float* qb = q + bh * Tq * D;
    const float* dob = dout + bh * Tq * D;
    const float* lse_b = lse + bh * Tq;
    const float* delta_b = delta + bh * Tq;
    for (int qi = q_first; qi < n_q; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();              // the last tile's rows are consumed
      load_transposed<D>(ra, qb, q0, Tq);
      load_transposed<D>(rb, dob, q0, Tq);
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      dot_tile<D>(kt, ra, ty, tx, st);    // S^T[key][query]
      dot_tile<D>(vt, rb, ty, tx, dpt);   // dP^T[key][query]
      float p[4][4], ds[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx * 4 + j;
        const bool live = row < Tq;
        const float lse_r = live ? lse_b[row] : 0.f;
        const float dl_r = live ? delta_b[row] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + ty * 4 + i;
          const bool ok = live && col < S && (!causal || row >= col);
          p[i][j] = ok ? expf(st[i][j] * scale - lse_r) : 0.f;
          ds[i][j] = p[i][j] * (dpt[i][j] - dl_r);
        }
      }
      __syncthreads();              // every thread is done with Q^T, dO^T
      store_transposed(ps, ty, tx, p);
      store_transposed(dss, ty, tx, ds);
      load_rows<D>(ra, qb, q0, Tq);
      load_rows<D>(rb, dob, q0, Tq);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(ps + r * kLd +
                                                          ty * 4);
        const float4 c = *reinterpret_cast<const float4*>(dss + r * kLd +
                                                          ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
        float qv[kCols], dov[kCols];
        row_cols<D>(ra, r, tx, qv);
        row_cols<D>(rb, r, tx, dov);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc_dv[i][j] = fmaf(av[i], dov[j], acc_dv[i][j]);
            acc_dk[i][j] = fmaf(cv[i], qv[j], acc_dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
    const long long base = kv_off + (long long)row * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store1(dk + base + out_col<D>(tx, j), acc_dk[i][j] * scale);
      store1(dv + base + out_col<D>(tx, j), acc_dv[i][j]);
    }
  }
}

// ---- 3. dQ ------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int H, int group, int Tq, int S, int causal,
           float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* dot = qt + D * kLd;                     // dO^T [D][kLd]
  float* kt = dot + D * kLd;    // K^T [D][kLd], then K rows [64][D]
  float* vt = kt + D * kLd;     // V^T [D][kLd]
  float* dst = vt + D * kLd;    // dS as [key row][query row], [64][kLd]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh % H) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16;  // key columns tx*4 .., output columns
  const int ty = threadIdx.x / 16;  // query rows ty*4 ..
  const long long q_off = (long long)bh * Tq * D;
  const long long kv_off = ((long long)b * (H / group) + hk) * S * D;

  load_transposed<D>(qt, q + q_off, q0, Tq);
  load_transposed<D>(dot, dout + q_off, q0, Tq);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Tq ? lse[(long long)bh * Tq + row] : 0.f;
    dl_r[i] = row < Tq ? delta[(long long)bh * Tq + row] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  int n_kv = (S + kTile - 1) / kTile;
  if (causal) n_kv = min(n_kv, q0 / kTile + 1);
  for (int kj = 0; kj < n_kv; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();                // the last tile's K rows are consumed
    load_transposed<D>(kt, k + kv_off, k0, S);
    load_transposed<D>(vt, v + kv_off, k0, S);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<D>(qt, kt, ty, tx, s);
    dot_tile<D>(dot, vt, ty, tx, dp);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = row < Tq && col < S && (!causal || row >= col);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[i][j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();                // every thread is done with K^T
    store_transposed(dst, ty, tx, ds);
    load_rows<D>(kt, k + kv_off, k0, S);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(dst + c * kLd +
                                                        ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float kv[kCols];
      row_cols<D>(kt, c, tx, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], kv[j],
                                                         acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store1(dq + q_off + (long long)row * D + out_col<D>(tx, j),
             acc[i][j] * scale);
  }
}

template <typename K>
void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, int B, int H, int H_kv, int Tq, int S,
           int causal, float* dq, float* dk, float* dv, float* lse,
           float* delta, cudaStream_t stream) {
  // 1/sqrt(D) rounded once, as the forward kernels' scale is.
  const float scale = (float)(1.0 / sqrt((double)D));
  const int group = H / H_kv;
  const int n_q = (Tq + kTile - 1) / kTile;
  const int n_k = (S + kTile - 1) / kTile;
  const size_t tile = sizeof(float) * D * kLd;
  const size_t rows = sizeof(float) * kTile * kLd;
  if (n_q > 0) {
    allow_smem(bwd_stats<D>, 2 * tile);
    bwd_stats<D><<<dim3(B * H, n_q), kThreads, 2 * tile, stream>>>(
        q, k, o, dout, lse, delta, H, group, Tq, S, causal, scale);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_k > 0) {
    allow_smem(bwd_dkdv<D>, 4 * tile + 2 * rows);
    bwd_dkdv<D><<<dim3(B * H_kv, n_k), kThreads, 4 * tile + 2 * rows,
                     stream>>>(q, k, v, dout, lse, delta, dk, dv, H, group,
                               Tq, S, causal, scale);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_q > 0) {
    allow_smem(bwd_dq<D>, 4 * tile + rows);
    bwd_dq<D><<<dim3(B * H, n_q), kThreads, 4 * tile + rows, stream>>>(
        q, k, v, dout, lse, delta, dq, H, group, Tq, S, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do float32[B, H, T, D], k, v float32[B, H_kv, S, D] -> dq [B, H,
// T, D], dk, dv [B, H_kv, S, D]; lse and delta are float32 [B, H, T]
// scratch.  The wrapper has checked D in {16, 32, 64, 128}, H % H_kv == 0,
// T = S when causal, B * H < 2^31, ceil(T / 64) and ceil(S / 64) < 65536,
// and 16-byte aligned operands.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, long long B, long long H,
                                   long long H_kv, long long T, long long S,
                                   long long D, long long causal, void* dq,
                                   void* dk, void* dv, void* lse,
                                   void* delta, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B * H == 0) return (int)cudaGetLastError();
  const int c = causal ? 1 : 0;
  float* ls = (float*)lse;
  float* dl = (float*)delta;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* of = (const float*)o;
  const float* df = (const float*)dout;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, df, B, H, H_kv, T, S, c, dqf,
                               dkf, dvf, ls, dl, stream);
    case 32:
      return launch<32>(qf, kf, vf, of, df, B, H, H_kv, T, S, c, dqf,
                               dkf, dvf, ls, dl, stream);
    case 64:
      return launch<64>(qf, kf, vf, of, df, B, H, H_kv, T, S, c, dqf,
                               dkf, dvf, ls, dl, stream);
    case 128:
      return launch<128>(qf, kf, vf, of, df, B, H, H_kv, T, S, c,
                                dqf, dkf, dvf, ls, dl, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
