// flash_attention_bwd_bf16: the gradient of blocked online-softmax attention
// (GQA, causal or not) with respect to bf16 q, k and v, through Hopper's
// tensor cores (wgmma, TMA, sm_90a).
//
// Replaces no Pallas kernel: the reference has no attention backward and
// trains through its plain attention_ref, which XLA differentiates
// (repro/kernels/flash_attention/ref.py, attention_ref).  Its plain version
// is attention_bwd_ref (kernels/flash_attention/ref.py); the float32
// backward stays on the CUDA cores in flash_attention_bwd.cu.  For q
// [B, H, T, D], k and v [B, H_kv, S, D], o and do [B, H, T, D], query head h
// reading KV head h / (H / H_kv), scale = 1/sqrt(D):
//   P = softmax_s(q k^T scale)  (masked s > t when causal, T = S)
//   Delta[t] = sum_d do[t, d] o[t, d]
//   dV = P^T do,  dS = P * (do v^T - Delta),  dQ = dS k scale,
//   dK = dS^T q scale,
// dK and dV summed over the H / H_kv query heads of each KV head.  P comes
// from the forward's statistic (flash_attention_bf16.cu writes it): lse2[t]
// = log2 sum_s 2^(q[t].k[s] scale log2 e), the log-sum-exp in the log2
// domain that ex2 reads, so P = 2^(q.k scale log2 e - lse2) with no second
// pass over the keys.  lse2 and Delta are float32 [B H, Tp], Tp = T rounded
// up to 128 (the forward's query tile): the forward writes every row of its
// tiles, and rows past T hold finite values.  Roundings: every product of
// bf16 operands is summed in float32; P and dS are rounded to bf16 before
// they enter dV += P^T do and dK += dS^T q, dQ += dS k (the tensor cores
// take bf16 operands; the forward rounds P the same way); dQ, dK, dV are
// rounded to bf16 once, at the end.  Two instances of one template, D = 128
// (every dense config) and D = 64 (Whisper), with the same tiles, threads
// and roundings; at D = 64 a row is one 64-column chunk and the products
// with N = D are m64n64k16.
//
// What bounds it: operations.  The function needs 5 products of 2 D FLOP a
// kept score pair (10 D FLOP): 172 GFLOP at B = 4, H = 16, T = S = 2048,
// D = 128, causal, 0.174 ms at the 989 TFLOP/s of bf16 wgmma, against 67 MB
// of bf16 q, k, v, o, do, dq, dk, dv plus the float32 lse2 (0.02 ms at
// 3.35 TB/s).  This design computes 7 products (q k^T and do v^T in both
// passes), 0.243 ms at that rate.
//
// Design: three launches, no atomics, so a run is bitwise repeatable and
// independent of B.
//   1. Delta, per 256 / (D / 8) rows: bf16 o and do read once (16 bytes a
//      lane, D / 8 lanes a row), summed in float32; 0 past T.
//   2. dK dV, one block per (b h_kv, 128-row key tile), the key tiles that
//      the most query tiles see first, 384 threads.  Warpgroup 2 is the
//      producer (setmaxnreg down; one thread issues every copy): K and V
//      once by TMA, then for each query head of the group and each 64-row
//      query tile the causal mask reaches, Q and dO by TMA and their lse2
//      and Delta by bulk copy, into a 2-stage ring (full barriers for Q and
//      dO apart, an empty barrier the consumers release).  Warpgroups 0 and
//      1 are the consumers, 64 key rows each (setmaxnreg up): S^T = K Q^T
//      and dP^T = V dO^T are 8 m64n64k16 wgmma each from shared memory (both
//      operands K-major, 128-byte swizzle); P^T = ex2(S^T scale log2 e -
//      lse2), masked only on tiles the diagonal or a ragged edge crosses,
//      and dS^T = P^T (dP^T - Delta) are computed in the float32
//      accumulators and converted pairwise to bf16, which makes them the A
//      fragments of the next products as they stand; dV += P^T dO and
//      dK += dS^T Q are 4 m64nDk16 wgmma each with A from registers and
//      B the same staged dO and Q tiles read MN-major (transpose bit), so
//      one copy of each serves both of its products.  dK and dV stay in
//      float32 registers over the whole group and are scaled and rounded
//      once.
//   3. dQ, one block per (b h, 128-row query tile), heaviest causal tiles
//      first: Q and dO once, K and V 128-row tiles through the ring; S =
//      Q K^T and dP = dO V^T (m64n128k16 from shared memory), dS in
//      registers, dQ += dS K (m64nDk16, A from registers, B = K MN-major).
// A consumer warpgroup whose 64 key rows the causal mask hides from a whole
// query tile releases it without computing.  Shared memory at D = 128:
// 130 KB (pass 2), 193 KB (pass 3); about half that at D = 64; one block an
// SM.  Tried on the H100 at D = 128 and left out, none more than 2 %
// faster at lm_train's layer (tools/bwd_ablation.py): a
// 3- or 4-stage ring, ordering the two consumers' score products
// (ping-pong), a grid that keeps a head's tiles together, and issuing the
// next tile's scores before a tile's updates finish.  Not done here: P and dS through shared memory for larger
// products, dQ in the same pass (it would need float atomics, and runs
// would no longer be bitwise equal).
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kStages = 2;          // ring depth (3 or 4: < 2 % faster)
constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 x 128 x 240 + 128 x 24 <= 65,536
constexpr int kBig = 128;           // rows of the block's own tile
constexpr int kSmall = 64;          // rows of a streamed tile
constexpr int kBigChunk = kBig * 128;      // bytes of one chunk, 128 rows
constexpr int kSmallChunk = kSmall * 128;  // bytes of one chunk, 64 rows
constexpr int kStatBytes = kSmall * 4;             // 64 float32 a tile
constexpr int kDeltaThreads = 256;  // threads a block of the Delta pass

// Shared memory at head dim kD, in bytes from 1024-byte aligned bases.
template <int kD>
struct Smem {
  static constexpr int kChunks = kD / 64;   // 64-column (128-byte) chunks
  static constexpr int kBigTile = kChunks * kBigChunk;      // 32 KB at 128
  static constexpr int kSmallTile = kChunks * kSmallChunk;  // 16 KB at 128
  // dK dV: K, V, kStages x (Q, dO), kStages x (lse2, Delta), barriers.
  static constexpr int kKvV = kBigTile;
  static constexpr int kKvQ = 2 * kBigTile;
  static constexpr int kKvDo = kKvQ + kStages * kSmallTile;
  static constexpr int kKvLse = kKvDo + kStages * kSmallTile;
  static constexpr int kKvDelta = kKvLse + kStages * kStatBytes;
  static constexpr int kKvBars = kKvDelta + kStages * kStatBytes;
  static constexpr int kKvSmem = kKvBars + 8 * (1 + 3 * kStages) + 1024;
  // dQ: Q, dO, kStages x (K, V), barriers.
  static constexpr int kQDo = kBigTile;
  static constexpr int kQK = 2 * kBigTile;
  static constexpr int kQV = kQK + kStages * kBigTile;
  static constexpr int kQBars = kQV + kStages * kBigTile;
  static constexpr int kQSmem = kQBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kD % 64 == 0, "whole 64-column chunks");
  static_assert(kKvSmem <= 232448 && kQSmem <= 232448,
                "over 227 KB of shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Offset of the k16 step kk (of D / 16) in a K-major tile of `chunk`-byte
// chunks: 4 steps of 32 bytes in each 64-column chunk.
__device__ __forceinline__ uint32_t kstep(int kk, int chunk) {
  return (kk / 4) * chunk + (kk % 4) * 32;
}

// acc = 64 x N product over kD of two K-major tiles: A at `a` (chunks of
// a_chunk bytes), B, N rows, at `b` (chunks of N * 128 bytes).
template <int kD>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a,
                                       int a_chunk, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n64k16_ss(acc, sw128_desc(a + kstep(kk, a_chunk), 16, 1024),
                       sw128_desc(b + kstep(kk, kSmallChunk), 16, 1024),
                       kk > 0);
}

template <int kD>
__device__ __forceinline__ void scores(float (&acc)[64], uint32_t a,
                                       int a_chunk, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n128k16_ss(acc, sw128_desc(a + kstep(kk, a_chunk), 16, 1024),
                        sw128_desc(b + kstep(kk, kBigChunk), 16, 1024),
                        kk > 0);
}

// acc += A B for A [64 x R] bf16 fragments in registers (a, R / 4 words)
// and B [R x D] a staged R-row tile read MN-major; acc is m64nD (D / 2
// floats: m64n128k16 at D = 128, m64n64k16 at D = 64).
template <int R, int N>
__device__ __forceinline__ void update(float (&acc)[N], const uint32_t* a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs_tb(acc, a + 4 * kk, sw128_desc(b + kk * 2048, R * 128, 1024));
}

// Rows of accumulator element i of m64nN (see hopper.cuh) relative to the
// warpgroup's first row, and its column relative to the tile's first.
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x % 32;
  return (threadIdx.x % 128) / 32 * 16 + lane / 4 + ((i % 4) / 2) * 8;
}
__device__ __forceinline__ int acc_col(int i) {
  return (i / 4) * 8 + 2 * (threadIdx.x % 4) + (i % 2);
}

// Rows [rows0, rows0 + 64) of `acc` (m64nD, float32) times `mul` as
// bf16 into out [.., D], rows below n_rows.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[kD / 2],
                                           int rows0, int n_rows, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows0 + acc_row(2 * r);
    if (row >= n_rows) continue;
#pragma unroll
    for (int jn = 0; jn < kD / 8; ++jn) {
      const int i = 4 * jn + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * kD +
                                         acc_col(i)) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// ---- 1. Delta --------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta(const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              float* __restrict__ delta, long long planes, int T, int Tp) {
  // kD / 8 lanes a row (a power of two that divides the warp), 8 bf16 (16
  // bytes) a lane.
  constexpr int kLanes = kD / 8;
  constexpr int kRowsPerBlock = kDeltaThreads / kLanes;
  const long long r =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const bool live = r < planes * Tp;
  const long long plane = r / Tp;
  const int t = (int)(r % Tp);
  float sum = 0.f;
  if (live && t < T) {
    const long long at = (plane * T + t) * kD + (threadIdx.x % kLanes) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum = fmaf(__uint_as_float(av[i] << 16), __uint_as_float(bv[i] << 16),
                 sum);
      sum = fmaf(__uint_as_float(av[i] & 0xffff0000u),
                 __uint_as_float(bv[i] & 0xffff0000u), sum);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (live && threadIdx.x % kLanes == 0) delta[r] = sum;
}

// ---- 2. dK and dV ----------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int H, int group, int T, int Tp, int S, int causal,
             float scale, float scale_log2) {
  using L = Smem<kD>;
  constexpr int kChunks = L::kChunks;
  constexpr int kBigTile = L::kBigTile, kSmallTile = L::kSmallTile;
  constexpr int kKvV = L::kKvV, kKvQ = L::kKvQ, kKvDo = L::kKvDo;
  constexpr int kKvLse = L::kKvLse, kKvDelta = L::kKvDelta;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kKvBars);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + kStages;
  uint64_t* empty = do_full + kStages;

  const int bhk = blockIdx.x;
  const int b = bhk / (H / group);
  const int h0 = (bhk % (H / group)) * group;   // the group's first head
  const int k0 = blockIdx.y * kBig;             // heaviest tiles first
  const int n_q = (T + kSmall - 1) / kSmall;
  const int q_first = causal ? k0 / kSmall : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&do_full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kv_full, 2 * kBigTile);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_3d(smem + c * kBigChunk, &tk, kv_full, 64 * c, k0, bhk);
        tma_load_3d(smem + kKvV + c * kBigChunk, &tv, kv_full, 64 * c, k0,
                    bhk);
      }
      int it = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int bh = b * H + h0 + hh;
        for (int qi = q_first; qi < n_q; ++qi, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          const long long stat = (long long)bh * Tp + qi * kSmall;
          mbar_expect_tx(&q_full[s], kSmallTile + kStatBytes);
          for (int c = 0; c < kChunks; ++c)
            tma_load_3d(smem + kKvQ + s * kSmallTile + c * kSmallChunk, &tq,
                        &q_full[s], 64 * c, qi * kSmall, bh);
          bulk_load(smem + kKvLse + s * kStatBytes, lse2 + stat, kStatBytes,
                    &q_full[s]);
          mbar_expect_tx(&do_full[s], kSmallTile + kStatBytes);
          for (int c = 0; c < kChunks; ++c)
            tma_load_3d(smem + kKvDo + s * kSmallTile + c * kSmallChunk,
                        &tdo, &do_full[s], 64 * c, qi * kSmall, bh);
          bulk_load(smem + kKvDelta + s * kStatBytes, delta + stat,
                    kStatBytes, &do_full[s]);
        }
      }
    }
  } else {
    // ---- consumers: key rows kb .. kb + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int kb = k0 + wg * 64;
    float acc_dk[kD / 2], acc_dv[kD / 2];   // m64nD accumulators
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    const uint32_t k_addr = smem_u32(smem) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(smem + kKvV) + wg * 64 * 128;
    mbar_wait(kv_full, 0);

    int it = 0;
    for (int hh = 0; hh < group; ++hh) {
      for (int qi = q_first; qi < n_q; ++qi, ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int q0 = qi * kSmall;
        mbar_wait(&q_full[s], parity);
        // Every query row of the tile above every key row: all masked.
        if (causal && q0 + kSmall <= kb) {
          mbar_arrive(&empty[s]);
          continue;
        }
        const uint32_t q_addr = smem_u32(smem + kKvQ + s * kSmallTile);
        const uint32_t do_addr = smem_u32(smem + kKvDo + s * kSmallTile);
        const float* lse_s =
            reinterpret_cast<const float*>(smem + kKvLse + s * kStatBytes);
        const float* delta_s =
            reinterpret_cast<const float*>(smem + kKvDelta + s * kStatBytes);

        // S^T = K Q^T and dP^T = V dO^T, [64 keys x 64 queries].
        float st[32], dpt[32];
        mbar_wait(&do_full[s], parity);
        wgmma_fence();
        scores<kD>(st, k_addr, kBigChunk, q_addr);
        scores<kD>(dpt, v_addr, kBigChunk, do_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T; masked pairs (query before key, or past T or S)
        // are 0 on the tiles an edge crosses.
        const bool edge = (causal && q0 < kb + 64) || q0 + kSmall > T ||
                          kb + 64 > S;
        uint32_t pb[16], dsb[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = acc_col(i);
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
          float p0 = ex2(st[i] * scale_log2 - ls.x);
          float p1 = ex2(st[i + 1] * scale_log2 - ls.y);
          if (edge) {
            const int row = kb + acc_row(i);
            const int col = q0 + c;
            if ((causal && col < row) || col >= T || row >= S) p0 = 0.f;
            if ((causal && col + 1 < row) || col + 1 >= T || row >= S)
              p1 = 0.f;
          }
          pb[i / 2] = pack_bf16(p0, p1);
          dsb[i / 2] = pack_bf16(p0 * (dpt[i] - dl.x),
                                 p1 * (dpt[i + 1] - dl.y));
        }

        // dV += P^T dO, dK += dS^T Q (A from registers, B MN-major).
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        fence_regs(pb);
        fence_regs(dsb);
        wgmma_fence();
        update<kSmall>(acc_dv, pb, do_addr);
        update<kSmall>(acc_dk, dsb, q_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        mbar_arrive(&empty[s]);
      }
    }

    const long long base = (long long)bhk * S * kD;
    store_rows<kD>(dk + base, acc_dk, kb, S, scale);
    store_rows<kD>(dv + base, acc_dv, kb, S, 1.f);
  }
}

// ---- 3. dQ -----------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ lse2, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, int H, int group, int T, int Tp,
           int S, int causal, float scale, float scale_log2) {
  using L = Smem<kD>;
  constexpr int kChunks = L::kChunks, kBigTile = L::kBigTile;
  constexpr int kQDo = L::kQDo, kQK = L::kQK, kQV = L::kQV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kQBars);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBig;
  int n_kv = (S + kBig - 1) / kBig;
  if (causal) n_kv = min(n_kv, q0 / kBig + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      const int hkv = (bh / H) * (H / group) + (bh % H) / group;
      mbar_expect_tx(qdo_full, 2 * kBigTile);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_3d(smem + c * kBigChunk, &tq, qdo_full, 64 * c, q0, bh);
        tma_load_3d(smem + kQDo + c * kBigChunk, &tdo, qdo_full, 64 * c, q0,
                    bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&k_full[s], kBigTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(smem + kQK + s * kBigTile + c * kBigChunk, &tk,
                      &k_full[s], 64 * c, j * kBig, hkv);
        mbar_expect_tx(&v_full[s], kBigTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(smem + kQV + s * kBigTile + c * kBigChunk, &tv,
                      &v_full[s], 64 * c, j * kBig, hkv);
      }
    }
  } else {
    // ---- consumers: query rows qb .. qb + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int qb = q0 + wg * 64;
    float ls[2], dl[2];   // rows qb + acc_row(0) and that + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = (long long)bh * Tp + qb + acc_row(2 * r);
      ls[r] = lse2[at];
      dl[r] = delta[at];
    }
    float acc[kD / 2];    // dQ, m64nD
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(smem + kQDo) + wg * 64 * 128;
    mbar_wait(qdo_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kBig;
      const uint32_t k_addr = smem_u32(smem + kQK + s * kBigTile);
      const uint32_t v_addr = smem_u32(smem + kQV + s * kBigTile);

      // S = Q K^T and dP = dO V^T, [64 queries x 128 keys].
      float sc[64], dp[64];
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
      scores<kD>(sc, q_addr, kBigChunk, k_addr);
      scores<kD>(dp, do_addr, kBigChunk, v_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = (causal && k0 + kBig - 1 > qb) || k0 + kBig > S ||
                        qb + 64 > T;
      uint32_t dsb[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i % 4) / 2;
        float p0 = ex2(sc[i] * scale_log2 - ls[r]);
        float p1 = ex2(sc[i + 1] * scale_log2 - ls[r]);
        if (edge) {
          const int row = qb + acc_row(i);
          const int col = k0 + acc_col(i);
          if ((causal && col > row) || col >= S || row >= T) p0 = 0.f;
          if ((causal && col + 1 > row) || col + 1 >= S || row >= T)
            p1 = 0.f;
        }
        dsb[i / 2] = pack_bf16(p0 * (dp[i] - dl[r]),
                               p1 * (dp[i + 1] - dl[r]));
      }

      // dQ += dS K (B = K MN-major).
      fence_regs(acc);
      fence_regs(dsb);
      wgmma_fence();
      update<kBig>(acc, dsb, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    store_rows<kD>(dq + (long long)bh * T * kD, acc, qb, T, scale);
  }
}

// The three launches at head dim kD; the arguments are the entry's.
template <int kD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse2, long long B, long long H,
           long long H_kv, long long T, long long S, long long causal,
           void* dq, void* dk, void* dv, void* delta, cudaStream_t stream) {
  using L = Smem<kD>;
  const int tp = (int)((T + kBig - 1) / kBig * kBig);
  const int group = (int)(H / H_kv);
  CUtensorMap q64, do64, k128, v128, q128, do128;
  int err = bf16_map_3d(&q64, q, B * H, T, kD, kSmall);
  if (!err) err = bf16_map_3d(&do64, dout, B * H, T, kD, kSmall);
  if (!err) err = bf16_map_3d(&k128, k, B * H_kv, S, kD, kBig);
  if (!err) err = bf16_map_3d(&v128, v, B * H_kv, S, kD, kBig);
  if (!err) err = bf16_map_3d(&q128, q, B * H, T, kD, kBig);
  if (!err) err = bf16_map_3d(&do128, dout, B * H, T, kD, kBig);
  if (err) return err;
  // 1/sqrt(D), and 1/sqrt(D) * log2(e) as the forward rounds it.
  const float scale = (float)(1.0 / sqrt((double)kD));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)kD));
  const float* ls = (const float*)lse2;
  float* dl = (float*)delta;

  const long long rows = B * H * tp;
  const long long rows_a_block = kDeltaThreads / (kD / 8);
  bwd_delta<kD><<<(unsigned)((rows + rows_a_block - 1) / rows_a_block),
                  kDeltaThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, dl, B * H,
      (int)T, tp);
  err = (int)cudaGetLastError();
  if (err) return err;

  cudaFuncSetAttribute(bwd_dkdv<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L::kKvSmem);
  bwd_dkdv<kD><<<dim3((unsigned)(B * H_kv),
                      (unsigned)((S + kBig - 1) / kBig)),
                 kThreads, L::kKvSmem, stream>>>(
      q64, do64, k128, v128, ls, dl, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      (int)H, group, (int)T, tp, (int)S, causal ? 1 : 0, scale, scale_log2);
  err = (int)cudaGetLastError();
  if (err) return err;

  cudaFuncSetAttribute(bwd_dq<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L::kQSmem);
  bwd_dq<kD><<<dim3((unsigned)(B * H), (unsigned)(tp / kBig)), kThreads,
               L::kQSmem, stream>>>(
      q128, do128, k128, v128, ls, dl, (__nv_bfloat16*)dq, (int)H, group,
      (int)T, tp, (int)S, causal ? 1 : 0, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do bf16[B, H, T, D], k, v bf16[B, H_kv, S, D], lse2 float32[B H,
// Tp] (the forward's statistic, Tp = T rounded up to 128) -> dq bf16[B, H,
// T, D], dk, dv bf16[B, H_kv, S, D]; delta is float32 [B H, Tp] scratch.
// Card `device` is made current first (tensor maps need a current
// context; autograd's worker thread may have none yet).  The wrapper has
// checked D in {64, 128}, H % H_kv == 0, T = S when causal, 16-byte
// aligned operands, B * H < 2^31, and ceil(T / 128), ceil(S / 128) <
// 65536.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse2, long long B, long long H,
    long long H_kv, long long T, long long S, long long D, long long causal,
    void* dq, void* dk, void* dv, void* delta, long long device,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int dev_err = (int)cudaSetDevice((int)device);
  if (dev_err) return dev_err;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  // No queries: dk = dv = 0.  No keys: every weight is empty, dq = 0.
  if (T == 0) {
    const size_t bytes = (size_t)(B * H_kv * S * D) * 2;
    const int e = (int)cudaMemsetAsync(dk, 0, bytes, stream);
    return e ? e : (int)cudaMemsetAsync(dv, 0, bytes, stream);
  }
  if (S == 0)
    return (int)cudaMemsetAsync(dq, 0, (size_t)(B * H * T * D) * 2, stream);
  return D == 128
             ? launch<128>(q, k, v, o, dout, lse2, B, H, H_kv, T, S, causal,
                           dq, dk, dv, delta, stream)
             : launch<64>(q, k, v, o, dout, lse2, B, H, H_kv, T, S, causal,
                          dq, dk, dv, delta, stream);
}
