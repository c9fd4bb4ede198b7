// flash_attention_bf16: blocked online-softmax attention, GQA, causal or not,
// on bf16 operands through Hopper's tensor cores (wgmma, TMA, sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention, body _kernel) for bf16 q [B, H, T, D] and k, v
// [B, H_kv, S, D]: query head h reads KV head h / (H / H_kv), and
//   o[t] = sum_s softmax_s(q[t].k[s] / sqrt(D)) v[s]
// with masked scores at -1e30, causal tiles above the diagonal skipped, the
// denominator clamped at 1e-30, (m, l, o) of each query row kept on chip
// across the KV loop, and the TPU kernel's roundings: Q.K^T of the bf16
// operands summed in float32 (each product is exact in float32), P rounded
// to bf16 before P.V (the Pallas kernel's p.astype(v.dtype)), the output
// rounded to bf16 (its out_shape is q.dtype).  Two instances of one
// template: D = 128, the head dim of every dense config, and D = 64,
// Whisper's; the D = 64 one has the same tiles, threads and roundings with
// one 64-column chunk a row (scale 1/sqrt(64)).  Given a statistic pointer
// (training asks for it), the
// epilogue also stores each query row's log-sum-exp in the log2 domain the
// kernel works in, lse2 = m + log2 l = log2 sum_s 2^(q.k scale log2 e), as
// float32 [B H, Tp] with Tp = T rounded up to 128: every row of every tile,
// so rows past T hold finite values too.  flash_attention_bwd_bf16.cu reads
// it as P = 2^(s scale log2 e - lse2).  Serving passes a null pointer and
// stores nothing more.
//
// What bounds it: operations.  The work is 4 * D * B * H * pairs, pairs the
// (t, s) the mask keeps (T (T + 1) / 2 when causal): 275 GFLOP at B = 2,
// H = 32, T = S = 4096, D = 128, 0.278 ms at the 989 TFLOP/s of bf16 wgmma,
// against 0.1 ms for the 335 MB of q, k, v and o at 3.35 TB/s.  Beside the
// products, the exponentials are 537 M ex2 there (B H pairs), ~0.13 ms on the
// SFU pipe if nothing overlaps them; here nothing does (see below).  At
// D = 64 the products halve and the exponentials do not: Whisper's encoder
// layer (B = 8, H = 20, T = S = 1500, non-causal) is 92 GFLOP, 0.093 ms of
// wgmma, beside 360 M ex2.
//
// Design: one block per (b * h, 128-row query tile), the heaviest (last)
// causal tiles first, 384 threads.  Warpgroup 2 is the producer: it gives up
// registers (setmaxnreg) and one thread issues every copy by TMA from 3-D
// tensor maps ([planes, rows, D], zero-filled past T and S): Q once, then
// K and V tiles of 128 rows into a 2-stage ring, each stage with its own
// full barriers for K and V (the score product starts before V lands) and
// an empty barrier the consumers release.  Warpgroups 0 and 1 are the
// consumers, 64 query rows each, with 232 registers: S = Q K^T is D / 16
// m64n128k16 wgmma from shared memory (both K-major, 128-byte swizzle), the
// online softmax runs on the float32 accumulator in registers (exp2 with
// scale * log2 e folded in, row max over the 4 lanes of a row by shuffles,
// row sums kept per thread and added across the lanes once at the end), and
// O += P V is 8 m64nDk16 wgmma whose A operand is P from registers (the
// accumulator's layout, converted pairwise to bf16, is the A fragment's)
// and whose B is V from shared memory with the transpose bit.  O, m and l
// stay in registers; the epilogue divides by max(l, 1e-30) and stores bf16
// rows below T.  No KV split and no atomics: a row's output depends on its
// own q and on k, v only, so runs are bitwise equal and independent of B.
// Shared memory: Q 32 KB + 2 x (K + V) 128 KB at D = 128, half that at
// D = 64; one block an SM either way (the registers allow no second).
// Not done here: ping-pong between the consumers and overlapping the
// softmax with the next product (the ex2 time above is exposed), fp8.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;          // query rows a block, KV rows a tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kChunkBytes = kRows * 128;   // 128 rows of one 64-column chunk

// Shared memory at head dim kD, in bytes from a 1024-byte aligned base: Q,
// then kStages K tiles, kStages V tiles, and the 1 + 3 kStages barriers.
template <int kD>
struct Smem {
  static constexpr int kChunks = kD / 64;
  static constexpr int kTile = kChunks * kChunkBytes;   // Q, K or V tile
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 64 + 1024;      // + base alignment
  static_assert(kD % 64 == 0, "whole 64-column chunks");
  static_assert(kBytes <= 232448, "over 227 KB of shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse2, int H, int group, int T, int S,
                   int causal, float scale_log2) {
  using L = Smem<kD>;
  constexpr int kChunks = L::kChunks, kTile = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  int n_kv = (S + kRows - 1) / kRows;
  if (causal) n_kv = min(n_kv, q0 / kRows + 1);   // none above the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, kTile);
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(smem + c * kChunkBytes, &tq, q_full, 64 * c, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        uint8_t* ks = smem + L::kK + s * kTile;
        uint8_t* vs = smem + L::kV + s * kTile;
        mbar_expect_tx(&k_full[s], kTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(ks + c * kChunkBytes, &tk, &k_full[s], 64 * c,
                      j * kRows, hkv);
        mbar_expect_tx(&v_full[s], kTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(vs + c * kChunkBytes, &tv, &v_full[s], 64 * c,
                      j * kRows, hkv);
      }
    }
  } else {
    // ---- consumers: rows wg * 64 .. wg * 64 + 63 of the query tile ----
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);   // + 8 j + e % 2 within a tile

    float acc[kD / 2];                 // O, accumulator layout of m64nD
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};   // rows row0 and row0 + 8
    float l[2] = {0.f, 0.f};           // this thread's part of the row sum

    const uint32_t q_addr = smem_u32(smem) + wg * 64 * 128;
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * kTile);
      const uint32_t v_addr = smem_u32(smem + L::kV + s * kTile);
      mbar_wait(&k_full[s], parity);

      // S = Q K^T: kD / 16 steps of k16, 4 per 64-column chunk (32 bytes).
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_m64n128k16_ss(sc, sw128_desc(q_addr + off, 16, 1024),
                            sw128_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Scale (into the log2 domain), mask, online softmax.
      const int k0 = j * kRows;
      const bool edge = k0 + kRows > S ||
                        (causal && k0 + kRows - 1 > q0 + wg * 64);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + (i / 4) * 8 + col0 + (i % 2);
          const int row = row0 + ((i % 4) / 2) * 8;
          if (col >= S || (causal && col > row)) x = kNegInf;
        }
        sc[i] = x;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      uint32_t p[32];                  // P as the A fragments of 8 k16 steps
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i % 4) / 2;
        const float p0 = ex2(sc[i] - mx[r]);
        const float p1 = ex2(sc[i + 1] - mx[r]);
        l[r] += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] *= corr[(i % 4) / 2];

      // O += P V: 8 steps of k16 over the tile's rows (16 rows, 2048 bytes),
      // m64n128k16 at D = 128, m64n64k16 at D = 64.
      mbar_wait(&v_full[s], parity);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_tb(acc, p + 4 * kk,
                    sw128_desc(v_addr + kk * 2048, kChunkBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* ob = o + (long long)bh * T * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float denom = fmaxf(sum, 1e-30f);
      const int row = row0 + 8 * r;
      if (lse2 && lane % 4 == 0)
        lse2[(long long)bh * gridDim.y * kRows + row] = m[r] + log2f(denom);
      if (row >= T) continue;
#pragma unroll
      for (int jn = 0; jn < kD / 8; ++jn) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            acc[4 * jn + 2 * r] / denom, acc[4 * jn + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * kD +
                                           8 * jn + col0) = v2;
      }
    }
  }
}

// Launches the instance of head dim kD; the arguments are the entry's.
template <int kD>
int launch(const void* q, const void* k, const void* v, long long B,
           long long H, long long H_kv, long long T, long long S,
           long long causal, void* o, void* lse2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = bf16_map_3d(&tq, q, B * H, T, kD, kRows);
  if (!err) err = bf16_map_3d(&tk, k, B * H_kv, S, kD, kRows);
  if (!err) err = bf16_map_3d(&tv, v, B * H_kv, S, kD, kRows);
  if (err) return err;
  // 1/sqrt(D) * log2(e) rounded once.
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)kD));
  cudaFuncSetAttribute(fa_bf16_kernel<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Smem<kD>::kBytes);
  const dim3 grid((unsigned)(B * H), (unsigned)((T + kRows - 1) / kRows));
  fa_bf16_kernel<kD><<<grid, kThreads, Smem<kD>::kBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse2, (int)H, (int)(H / H_kv),
      (int)T, (int)S, causal ? 1 : 0, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16[B, H, T, D], k/v bf16[B, H_kv, S, D] -> o bf16[B, H, T, D], and
// where lse2 is not null the rows' log-sum-exp, float32 [B H, Tp] (Tp = T
// rounded up to 128; 0 when S = 0), on card `device` (made current first:
// a thread with no current context cannot encode tensor maps, as autograd's
// worker thread, whose first CUDA work this may be).  The wrapper has
// checked D in {64, 128}, H % H_kv == 0, T = S when causal, 16-byte aligned
// pointers, B * H < 2^31 and ceil(T / 128) < 65536.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, long long B, long long H,
                                    long long H_kv, long long T, long long S,
                                    long long D, long long causal, void* o,
                                    void* lse2, long long device,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int dev_err = (int)cudaSetDevice((int)device);
  if (dev_err) return dev_err;
  if (B * H * T == 0) return (int)cudaGetLastError();
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (S == 0) {  // no keys: every row's weights are empty, o = 0
    const long long tp = (T + kRows - 1) / kRows * kRows;
    if (lse2) {
      const int e = (int)cudaMemsetAsync(lse2, 0, (size_t)(B * H * tp) * 4,
                                         stream);
      if (e) return e;
    }
    return (int)cudaMemsetAsync(o, 0, (size_t)(B * H * T * D) * 2, stream);
  }
  return D == 128 ? launch<128>(q, k, v, B, H, H_kv, T, S, causal, o, lse2,
                                stream)
                  : launch<64>(q, k, v, B, H, H_kv, T, S, causal, o, lse2,
                               stream);
}
