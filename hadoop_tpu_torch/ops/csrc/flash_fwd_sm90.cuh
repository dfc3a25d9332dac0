// The bf16 flash forward on Hopper's tensor cores (D 64 and 128): K/V tiles
// brought by TMA into a ring of shared-memory stages, Q K^T and P V by
// wgmma with the accumulators in registers, the online softmax on the
// accumulator fragment. Included by flash_fwd.cu, whose header gives the
// design and the bound; the PTX building blocks are in sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace flash_sm90 {

using namespace sm90;

constexpr int kConsumers = 2;               // consumer warpgroups, 64 rows each
constexpr int kBQ = 64 * kConsumers;        // query rows per block
constexpr int kBK = 128;                    // keys per K/V tile
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup first
constexpr int kProducerRegs = 40;           // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;          //   <= 65536 registers of the SM
constexpr float kLn2 = 0.6931471805599453f;

// The causal mask compares tile-relative rows and keys: q tile t and key
// tile t start at the same position.
static_assert(kBQ == kBK, "the diagonal is one key tile");

// Shared memory: the Q tile, then kStages K tiles and kStages V tiles,
// each a row of D / 64 boxes of (rows x 128 bytes), then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kQBox = kBQ * kRowBytes;
  static constexpr uint32_t kKVBox = kBK * kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kKVBytes = kBoxes * kKVBox;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr int kNumBars = 1 + 4 * kStages;
  // + 1024: the dynamic window is aligned up to the swizzle atom in-kernel
  static constexpr uint32_t kSmem = kBars + 8 * kNumBars + 1024;
  static_assert(D % kBoxCols == 0, "D is a whole number of boxes");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// One block per (query head, batch row, q tile of kBQ rows); the q tile is
// the grid's slowest axis, counted down, so the blocks with the longest
// causal loops are issued first and the last wave is short. Thread block:
// warpgroup 0 is the producer (one thread issues every TMA copy), warpgroups
// 1..kConsumers each own 64 query rows. O (CAUSAL) is bf16 [B, Sq, Hq, D]
// and lse [B, Hq, Sq]; O (partial) is float32 of the bf16-rounded value and
// lse [B, Sq, Hq]. scale_log2 is the softmax scale times log2(e).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      void* __restrict__ o, float* __restrict__ lse, int Sq,
                      int Skv, int Hq, int Hkv, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = full_q + 1;            // [kStages] each
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // causal: longest rows first
  const int n_kt = CAUSAL ? qt + 1 : Skv / kBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 128 * kConsumers);
      mbar_init(empty_v + s, 128 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: Q once, then K and V tile by tile into the ring
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      const int hk = h / (Hq / Hkv);
      mbar_expect_tx(full_q, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(smem + L::kQ + c * L::kQBox, &tq, full_q, c * kBoxCols,
                    h, qt * kBQ, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = (kt / kStages) & 1;
        mbar_wait(empty_k + s, phase ^ 1);     // round 0 passes at once
        mbar_expect_tx(full_k + s, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(smem + L::kK + s * L::kKVBytes + c * L::kKVBox, &tk,
                      full_k + s, c * kBoxCols, hk, kt * kBK, b);
        mbar_wait(empty_v + s, phase ^ 1);
        mbar_expect_tx(full_v + s, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(smem + L::kV + s * L::kKVBytes + c * L::kKVBox, &tv,
                      full_v + s, c * kBoxCols, hk, kt * kBK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int row0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;  // and row0 + 8
    const int col0 = 2 * (t % 4);
    constexpr int NO = D / 2;                 // O accumulator floats
    constexpr int NS = kBK / 2;               // S accumulator floats
    float acc_o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc_o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};          // running max, log2 units
    float l[2] = {0.f, 0.f};                  // this thread's share of the sum
    const uint32_t q_addr = smem_u32(smem + L::kQ) + wg * 64 * kRowBytes;

    mbar_wait(full_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const uint32_t phase = (kt / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kKVBytes);
      const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kKVBytes);

      // S = Q K^T: 64 x kBK, k16 steps along D (4 per 128-byte box row)
      float acc_s[NS];
      mbar_wait(full_k + s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(acc_s,
                      sw128_desc(q_addr + (kk / 4) * L::kQBox + off, 16, 1024),
                      sw128_desc(k_addr + (kk / 4) * L::kKVBox + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      mbar_arrive(empty_k + s);

      // online softmax on the fragment: a row's kBK scores lie on the 4
      // lanes t % 4 of one quad, so two xor shuffles reduce it
      const bool diag = CAUSAL && kt == qt;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        float x = acc_s[i] * scale_log2;
        if (diag && (i / 4) * 8 + col0 + (i & 1) > row0 + 8 * r) x = kNegInf;
        acc_s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // P = exp2(x - m), rounded to bf16 in registers: the accumulator's
      // element order is the A fragment's, 4 registers per k16 step
      float rs[2] = {0.f, 0.f};
      uint32_t p[NS / 2];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2f(acc_s[i] - m[r]);
        const float p1 = exp2f(acc_s[i + 1] - m[r]);
        rs[r] += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc_o[i] *= alpha[(i >> 1) & 1];

      // O += P V: V [key, d] as it lies, the MN-major B (transposed)
      mbar_wait(full_v + s, phase);
      fence_regs(acc_o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs_tb(acc_o, a,
                    sw128_desc(v_addr + kk * 16 * kRowBytes, L::kKVBox, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      mbar_arrive(empty_v + s);
    }

    // epilogue: the row sum over the quad, O / l, lse = m ln 2 + log l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lc = fmaxf(l[r], 1e-30f);
      const int qrow = qt * kBQ + row0 + 8 * r;
      const long base = (((long)b * Sq + qrow) * Hq + h) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x0 = __fdividef(acc_o[4 * j + 2 * r], lc);
        const float x1 = __fdividef(acc_o[4 * j + 2 * r + 1], lc);
        if constexpr (CAUSAL) {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) + base +
                                       8 * j) = pack_bf16(x0, x1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + base + 8 * j) =
              make_float2(__bfloat162float(__float2bfloat16(x0)),
                          __bfloat162float(__float2bfloat16(x1)));
        }
      }
      if (t % 4 == 0) {
        const float v = m[r] * kLn2 + logf(lc);
        if constexpr (CAUSAL)
          lse[((long)b * Hq + h) * Sq + qrow] = v;
        else
          lse[((long)b * Sq + qrow) * Hq + h] = v;
      }
    }
  }
}

// Returns 0, a CUDA error, or kErrTensorMap when the driver refuses a TMA
// descriptor. Sq and Skv multiples of kBQ = kBK = 128.
constexpr int kErrTensorMap = -2;

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!bshd_map(&tq, q, B, Sq, Hq, D, kBQ) ||
      !bshd_map(&tk, k, B, Skv, Hkv, D, kBK) ||
      !bshd_map(&tv, v, B, Skv, Hkv, D, kBK))
    return kErrTensorMap;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_sm90_kernel<D, CAUSAL>
      <<<dim3(Hq, B, Sq / kBQ), kThreads, L::kSmem, stream>>>(
          tq, tk, tv, o, static_cast<float*>(lse), Sq, Skv, Hq, Hkv,
          scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90
