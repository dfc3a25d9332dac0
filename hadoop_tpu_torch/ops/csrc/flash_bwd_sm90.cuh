// The bf16 flash backward on Hopper's tensor cores (D 64 and 128): the dQ
// kernel and the dK/dV kernel. Each block keeps its own 128 rows resident
// in shared memory and streams 64-row tiles of the other side by TMA
// through a ring of mbarrier-tracked stages; all five products are wgmma
// with float32 accumulators in registers, and P and dS go from the
// S (or S^T) accumulator into bf16 A fragments without touching shared
// memory. Included by flash_bwd.cu, whose header gives the design and the
// bound; the PTX building blocks are in sm90.cuh.
//
// No producer warp: a block is its two consumer warpgroups (256 threads),
// so ptxas may give a thread up to 255 registers (the dK/dV consumer holds
// some 200), where any third warp or warpgroup caps it at 168 whatever
// setmaxnreg asks. The first thread of the last warpgroup issues every
// copy, for the stage kStages - 1 iterations ahead, as it starts an
// iteration.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace flash_bwd_sm90 {

using namespace sm90;

constexpr int kConsumers = 2;               // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kConsumers;        // resident rows: q (dQ), keys (dK/dV)
constexpr int kBN = 64;                     // streamed rows: keys (dQ), q (dK/dV)
constexpr int kStages = 3;                  // ring depth
constexpr int kThreads = 128 * kConsumers;
constexpr int kLeader = 128 * (kConsumers - 1);   // the thread that copies

// Shared memory: the two resident tiles (kBM rows each: Q and dO for dQ,
// K and V for dK/dV), then kStages of each streamed tile (kBN rows: K and
// V for dQ, Q and dO for dK/dV), each a row of D / 64 boxes of (rows x
// 128 bytes); then float rows (dQ: delta of the block's kBM rows; dK/dV:
// lse and delta of each stage's kBN rows); then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kResBox = kBM * kRowBytes;
  static constexpr uint32_t kStrBox = kBN * kRowBytes;
  static constexpr uint32_t kResBytes = kBoxes * kResBox;
  static constexpr uint32_t kStrBytes = kBoxes * kStrBox;
  static constexpr uint32_t kRes0 = 0;                   // Q   | K
  static constexpr uint32_t kRes1 = kResBytes;           // dO  | V
  static constexpr uint32_t kStr0 = 2 * kResBytes;       // K   | Q   [kStages]
  static constexpr uint32_t kStr1 = kStr0 + kStages * kStrBytes;  // V | dO
  static constexpr uint32_t kRowFloats = 2 * kBN;        // lse, delta a stage
  static constexpr uint32_t kRows = kStr1 + kStages * kStrBytes;
  static constexpr uint32_t kBars = kRows + kStages * kRowFloats * 4;
  static constexpr int kNumBars = 1 + 2 * kStages;
  // + 1024: the dynamic window is aligned up to the swizzle atom in-kernel
  static constexpr uint32_t kSmem = kBars + 8 * kNumBars + 1024;
  static_assert(D % kBoxCols == 0, "D is a whole number of boxes");
  static_assert(kBM <= kStages * kRowFloats, "the dQ delta rows fit");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// The warpgroup index, taken from lane 0 so that the compiler sees it
// uniform across the warp (as CUTLASS's canonical_warp_group_idx)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// S = A B^T over D (64 x 64, k16 steps along D, 4 per 128-byte box row):
// A rows at a_addr in boxes a_box bytes apart, B rows at b_addr in boxes
// b_box bytes apart, both K-major
template <int D>
__device__ __forceinline__ void gemm_nt(float (&acc)[32], uint32_t a_addr,
                                        uint32_t a_box, uint32_t b_addr,
                                        uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, sw128_desc(a_addr + (kk / 4) * a_box + off, 16, 1024),
                 sw128_desc(b_addr + (kk / 4) * b_box + off, 16, 1024),
                 kk > 0);
  }
}

// acc[64 x D] += A[64 x kBN] B[kBN x D]: A the bf16 fragments a[kBN / 4]
// (4 per k16 step), B a streamed tile [kBN rows, D] as it lies: the
// MN-major operand, its next 64 columns one box (b_box bytes) on
template <int NA>
__device__ __forceinline__ void gemm_rs(float (&acc)[NA],
                                        const uint32_t (&a)[kBN / 4],
                                        uint32_t b_addr, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                              a[4 * kk + 3]};
    wgmma_rs_tb(acc, frag, sw128_desc(b_addr + kk * 16 * kRowBytes, b_box,
                                      1024));
  }
}

// Block prologue: the 1024-aligned window; mbarriers initialised by
// thread 0.
template <int D>
__device__ __forceinline__ uint8_t* setup(uint8_t* smem_raw) {
  using L = Layout<D>;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                          // the resident tiles
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 1 + s, 1);                // full
      mbar_init(bars + 1 + kStages + s, 128 * kConsumers);   // empty
    }
    mbar_init_fence();
  }
  __syncthreads();
  return smem;
}

// ----------------------------------------------------------------- dQ
//
// One block per (query head, batch row, q tile of kBM rows), the q tile
// the grid's slowest axis counted down (longest causal loops first).
// Q and dO of the block stay resident; the key tiles 0 .. 2 qt + 1 of
// kBN keys stream through the ring as (K, V) pairs. Warpgroup wg owns
// rows qt kBM + 64 wg .. + 63, whose last visible key tile (its diagonal,
// the only masked one) is 2 qt + wg. delta = rowsum(dO o O) is computed
// first, from device memory, and written for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int Hq,
                         int Hkv, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = setup<D>(smem_raw);
  uint64_t* full_res = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_res + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest rows first
  const int n_kt = 2 * qt + 2;                 // key tiles to the last row
  const int hk = h / (Hq / Hkv);
  const int wg = warpgroup();
  const int t = threadIdx.x % 128;

  // the key tile kt into its stage, once the stage's last reader left it
  auto load = [&](int kt) {
    const int s = kt % kStages;
    mbar_wait(empty + s, ((kt / kStages) & 1) ^ 1);   // round 0 passes
    mbar_expect_tx(full + s, 2 * L::kStrBytes);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(smem + L::kStr0 + s * L::kStrBytes + c * L::kStrBox, &tk,
                  full + s, c * kBoxCols, hk, kt * kBN, b);
      tma_load_4d(smem + L::kStr1 + s * L::kStrBytes + c * L::kStrBox, &tv,
                  full + s, c * kBoxCols, hk, kt * kBN, b);
    }
  };
  if (threadIdx.x == kLeader) {       // Q and dO, and the ring's first tiles
    tma_prefetch_desc(&tq);
    tma_prefetch_desc(&tk);
    tma_prefetch_desc(&tv);
    tma_prefetch_desc(&tdo);
    mbar_expect_tx(full_res, 2 * L::kResBytes);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(smem + L::kRes0 + c * L::kResBox, &tq, full_res,
                  c * kBoxCols, h, qt * kBM, b);
      tma_load_4d(smem + L::kRes1 + c * L::kResBox, &tdo, full_res,
                  c * kBoxCols, h, qt * kBM, b);
    }
    for (int kt = 0; kt < kStages - 1 && kt < n_kt; ++kt) load(kt);
  }

  float* delta_s = reinterpret_cast<float*>(smem + L::kRows);
  const long row_base = ((long)b * Hq + h) * S;          // lse / delta rows
  {
    // delta of the warpgroup's 64 rows: two threads a row, D / 2 columns
    // each, 16-byte loads of O and dO
    const int r = t / 2;
    const int qrow = qt * kBM + wg * 64 + r;
    const long off = (((long)b * S + qrow) * Hq + h) * D + (t % 2) * (D / 2);
    const uint4* po = reinterpret_cast<const uint4*>(o + off);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const uint4 a = po[i], c = pd[i];
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&av[e]));
        const float2 fc = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&cv[e]));
        part = fmaf(fa.x, fc.x, part);
        part = fmaf(fa.y, fc.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (t % 2 == 0) {
      delta[row_base + qrow] = part;
      delta_s[wg * 64 + r] = part;
    }
    named_barrier_sync(1 + wg, 128);
  }

  const int row0 = (t / 32) * 16 + (t % 32) / 4;   // and row0 + 8
  const int col0 = 2 * (t % 4);
  const int qpos0 = qt * kBM + wg * 64 + row0;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse[row_base + qpos0 + 8 * r] * kLog2e;
    dlt[r] = delta_s[wg * 64 + row0 + 8 * r];
  }
  float acc_dq[D / 2];
  zero(acc_dq);
  const uint32_t q_addr = smem_u32(smem + L::kRes0) + wg * 64 * kRowBytes;
  const uint32_t do_addr = smem_u32(smem + L::kRes1) + wg * 64 * kRowBytes;
  const int last = 2 * qt + wg;                    // the diagonal key tile

  mbar_wait(full_res, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (threadIdx.x == kLeader && kt + kStages - 1 < n_kt)
      load(kt + kStages - 1);
    __syncwarp();
    const int s = kt % kStages;
    mbar_wait(full + s, (kt / kStages) & 1);
    if (kt <= last) {                  // warpgroup 0 sees no key of tile 2qt+1
      const uint32_t k_addr = smem_u32(smem + L::kStr0 + s * L::kStrBytes);
      const uint32_t v_addr = smem_u32(smem + L::kStr1 + s * L::kStrBytes);
      // S = Q K^T and dP = dO V^T: 64 x kBN each
      float acc_s[32], acc_dp[32];
      wgmma_fence();
      gemm_nt<D>(acc_s, q_addr, L::kResBox, k_addr, L::kStrBox);
      wgmma_commit();
      gemm_nt<D>(acc_dp, do_addr, L::kResBox, v_addr, L::kStrBox);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc_s);
      // P = exp(S scale - lse), in place; masked on the diagonal by
      // absolute position (key > query)
      const bool diag = kt == last;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = fmaf(acc_s[i], scale_log2, -lse2[r]);
        if (diag && kt * kBN + (i / 4) * 8 + col0 + (i & 1) > qpos0 + 8 * r)
          x = kNegInf;
        acc_s[i] = exp2f(x);
      }
      wgmma_wait<0>();
      fence_regs(acc_dp);
      // dS scale = P o (dP - delta) scale, rounded to bf16 once: the A
      // fragment of dS K (the accumulator's element order)
      uint32_t ds[kBN / 4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        ds[i / 2] = pack_bf16(acc_s[i] * (acc_dp[i] - dlt[r]) * scale,
                              acc_s[i + 1] * (acc_dp[i + 1] - dlt[r]) * scale);
      }
      // dQ += dS K: K [key, d] as it lies, the MN-major B
      fence_regs(acc_dq);
      wgmma_fence();
      gemm_rs(acc_dq, ds, k_addr, L::kStrBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
    }
    mbar_arrive(empty + s);
  }

  // epilogue: dQ rounded to bf16 once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long base = (((long)b * S + qpos0 + 8 * r) * Hq + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + base + 8 * j) =
          pack_bf16(acc_dq[4 * j + 2 * r], acc_dq[4 * j + 2 * r + 1]);
  }
}

// -------------------------------------------------------------- dK/dV
//
// One block per (KV head, batch row, key tile of kBM keys), key tile 0
// (the most work) issued first. K and V of the block stay resident; the
// ring streams, for every query head of the KV head's group in turn, the
// q tiles of kBN rows from 2 kt (the first that sees a key of the block)
// to the end as (Q, dO) pairs, with each tile's lse and delta rows.
// Warpgroup wg owns keys kt kBM + 64 wg .. + 63; its first visible q tile
// (its diagonal, the only masked one) is 2 kt + wg. The whole group's dK
// and dV sum in the float32 accumulators and are rounded once.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, int Hq,
                          int Hkv, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = setup<D>(smem_raw);
  uint64_t* full_res = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_res + 1;
  uint64_t* empty = full + kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;                   // tile 0 has the most work
  const int n_rep = Hq / Hkv;
  const int first = 2 * kt;                    // first q tile seen
  const int n_qt = S / kBN - first;            // q tiles per query head
  const int n_it = n_rep * n_qt;
  const int wg = warpgroup();
  const int t = threadIdx.x % 128;

  // iteration it's (Q, dO, lse, delta) into its stage, once the stage's
  // last reader left it
  auto load = [&](int it) {
    const int s = it % kStages;
    const int h = hk * n_rep + it / n_qt;
    const int j = first + it % n_qt;
    const long rows = ((long)b * Hq + h) * S + (long)j * kBN;
    float* rows_s =
        reinterpret_cast<float*>(smem + L::kRows) + s * L::kRowFloats;
    mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);   // round 0 passes
    mbar_expect_tx(full + s, 2 * L::kStrBytes + 2 * kBN * 4);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(smem + L::kStr0 + s * L::kStrBytes + c * L::kStrBox, &tq,
                  full + s, c * kBoxCols, h, j * kBN, b);
      tma_load_4d(smem + L::kStr1 + s * L::kStrBytes + c * L::kStrBox, &tdo,
                  full + s, c * kBoxCols, h, j * kBN, b);
    }
    bulk_load(rows_s, lse + rows, kBN * 4, full + s);
    bulk_load(rows_s + kBN, delta + rows, kBN * 4, full + s);
  };
  if (threadIdx.x == kLeader) {       // K and V, and the ring's first tiles
    tma_prefetch_desc(&tq);
    tma_prefetch_desc(&tk);
    tma_prefetch_desc(&tv);
    tma_prefetch_desc(&tdo);
    mbar_expect_tx(full_res, 2 * L::kResBytes);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(smem + L::kRes0 + c * L::kResBox, &tk, full_res,
                  c * kBoxCols, hk, kt * kBM, b);
      tma_load_4d(smem + L::kRes1 + c * L::kResBox, &tv, full_res,
                  c * kBoxCols, hk, kt * kBM, b);
    }
    for (int it = 0; it < kStages - 1 && it < n_it; ++it) load(it);
  }

  const int row0 = (t / 32) * 16 + (t % 32) / 4;   // and row0 + 8
  const int col0 = 2 * (t % 4);
  const int kpos0 = kt * kBM + wg * 64 + row0;
  const float scale_log2 = scale * kLog2e;
  float acc_dk[D / 2], acc_dv[D / 2];
  zero(acc_dk);
  zero(acc_dv);
  const uint32_t k_addr = smem_u32(smem + L::kRes0) + wg * 64 * kRowBytes;
  const uint32_t v_addr = smem_u32(smem + L::kRes1) + wg * 64 * kRowBytes;

  mbar_wait(full_res, 0);
  for (int it = 0; it < n_it; ++it) {
    if (threadIdx.x == kLeader && it + kStages - 1 < n_it)
      load(it + kStages - 1);
    __syncwarp();
    const int s = it % kStages;
    const int j = first + it % n_qt;
    mbar_wait(full + s, (it / kStages) & 1);
    if (j >= first + wg) {             // warpgroup 1 sees no row of tile 2kt
      const uint32_t q_addr = smem_u32(smem + L::kStr0 + s * L::kStrBytes);
      const uint32_t do_addr = smem_u32(smem + L::kStr1 + s * L::kStrBytes);
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::kRows) + s * L::kRowFloats;
      const float* dlt_s = lse_s + kBN;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x kBN query rows each
      float acc_s[32], acc_dp[32];
      wgmma_fence();
      gemm_nt<D>(acc_s, k_addr, L::kResBox, q_addr, L::kStrBox);
      wgmma_commit();
      gemm_nt<D>(acc_dp, v_addr, L::kResBox, do_addr, L::kStrBox);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc_s);
      // P^T = exp(S^T scale - lse[q]), in place; a thread's columns are
      // query rows 8 i + col0 + {0, 1}; masked on the diagonal by absolute
      // position (key > query)
      const bool diag = j == first + wg;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const int c = (i / 4) * 8 + col0;
        const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
        float x0 = fmaf(acc_s[i], scale_log2, -l.x * kLog2e);
        float x1 = fmaf(acc_s[i + 1], scale_log2, -l.y * kLog2e);
        if (diag) {
          const int qpos = j * kBN + c;
          if (kpos0 + 8 * r > qpos) x0 = kNegInf;
          if (kpos0 + 8 * r > qpos + 1) x1 = kNegInf;
        }
        acc_s[i] = exp2f(x0);
        acc_s[i + 1] = exp2f(x1);
      }
      wgmma_wait<0>();
      fence_regs(acc_dp);
      // P^T rounded to bf16, and dS^T scale = P^T o (dP^T - delta[q])
      // scale rounded to bf16 once: the A fragments of P^T dO and dS^T Q
      uint32_t pt[kBN / 4], dst[kBN / 4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = (i / 4) * 8 + col0;
        const float2 d = *reinterpret_cast<const float2*>(dlt_s + c);
        pt[i / 2] = pack_bf16(acc_s[i], acc_s[i + 1]);
        dst[i / 2] = pack_bf16(acc_s[i] * (acc_dp[i] - d.x) * scale,
                               acc_s[i + 1] * (acc_dp[i + 1] - d.y) * scale);
      }
      // dV += P^T dO and dK += dS^T Q: dO and Q [q, d] as they lie, the
      // MN-major B
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
      gemm_rs(acc_dv, pt, do_addr, L::kStrBox);
      gemm_rs(acc_dk, dst, q_addr, L::kStrBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    mbar_arrive(empty + s);
  }

  // epilogue: dK and dV rounded to bf16 once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long base = (((long)b * S + kpos0 + 8 * r) * Hkv + hk) * D + col0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(dk + base + 8 * jj) =
          pack_bf16(acc_dk[4 * jj + 2 * r], acc_dk[4 * jj + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * jj) =
          pack_bf16(acc_dv[4 * jj + 2 * r], acc_dv[4 * jj + 2 * r + 1]);
    }
  }
}

// Both return 0, a CUDA error, or kErrTensorMap when the driver refuses a
// TMA descriptor. S a multiple of kBM = 128.
constexpr int kErrTensorMap = -2;

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, void* delta, int B,
              int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!bshd_map(&tq, q, B, S, Hq, D, kBM) ||
      !bshd_map(&tdo, dout, B, S, Hq, D, kBM) ||
      !bshd_map(&tk, k, B, S, Hkv, D, kBN) ||
      !bshd_map(&tv, v, B, S, Hkv, D, kBN))
    return kErrTensorMap;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_sm90_dq_kernel<D><<<dim3(Hq, B, S / kBM), kThreads, L::kSmem,
                                stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* lse,
               const void* delta, const void* dout, void* dk, void* dv,
               int B, int S, int Hq, int Hkv, float scale,
               cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!bshd_map(&tq, q, B, S, Hq, D, kBN) ||
      !bshd_map(&tdo, dout, B, S, Hq, D, kBN) ||
      !bshd_map(&tk, k, B, S, Hkv, D, kBM) ||
      !bshd_map(&tv, v, B, S, Hkv, D, kBM))
    return kErrTensorMap;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_sm90_dkv_kernel<D><<<dim3(Hkv, B, S / kBM), kThreads, L::kSmem,
                                 stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_sm90
