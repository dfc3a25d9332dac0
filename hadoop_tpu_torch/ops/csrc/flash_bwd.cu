// Causal flash-attention backward for Hopper (sm_90a), plain C entry points.
//
// Replaces the two Pallas TPU kernels of hadoop_tpu/ops/flash.py's `_bwd`:
//   - `_bwd_dq_kernel`:  dQ = sum over visible K/V tiles of (P o (dP - delta)) K scale
//   - `_bwd_dkv_kernel`: dV = sum of P^T dO, dK = sum of (P o (dP - delta))^T Q scale
//     over the visible q tiles, then (in the reference, outside the kernel)
//     summed over each KV head's group of query heads.
// P = exp(Q K^T scale - lse) is recomputed from the forward's log-sum-exp, and
// delta = rowsum(dO o O) (a jnp op beside the TPU kernels) is computed by the
// dQ kernel's prologue, which writes it for the dK/dV kernel launched next.
//
// Numerics as in the reference: S = Q K^T scale, P and dS = P o (dP - delta)
// in float32; P rounded to the input dtype before P^T dO; dS scale rounded to
// the input dtype before dS^T Q and dS K; float32 accumulators; dQ, dK, dV
// written once in the input dtype. One difference by design: the dK/dV block
// sums its KV head's whole query-head group in its float32 accumulators and
// rounds once, where the reference rounds each query head's dK/dV to the
// input dtype before the group sum (the same for float32 inputs).
//
// Layout: q, o, dO, dQ [B, S, Hq, D]; k, v, dK, dV [B, S, Hkv, D], all
// contiguous (the model's own layout); lse and delta [B, Hq, S] float32.
//
// Which kernels take which call (static; no fallback between them):
//   bf16,    D 64 or 128  -> the wgmma kernels (flash_bwd_sm90.cuh)
//   float32, any D; bf16, D 192 or 256 -> the FMA kernels below
// The float32 path stays in full float32 (TF32 wgmma would not), so it
// remains the exactness oracle of the float32 checks.
//
// The split of work is the reference's, in both routes. The TPU carries
// the accumulators across an "arbitrary" grid axis; here each block owns
// its output tile and loops over the other side itself:
//   - dQ: one block per (query head, batch row, q tile). Q and dO stay in
//     shared memory; K/V tiles 0..diagonal stream through; only the
//     diagonal is masked. Blocks are issued longest loop first. Its
//     prologue computes delta, which the dK/dV kernel reads.
//   - dK/dV: one block per (KV head, batch row, k tile). K and V stay in
//     shared memory; the block loops over the n_rep query heads of its
//     group and, for each, over the q tiles from the diagonal to the end.
//     So the group sum happens in the block: no [B, Hq, S, D]
//     intermediate, and no two blocks write the same dK row, hence no
//     atomics and the same bits on every call. k tile 0, which has the
//     most q tiles, is issued first.
//
// Design of the wgmma kernels (bf16, D 64/128). 256 threads per block:
// two warpgroups, 64 resident rows each (of a 128-row tile), and no
// producer warp. The first thread of the second warpgroup issues every
// copy: as it starts an iteration, the tile kStages - 1 iterations ahead.
//   - TMA brings the resident tiles once (dQ: Q and dO; dK/dV: K and V,
//     128 rows) and the streamed tiles of 64 rows (dQ: K and V; dK/dV: Q
//     and dO, with their lse and delta rows by a 1-D bulk copy) into a
//     ring of 3 stages tracked by full/empty mbarrier pairs. Tiles stay
//     bf16, 128-byte swizzled; at D 128 a row is two 64-column boxes.
//     64 KB resident + 3 x 32 KB streamed + the rows = 163 KB at D 128.
//   - Products, each wgmma with f32 accumulators in registers: S = Q K^T
//     and dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV) at
//     m64n64 with both operands K-major from shared memory; dQ += dS K,
//     dV += P^T dO and dK += dS^T Q at m64nD with A from registers and B,
//     a streamed tile as it lies, MN-major (the transpose flag).
//   - P = exp2(S scale log2(e) - lse log2(e)) and dS = P o (dP - delta)
//     run on the accumulator fragment. Its element order is the bf16 A
//     fragment's, so P (rounded to bf16) and dS scale (rounded once) go
//     from registers into the next wgmma: neither touches shared memory.
//   - The causal mask compares absolute positions: a 128-row tile meets
//     two partly visible 64-row tiles, one per consumer warpgroup; the
//     warpgroup whose rows see none of a tile only releases its stage.
//   - Registers: the dK/dV consumer holds dK and dV (64 + 64 floats a
//     thread at D 128) and S^T and dP^T (32 + 32). ptxas caps a block of
//     288 or 384 threads at 168 registers a thread, whatever setmaxnreg
//     asks, and the dK/dV kernel then spills and serializes its wgmmas;
//     a block of 256 threads may take up to 255 (248 at D 128), hence
//     no producer warp.
//   Not yet: overlap of one tile's elementwise work with the next tile's
//   products inside a warpgroup, persistent blocks.
//
// The FMA kernels (float32; bf16 at D 192/256): 256 threads per block;
// tiles of BT rows (64, or 32 at D 256 so the four staged tiles fit the
// 227 KB of shared memory), staged as float32 with rows padded by one
// float, so the column walks of Q K^T and dO V^T hit 16 distinct banks.
// Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of each
// product, so a row's 16 owners are one half warp (delta reduces with
// four xor shuffles). One BT x BT tile holds P, then dS, in turn (a
// second would not fit at D 192); the accumulators (2 x BT x D / 256
// floats a thread for dK/dV) live in registers. Products are plain
// float32 FMA.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// flagship training shape (B 4, S 2048, Hq 16, Hkv 8, D 128, bf16) dK/dV does
// 8 D FLOPs and dQ 6 D FLOPs per visible (q, k) pair and query head, about
// 138 and 103 GFLOP against some 135 and 170 MB moved (0.04 and 0.05 ms), so
// both are bound by the tensor-core rate (about 0.14 and 0.10 ms). What
// stands between the wgmma kernels and that bound is the elementwise work
// between a warpgroup's products (exp2, dS, two bf16 packs) that only the
// other warpgroup's products overlap, and the per-block prologue; float32
// has no tensor-core path here: its bound is the 67 TFLOP/s of the FMA
// units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even, as torch's cast
}

// float32 value of x after a round trip through T (the reference's casts)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D> __host__ __device__ constexpr int tile_rows() {
  return D > 192 ? 32 : 64;
}

// four staged BT x (D + 1) tiles, one BT x (BT + 1) P/dS tile, lse and delta
template <int D>
constexpr size_t smem_bytes() {
  constexpr int BT = tile_rows<D>();
  return sizeof(float) * (4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT);
}

// rows [0, BT) of a [*, stride] matrix of T into a padded float32 tile
template <typename T, int D, int BT>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride) {
  for (int idx = threadIdx.x; idx < BT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = to_f(src[r * stride + c]);
  }
}

// s = Q K^T and dp = dO V^T on this thread's NI x NI sub-tile: query rows
// ty + 16 i of Qs/dOs against key rows tx + 16 j of Ks/Vs.
template <int D, int NI>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[NI][NI],
                                       float (&dp)[NI][NI]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float aq[NI], ado[NI], bk[NI], bv[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      aq[i] = Qs[(ty + 16 * i) * DP + d];
      ado[i] = dOs[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      bk[j] = Ks[(tx + 16 * j) * DP + d];
      bv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ado[i], bv[j], dp[i][j]);
      }
  }
}

// acc[i][j] += sum over c < BT of A[c][ty + 16 i] * B[c][tx + 16 j]
// (A^T B for the dK/dV tiles) or, with kRowA, A[ty + 16 i][c] (A B for dQ).
template <int D, int BT, int NI, int NJ, bool kRowA>
__device__ __forceinline__ void accumulate(const float* A, const float* Bm,
                                           int ty, int tx,
                                           float (&acc)[NI][NJ]) {
  constexpr int DP = D + 1, PP = BT + 1;
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = kRowA ? A[(ty + 16 * i) * PP + c] : A[c * PP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Bm[c * DP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ delta, int S,
                    int Hq, int Hkv, float scale) {
  constexpr int BT = tile_rows<D>();
  constexpr int NI = BT / 16;    // rows (and key columns) per thread
  constexpr int NJ = D / 16;     // head-dim columns per thread
  constexpr int DP = D + 1, PP = BT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * DP;
  float* Ks = dOs + BT * DP;
  float* Vs = Ks + BT * DP;
  float* dSs = Vs + BT * DP;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest loops first
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const long q_stride = (long)Hq * D;          // between sequence rows
  const long kv_stride = (long)Hkv * D;
  const long q_off = ((long)b * S + (long)qt * BT) * q_stride + (long)h * D;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * D;
  const long row0 = ((long)b * Hq + h) * S + (long)qt * BT;  // lse / delta

  stage<T, D, BT>(Qs, q + q_off, q_stride);
  stage<T, D, BT>(dOs, dout + q_off, q_stride);
  __syncthreads();

  // delta = rowsum(dO o O) for this block's rows, written for the dK/dV
  // kernel; each row's 16 owners are one half warp
  float lse_r[NI], delta_r[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    const T* orow = o + q_off + r * q_stride;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      part = fmaf(dOs[r * DP + tx + 16 * j], to_f(orow[tx + 16 * j]), part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    delta_r[i] = part;
    lse_r[i] = lse[row0 + r];
    if (tx == 0) delta[row0 + r] = part;
  }

  float acc[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();             // previous K/V and dS consumed
    stage<T, D, BT>(Ks, kb + (long)kt * BT * kv_stride, kv_stride);
    stage<T, D, BT>(Vs, vb + (long)kt * BT * kv_stride, kv_stride);
    __syncthreads();

    float s[NI][NI], dp[NI][NI];
    scores<D, NI>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qpos = qt * BT + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int kpos = kt * BT + tx + 16 * j;
        const float x = kpos > qpos ? kNegInf : s[i][j] * scale;
        const float p = expf(x - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]);
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(ds * scale);
      }
    }
    __syncthreads();
    accumulate<D, BT, NI, NJ, true>(dSs, Ks, ty, tx, acc);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    T* row = dq + q_off + (ty + 16 * i) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const T* __restrict__ dout, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Hq, int Hkv, float scale) {
  constexpr int BT = tile_rows<D>();
  constexpr int NI = BT / 16;
  constexpr int NJ = D / 16;
  constexpr int DP = D + 1, PP = BT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * DP;
  float* Qs = Vs + BT * DP;
  float* dOs = Qs + BT * DP;
  float* Ps = dOs + BT * DP;     // P, then dS scale
  float* lse_s = Ps + BT * PP;
  float* delta_s = lse_s + BT;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;     // k tile 0 has the most q tiles: first
  const int n_rep = Hq / Hkv;
  const int nq = S / BT;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * S + (long)kt * BT) * kv_stride + (long)hk * D;

  stage<T, D, BT>(Ks, k + kv_off, kv_stride);
  stage<T, D, BT>(Vs, v + kv_off, kv_stride);

  float dk_acc[NI][NJ], dv_acc[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    for (int qt = kt; qt < nq; ++qt) {
      const long q_off = ((long)b * S + (long)qt * BT) * q_stride + (long)h * D;
      const long row0 = ((long)b * Hq + h) * S + (long)qt * BT;
      __syncthreads();           // previous Q/dO and P/dS consumed
      stage<T, D, BT>(Qs, q + q_off, q_stride);
      stage<T, D, BT>(dOs, dout + q_off, q_stride);
      for (int idx = threadIdx.x; idx < BT; idx += kThreads) {
        lse_s[idx] = lse[row0 + idx];
        delta_s[idx] = delta[row0 + idx];
      }
      __syncthreads();

      // thread rows: queries ty + 16 i; columns: keys tx + 16 j
      float s[NI][NI], dp[NI][NI];
      scores<D, NI>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int qr = ty + 16 * i;
        const int qpos = qt * BT + qr;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int kpos = kt * BT + tx + 16 * j;
          const float x = kpos > qpos ? kNegInf : s[i][j] * scale;
          const float p = expf(x - lse_s[qr]);
          Ps[qr * PP + tx + 16 * j] = round_to<T>(p);
          dp[i][j] = p * (dp[i][j] - delta_s[qr]);      // dS
        }
      }
      __syncthreads();
      // thread rows now: keys ty + 16 i; columns: head dim tx + 16 j
      accumulate<D, BT, NI, NJ, false>(Ps, dOs, ty, tx, dv_acc);  // P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          Ps[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(dp[i][j] * scale);
      __syncthreads();
      accumulate<D, BT, NI, NJ, false>(Ps, Qs, ty, tx, dk_acc);   // dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const long off = kv_off + (ty + 16 * i) * kv_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, void* delta, int B,
              int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const int err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != 0) return err;
  const dim3 grid(Hq, B, S / tile_rows<D>());
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* lse,
               const void* delta, const void* dout, void* dk, void* dv, int B,
               int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const int err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != 0) return err;
  const dim3 grid(Hkv, B, S / tile_rows<D>());
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

// Calls the launcher named LAUNCH of the kernel that takes the runtime
// dtype and head dim: flash_bwd_sm90::LAUNCH<D> for bf16 at D 64/128, else
// LAUNCH<T, D>.
#define HTPU_DISPATCH(LAUNCH, ...)                                           \
  do {                                                                       \
    if (dtype == 0) {                                                        \
      switch (D) {                                                           \
        case 64: return LAUNCH<float, 64>(__VA_ARGS__);                      \
        case 128: return LAUNCH<float, 128>(__VA_ARGS__);                    \
        case 192: return LAUNCH<float, 192>(__VA_ARGS__);                    \
        case 256: return LAUNCH<float, 256>(__VA_ARGS__);                    \
      }                                                                      \
    } else if (dtype == 1) {                                                 \
      switch (D) {                                                           \
        case 64: return flash_bwd_sm90::LAUNCH<64>(__VA_ARGS__);             \
        case 128: return flash_bwd_sm90::LAUNCH<128>(__VA_ARGS__);           \
        case 192: return LAUNCH<__nv_bfloat16, 192>(__VA_ARGS__);            \
        case 256: return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);            \
      }                                                                      \
    }                                                                        \
    return -1;                                                               \
  } while (0)

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 on success), -1 for a head dim or dtype they were not built for, or
// -2 when the driver refuses a TMA descriptor (bf16 at D 64/128).
// dtype: 0 float32, 1 bfloat16. S must be a multiple of 128 (of 64 for the
// FMA kernels) and Hq of Hkv.

// dQ, and delta = rowsum(dO o O) [B, Hq, S] float32 for the dK/dV kernel.
int htpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      void* dq, void* delta, int B, int S, int Hq, int Hkv,
                      int D, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HTPU_DISPATCH(launch_dq, q, k, v, o, lse, dout, dq, delta, B, S, Hq, Hkv,
                scale, st);
}

// dK and dV, each KV head summed over its query-head group; reads the
// delta that htpu_flash_bwd_dq wrote (launch it first on the same stream).
int htpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* lse, const void* delta, const void* dout,
                       void* dk, void* dv, int B, int S, int Hq, int Hkv,
                       int D, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HTPU_DISPATCH(launch_dkv, q, k, v, lse, delta, dout, dk, dv, B, S, Hq, Hkv,
                scale, st);
}

// Dynamic shared memory per block, in bytes, of the kernels that take
// (D, dtype) (the dQ and dK/dV kernels of a route share one layout); -1
// for a head dim or dtype no kernel was built for.
int htpu_flash_bwd_smem(int D, int dtype) {
  if (dtype == 1 && D == 64) return (int)flash_bwd_sm90::Layout<64>::kSmem;
  if (dtype == 1 && D == 128) return (int)flash_bwd_sm90::Layout<128>::kSmem;
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 64:  return (int)smem_bytes<64>();
    case 128: return (int)smem_bytes<128>();
    case 192: return (int)smem_bytes<192>();
    case 256: return (int)smem_bytes<256>();
    default:  return -1;
  }
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
