// Flash-attention forward for Hopper (sm_90a), plain C entry points:
// the causal forward and the fully visible (non-causal) ring partial.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (hadoop_tpu/ops/flash.py),
// in both of its uses: launched by `_fwd` with causal=True (the model's
// attention, and ring attention's diagonal chunk), and with causal=False
// through `flash_attention_partial` (ring attention's other chunks, Sq and
// Skv free). Online-softmax attention with grouped-query heads (query head
// h reads KV head h / (Hq / Hkv)), scores and softmax statistics in
// float32, P rounded to the input dtype before P.V, O rounded to the input
// dtype and the per-row log-sum-exp in float32.
//
// Layout: q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], all contiguous (the
// model's own layout, so no transpose is needed). The causal entry (Sq ==
// Skv) writes o like q and lse [B, Hq, Sq]; the partial writes what ring
// attention's merge reads: o float32 [B, Sq, Hq, D] (the value rounded to
// the input dtype, as the TPU kernel writes O in q's dtype before the
// wrapper's float32 cast) and lse [B, Sq, Hq].
//
// Which kernel takes which call (static; no fallback between them):
//   bf16,    D 64 or 128  -> the wgmma kernel (flash_fwd_sm90.cuh)
//   float32, any D; bf16, D 192 or 256 -> the FMA kernel below
// The float32 path stays in full float32 (TF32 wgmma would not), so it
// remains the exactness oracle of the float32 checks.
//
// Design of the wgmma kernel (bf16, D 64/128). One block of 384 threads
// per (query head, batch row, q tile of 128 rows): warpgroup 0 produces,
// warpgroups 1 and 2 consume 64 rows each. The TPU walks the key blocks as
// a sequential grid axis with the softmax state in scratch memory; here a
// loop inside the block takes that axis and the state lives in registers.
//   - One producer thread issues TMA copies: Q once, then K and V tiles of
//     128 keys into a ring of 2 stages each, tracked by full/empty
//     mbarrier pairs (K and V apart, so Q K^T starts before V lands).
//     Tiles stay bf16 in shared memory, 128-byte swizzled; at D 128 a row
//     of the tile is two 64-column boxes (the swizzle's width).
//     Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB at D 128.
//   - S = Q K^T: 8 wgmma m64n128k16 per warpgroup (k16 steps along D), A
//     and B K-major from shared memory, f32 accumulators in registers.
//   - The online softmax runs on the accumulator fragment: a row's scores
//     lie on the 4 lanes of a quad (two xor shuffles for the max), the
//     scale is folded with log2(e) into one multiply before exp2, and the
//     running max, the sum and the rescale of O never leave registers.
//     Causal: q tile t reads key tiles 0..t; only tile t is masked (kpos >
//     qpos -> -1e30, as on the TPU); the q tile is the grid's slowest
//     axis, counted down, so all blocks are issued longest row range
//     first and the last wave holds the short ones. Non-causal: every
//     block walks all Skv / 128 key tiles with no mask.
//   - O += P V: P is rounded to bf16 in registers, per key tile against
//     the running max, and fed as wgmma's A operand from registers (the
//     f32 accumulator's element order is the bf16 A fragment's); V is the
//     B operand as it lies, [key, d], with wgmma's transpose flag.
//   - setmaxnreg hands the producer's registers to the consumers at run
//     time (40 / 232); ptxas compiles the whole kernel within the 168
//     registers that 384 threads allow, and the consumers' loop (S 64 + O
//     64 + P 32 floats a thread) fits there with no spill.
//   - Each q tile's arithmetic depends only on its own rows and the keys
//     it sees, in a fixed order: a causal partial equals the causal
//     forward, and ring rank 0's rows equal the single kernel's, bit for
//     bit.
//   Not yet: ping-pong of one warpgroup's softmax against the other's
//   GEMMs, S of the next tile issued before this tile's softmax,
//   persistent blocks, clusters.
//
// The FMA kernel (float32; bf16 at D 192/256): 256 threads per (q tile of
// 64 rows, query head, batch row); Q and each K/V tile staged as float32
// in shared memory (rows padded by one float); thread (ty, tx) owns rows
// ty + 16 i and key columns tx + 16 j, so a row's 16 owners are one half
// warp; products are float32 FMA.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): the
// causal call at the flagship's serving shape (B 1, S 512, Hq 16, Hkv 8,
// D 128, bf16) moves about 6.3 MB against about 1.1 GFLOP, so its bound
// is the memory (about 1.9 us); at B 4, S 2048 it does about 69 GFLOP,
// bound by the tensor-core rate (about 70 us). The non-causal partial at
// llama3-8b's per-rank ring shape (B 4, Sq = Skv 2048, Hq 32, Hkv 8, D
// 128) does 4 B Hq Sq Skv D = 275 GFLOP: bound by operations, 0.28 ms.
// The wgmma kernel feeds the tensor cores from TMA-fed bf16 tiles; what
// still stands between it and that bound is the softmax's exp2 work, which
// runs between a warpgroup's two GEMMs (the other warpgroup's GEMMs fill
// some of it), and, for the causal build, each block's prologue (barrier
// init, the Q and first K/V loads) and epilogue, paid over half as many
// key tiles as the partial's and not overlapped (one 160 KB block per SM).
// float32 has no tensor-core path here: its bound is the 67 TFLOP/s of
// the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per K/V tile
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                 float scale) {
  constexpr int DP = D + 1;      // padded row of Q and K tiles
  constexpr int PP = kBK + 1;    // padded row of the P tile
  constexpr int NJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * D;

  const int qt = gridDim.x - 1 - blockIdx.x;   // causal: longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const long q_stride = (long)Hq * D;          // between sequence rows
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * Sq + (long)qt * kBQ) * q_stride + (long)h * D;
  const T* kb = k + (long)b * Skv * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * Skv * kv_stride + (long)hk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * DP + c] = to_f(qb[r * q_stride + c]);
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = CAUSAL ? qt + 1 : Skv / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();             // Q staged / previous tiles consumed
    const T* kp = kb + (long)kt * kBK * kv_stride;
    const T* vp = vb + (long)kt * kBK * kv_stride;
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      Ks[r * DP + c] = to_f(kp[r * kv_stride + c]);
      Vs[r * D + c] = to_f(vp[r * kv_stride + c]);
    }
    __syncthreads();

    // S = Q K^T on this thread's 4 x 4 sub-tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax; each row's 16 owners are one half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qt * kBQ + ty + 16 * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt * kBK + tx + 16 * j;
        const float x = CAUSAL && kpos > qpos ? kNegInf : s[i][j] * scale;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float a[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kBQ + ty + 16 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    const long orow = ((long)b * Sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const T x = from_f<T>(acc[i][j] / lc);
      if (CAUSAL)
        static_cast<T*>(o)[orow + tx + 16 * j] = x;
      else      // the partial: float32 of the rounded value
        static_cast<float*>(o)[orow + tx + 16 * j] = to_f(x);
    }
    if (tx == 0)
      lse[CAUSAL ? ((long)b * Hq + h) * Sq + row : ((long)b * Sq + row) * Hq + h] =
          m[i] + logf(lc);
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Sq / kBQ, Hq, B);
  flash_fwd_kernel<T, D, CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, static_cast<float*>(lse), Sq, Skv, Hq,
      Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 64:  return launch<T, 64, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 128: return launch<T, 128, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 192: return launch<T, 192, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 256: return launch<T, 256, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    default:  return -1;
  }
}

// bf16 at D 64/128 -> the wgmma kernel; bf16 at D 192/256 -> the FMA one
template <bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                float scale, cudaStream_t stream) {
  switch (D) {
    case 64:  return flash_sm90::launch<64, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 128: return flash_sm90::launch<128, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 192: return launch<__nv_bfloat16, 192, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    case 256: return launch<__nv_bfloat16, 256, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, stream);
    default:  return -1;
  }
}

template <bool CAUSAL>
int launch_t(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D,
                                   scale, st);
  if (dtype == 1)
    return launch_bf16<CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D,
                               scale, st);
  return -1;
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return cudaGetLastError() after the
// launch (0 on success), -1 for a head dim or dtype they were not built
// for, or -2 when the driver refuses a TMA descriptor (bf16 at D 64/128).
// dtype: 0 float32, 1 bfloat16. Hq must be a multiple of Hkv.

// Causal attention; S (= Sq = Skv) a multiple of 128 (of 64 for the FMA
// kernel). o like q, lse [B, Hq, S].
int htpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int Hq, int Hkv, int D,
                   int dtype, float scale, void* stream) {
  return launch_t<true>(q, k, v, o, lse, B, S, S, Hq, Hkv, D, dtype, scale,
                        stream);
}

// The fully visible partial: every query row attends to every key. Sq and
// Skv multiples of 128 (of 64 for the FMA kernel). o float32 [B, Sq, Hq,
// D], lse [B, Sq, Hq].
int htpu_flash_fwd_partial(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int Sq, int Skv,
                           int Hq, int Hkv, int D, int dtype, float scale,
                           void* stream) {
  return launch_t<false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, dtype,
                         scale, stream);
}

// Dynamic shared memory per block, in bytes, of the kernel that takes
// (D, dtype); -1 for a head dim or dtype no kernel was built for.
int htpu_flash_fwd_smem(int D, int dtype) {
  if (dtype == 1 && D == 64) return (int)flash_sm90::Layout<64>::kSmem;
  if (dtype == 1 && D == 128) return (int)flash_sm90::Layout<128>::kSmem;
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
