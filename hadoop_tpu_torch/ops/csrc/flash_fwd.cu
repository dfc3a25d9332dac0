// Flash-attention forward for Hopper (sm_90a), plain C entry points:
// the causal forward and the fully visible (non-causal) ring partial.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (hadoop_tpu/ops/flash.py),
// in both of its uses: launched by `_fwd` with causal=True (the model's
// attention, and ring attention's diagonal chunk), and with causal=False
// through `flash_attention_partial` (ring attention's other chunks, Sq and
// Skv free). Online-softmax attention with grouped-query heads (query head
// h reads KV head h / (Hq / Hkv)), scores and softmax statistics in
// float32, P rounded to the input dtype before P.V, O written in the input
// dtype (also for the partial, as the TPU kernel writes it) and the per-row
// log-sum-exp in float32.
//
// Layout: q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], o like q, all
// contiguous (the model's own layout, so no transpose is needed);
// lse [B, Hq, Sq] float32. The causal entry has Sq == Skv.
//
// Design. One thread block of 256 threads per (q tile of 64 rows, query
// head, batch row). The TPU walks the key blocks as a sequential grid
// axis with the softmax state in scratch memory; here a loop inside the
// block takes that axis, and the state lives in registers:
//   - the Q tile and each K/V tile are staged in shared memory as float32
//     (rows padded by one float so column walks hit distinct banks);
//   - thread (ty, tx) owns rows ty + 16 i and, for S = Q K^T, key columns
//     tx + 16 j (i, j < 4). A row's 16 owners are the 16 lanes of one half
//     warp, so row max and row sum reduce with four xor shuffles and the
//     running max, sum and rescale never leave registers;
//   - the same thread owns output columns tx + 16 j (j < D / 16) of its
//     rows for O += P V, so the per-row rescale is local too;
//   - causal: tiles past the diagonal are never loaded: q tile t reads K/V
//     tiles 0..t, and only tile t is masked (kpos > qpos -> -1e30, as on
//     the TPU); blocks are issued longest row-range first, so the long
//     diagonal tails start early and the last wave is short;
//   - non-causal (the CAUSAL template flag off): every block walks all
//     Skv / 64 K/V tiles with no mask, so every block has the same work
//     and the issue order does not matter.
// Products are plain float32 FMA (no tensor cores): the result is the
// same function for bf16 and float32 inputs, and float32 stays float32.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// flagship's serving shape (B 1, S 512, Hq 16, Hkv 8, D 128, bf16) the
// causal call moves about 6.3 MB against about 1.1 GFLOP, so its bound is
// the memory (about 1.9 us); at B 4, S 2048 it does about 69 GFLOP, so its
// bound is the tensor-core rate (about 69 us). The non-causal partial at
// llama3-8b's per-rank ring shape (B 4, Sq = Skv 2048, Hq 32, Hkv 8, D 128)
// does 4 B Hq Sq Skv D = 275 GFLOP: bound by operations, about 0.28 ms.
// This first version runs on the FMA units and is far from either bound;
// wgmma/TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
                 const T* __restrict__ v, T* __restrict__ o,
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
    T* orow = o + ((long)b * Sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[((long)b * Hq + h) * Sq + row] = m[i] + logf(lc);
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
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, scale);
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

template <bool CAUSAL>
int launch_t(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D,
                                   scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, CAUSAL>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                           Hkv, D, scale, st);
  return -1;
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return cudaGetLastError() after the
// launch (0 on success), or -1 for a head dim or dtype they were not built
// for. dtype: 0 float32, 1 bfloat16. Hq must be a multiple of Hkv.

// Causal attention; S (= Sq = Skv) a multiple of 64.
int htpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int Hq, int Hkv, int D,
                   int dtype, float scale, void* stream) {
  return launch_t<true>(q, k, v, o, lse, B, S, S, Hq, Hkv, D, dtype, scale,
                        stream);
}

// The fully visible partial: every query row attends to every key. Sq and
// Skv multiples of 64.
int htpu_flash_fwd_partial(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int Sq, int Skv,
                           int Hq, int Hkv, int D, int dtype, float scale,
                           void* stream) {
  return launch_t<false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, dtype,
                         scale, stream);
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
