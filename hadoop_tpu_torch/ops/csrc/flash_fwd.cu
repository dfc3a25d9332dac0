// Causal flash-attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (hadoop_tpu/ops/flash.py,
// launched by `_fwd` with causal=True): online-softmax causal attention
// with grouped-query heads (query head h reads KV head h / (Hq / Hkv)),
// scores and softmax statistics in float32, P rounded to the input dtype
// before P.V, O written in the input dtype and the per-row log-sum-exp in
// float32.
//
// Layout: q [B, S, Hq, D], k and v [B, S, Hkv, D], o like q, all
// contiguous (the model's own layout, so no transpose is needed);
// lse [B, Hq, S] float32.
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
//   - tiles past the diagonal are never loaded: q tile t reads K/V tiles
//     0..t, and only tile t is masked (kpos > qpos -> -1e30, as on the TPU);
//   - blocks are issued longest row-range first, so the long diagonal
//     tails start early and the last wave is short.
// Products are plain float32 FMA (no tensor cores): the result is the
// same function for bf16 and float32 inputs, and float32 stays float32.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// flagship's serving shape (B 1, S 512, Hq 16, Hkv 8, D 128, bf16) the
// call moves about 6.3 MB against about 1.1 GFLOP, so its bound is the
// memory (about 1.9 us); at B 4, S 2048 it does about 69 GFLOP, so its
// bound is the tensor-core rate (about 69 us). This first version runs on
// the FMA units and is far from either bound; wgmma/TMA come later.

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv,
                 float scale) {
  constexpr int DP = D + 1;      // padded row of Q and K tiles
  constexpr int PP = kBK + 1;    // padded row of the P tile
  constexpr int NJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * D;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const long q_stride = (long)Hq * D;          // between sequence rows
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * S + (long)qt * kBQ) * q_stride + (long)h * D;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * D;

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

  for (int kt = 0; kt <= qt; ++kt) {
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
        const float x = kpos > qpos ? kNegInf : s[i][j] * scale;
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
    T* orow = o + ((long)b * S + row) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[((long)b * Hq + h) * S + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int S, int Hq, int Hkv, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 64:  return launch<T, 64>(q, k, v, o, lse, B, S, Hq, Hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, Hq, Hkv, scale, stream);
    case 192: return launch<T, 192>(q, k, v, o, lse, B, S, Hq, Hkv, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, S, Hq, Hkv, scale, stream);
    default:  return -1;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 on success), or -1 for a head dim or dtype it was not built for.
// dtype: 0 float32, 1 bfloat16. S must be a multiple of 64 and Hq of Hkv.
int htpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int Hq, int Hkv, int D,
                   int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, S, Hq, Hkv, D, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, Hq, Hkv, D, scale, st);
  return -1;
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
