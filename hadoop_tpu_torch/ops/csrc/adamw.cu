// AdamW's update and the squared global gradient norm for Hopper
// (sm_90a), plain C entry points.
//
// Not a TPU kernel: the reference's optimizer step (`_apply`,
// hadoop_tpu/parallel/optimizer.py:62) is plain jnp, which XLA fuses into
// one pass per leaf inside the jitted train step. Run eagerly in PyTorch
// the same arithmetic is ~19 elementwise kernels per leaf, ~164 bytes of
// traffic per parameter; here it is one pass per leaf.
//
// Bound: bytes. Per parameter the update reads p and g (in the leaf's
// dtype) and the float32 moments m and n, and writes p, m and n: 22 bytes
// for a bf16 leaf, ~6.5 ms for flagship-1b's 985e6 parameters at 3.35
// TB/s. Design: a grid-stride loop over groups of 4 elements (8-byte bf16
// and 16-byte float32 loads and stores) when every pointer is aligned for
// that, else one element at a time (one kernel for both: a kernel built
// for the scalar loop alone spilled at float32); no shared memory, no
// reuse to exploit.
//
// Numerics: the reference's float32 order, one IEEE-rounded operation at
// a time (the __f*_rn intrinsics keep nvcc from contracting a multiply
// and an add into an fma, which would change the last bit):
//   g' = g * scale
//   m  = b1 * m + (1 - b1) * g'
//   n  = b2 * n + (1 - b2) * g'^2
//   u  = (m / bc1) / (sqrt(n / bc2) + eps)
//   u  = u + wd * p                    (leaves with ndim >= 2)
//   p  = p - lr * u, rounded to p's dtype (to nearest even)
// `scale`, the clip factor min(1, clip / max(|g|, 1e-12)), is read from
// device memory, so the step never waits on the host for the norm. The
// constants (1 - b1, the bias corrections) come from the host, computed in
// double and rounded once, as the plain version's scalars are.
//
// The squared norm reads each gradient in its own dtype (no float32 copy
// of it): each block of the partial pass sums a fixed grid-stride share of
// one leaf in float32 and writes one partial; the finish pass sums every
// leaf's partials in one block. Fixed grids and a fixed order: the same
// bits on every call, no atomics.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;     // 8 resident blocks on each SM
constexpr int kFinishThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// four elements, loaded and stored as one 8- or 16-byte access
template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, weight_decay, lr;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& n,
                                       float scale, const Hyper& h,
                                       bool decay) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  n = __fadd_rn(__fmul_rn(h.b2, n), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(n, h.bc2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// vec != 0: every pointer is aligned for 4-element accesses
template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
             float* __restrict__ n, long long count,
             const float* __restrict__ scale_ptr, Hyper h, int decay,
             int vec) {
  const float scale = *scale_ptr;
  const bool dec = decay != 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long groups = count / 4;
    for (long long i = start; i < groups; i += stride) {
      Vec4<T> pv = reinterpret_cast<const Vec4<T>*>(p)[i];
      const Vec4<T> gv = reinterpret_cast<const Vec4<T>*>(g)[i];
      float4 mv = reinterpret_cast<const float4*>(m)[i];
      float4 nv = reinterpret_cast<const float4*>(n)[i];
      float ms[4] = {mv.x, mv.y, mv.z, mv.w};
      float ns[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pf = to_f(pv.v[j]);
        update(pf, to_f(gv.v[j]), ms[j], ns[j], scale, h, dec);
        pv.v[j] = from_f<T>(pf);
      }
      reinterpret_cast<Vec4<T>*>(p)[i] = pv;
      reinterpret_cast<float4*>(m)[i] = make_float4(ms[0], ms[1], ms[2], ms[3]);
      reinterpret_cast<float4*>(n)[i] = make_float4(ns[0], ns[1], ns[2], ns[3]);
    }
    head = groups * 4;
  }
  for (long long i = head + start; i < count; i += stride) {
    float pf = to_f(p[i]);
    float mf = m[i], nf = n[i];
    update(pf, to_f(g[i]), mf, nf, scale, h, dec);
    p[i] = from_f<T>(pf);
    m[i] = mf;
    n[i] = nf;
  }
}

// Sum of `x` over the block, in a fixed order: a butterfly within each
// warp, then warp 0 over the warps' sums. Thread 0 holds the result.
template <int THREADS>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const T* __restrict__ g, float* __restrict__ partials,
             long long count, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  long long head = 0;
  if (vec) {
    const long long groups = count / 4;
    for (long long i = start; i < groups; i += stride) {
      const Vec4<T> gv = reinterpret_cast<const Vec4<T>*>(g)[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = to_f(gv.v[j]);
        acc = fmaf(x, x, acc);
      }
    }
    head = groups * 4;
  }
  for (long long i = head + start; i < count; i += stride) {
    const float x = to_f(g[i]);
    acc = fmaf(x, x, acc);
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
           int total) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < total; i += kFinishThreads) acc += partials[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) *out = acc;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
int launch_adamw(void* p, const void* g, void* m, void* n, const void* scale,
                 long long count, int decay, const Hyper& h,
                 cudaStream_t stream) {
  const bool vec = aligned(p, 4 * sizeof(T)) && aligned(g, 4 * sizeof(T)) &&
                   aligned(m, 16) && aligned(n, 16);
  const long long work = vec ? (count + 3) / 4 : count;
  const int blocks = (int)(work / kThreads + 1 < kMaxBlocks
                               ? work / kThreads + 1 : kMaxBlocks);
  adamw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
      static_cast<float*>(n), count, static_cast<const float*>(scale), h,
      decay, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sumsq(const void* g, void* partials, long long count, int blocks,
                 cudaStream_t stream) {
  sumsq_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<float*>(partials), count,
      aligned(g, 4 * sizeof(T)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() after
// the launch (0 on success), or -1 for a dtype it was not built for or a
// count it does not take. dtype: 0 float32, 1 bfloat16, 2 float16.

// One AdamW step over `count` elements of one leaf, in place: p (dtype)
// and the float32 moments m and n; g like p; scale a float32 scalar in
// device memory; decay != 0 applies the weight decay.
int htpu_adamw(void* p, const void* g, void* m, void* n, const void* scale,
               int count, int dtype, int decay, float b1, float one_minus_b1,
               float b2, float one_minus_b2, float bc1, float bc2, float eps,
               float weight_decay, float lr, void* stream) {
  if (count < 0) return -1;
  if (count == 0) return 0;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps,
                weight_decay, lr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_adamw<float>(p, g, m, n, scale, count, decay, h, st);
    case 1: return launch_adamw<__nv_bfloat16>(p, g, m, n, scale, count, decay, h, st);
    case 2: return launch_adamw<__half>(p, g, m, n, scale, count, decay, h, st);
    default: return -1;
  }
}

// partials[0..blocks) = sums of g*g (float32) over `blocks` fixed shares
// of g's `count` elements; 1 <= blocks <= 1024.
int htpu_grad_sq_partial(const void* g, void* partials, int count, int blocks,
                         int dtype, void* stream) {
  if (count < 0 || blocks < 1 || blocks > 1024) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_sumsq<float>(g, partials, count, blocks, st);
    case 1: return launch_sumsq<__nv_bfloat16>(g, partials, count, blocks, st);
    case 2: return launch_sumsq<__half>(g, partials, count, blocks, st);
    default: return -1;
  }
}

// *out = the sum of partials[0..total), float32, in one block.
int htpu_grad_sq_finish(const void* partials, void* out, int total,
                        void* stream) {
  if (total < 0) return -1;
  sum_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), total);
  return (int)cudaGetLastError();
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
