// The weight plane's int8 dequantize for Hopper (sm_90a), a plain C entry.
//
// Not a TPU kernel: the reference dequantizes inside each serving matmul
// in jnp (`_dequant`, hadoop_tpu/serving/weightplane.py:463-468) and
// relies on XLA to fuse the convert and the scale into the matmul's
// operand read. Run eagerly in PyTorch the same arithmetic is a widen to
// float32, a float32 multiply and a cast, each through device memory:
// about 13 bytes of traffic per weight element. Here it is one pass.
//
// Bound: bytes. Per element the pass reads the int8 payload (1 byte) and
// a float32 scale per group of `gs` elements, and writes the output (2
// bytes in bf16): ~3.06 bytes an element at gs 64. Design: a grid-stride
// loop over 16 payload bytes at a time (one 16-byte load, one scale, two
// 16-byte stores in bf16, four in float32) when gs is a multiple of 16
// and the pointers are aligned for it, else one element at a time. No
// shared memory: nothing is reused.
//
// Numerics, bit for bit the plain version's (`_dequant`):
//   out = (dtype) ((float) q * s)
// one IEEE float32 multiply (__fmul_rn) and one round to nearest even
// to the output dtype (__float2bfloat16_rn), or the float32 product as
// it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;     // 16 resident blocks on each SM
constexpr int kVec = 16;                 // payload bytes per vector step

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// sixteen outputs, stored as 16-byte pieces
template <typename T> struct alignas(16) Out16 { T v[kVec]; };

// vec != 0: gs % 16 == 0 and q, out are 16-byte aligned, so each vector
// of 16 payload bytes lies in one scale group
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               T* __restrict__ out, long long count, int gs, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long groups = count / kVec;
    for (long long i = start; i < groups; i += stride) {
      const int4 raw = reinterpret_cast<const int4*>(q)[i];
      const float scale = s[(i * kVec) / gs];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      Out16<T> o;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        o.v[j] = from_f<T>(__fmul_rn((float)b[j], scale));
      reinterpret_cast<Out16<T>*>(out)[i] = o;
    }
    head = groups * kVec;
  }
  for (long long i = head + start; i < count; i += stride)
    out[i] = from_f<T>(__fmul_rn((float)q[i], s[i / gs]));
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
int launch(const void* q, const void* s, void* out, long long count, int gs,
           cudaStream_t stream) {
  const bool vec = gs % kVec == 0 && aligned(q, 16) && aligned(out, 16);
  const long long work = vec ? count / kVec + count % kVec : count;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  dequant_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(out), count, gs, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = (dtype) ((float) q[i] * s[i / gs]) for i < count, on `stream`:
// q int8 and s float32 contiguous, the scales one per `gs` consecutive
// payload bytes; out contiguous in dtype 0 float32 or 1 bfloat16.
// Returns cudaGetLastError() after the launch (0 on success), or -1 for
// a dtype, count or group it does not take.
int htpu_dequant_int8(const void* q, const void* s, void* out,
                      long long count, int gs, int dtype, void* stream) {
  if (count < 0 || gs < 1) return -1;
  if (count == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, s, out, count, gs, st);
    case 1: return launch<__nv_bfloat16>(q, s, out, count, gs, st);
    default: return -1;
  }
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
