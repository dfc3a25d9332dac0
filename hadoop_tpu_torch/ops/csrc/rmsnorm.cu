// RMSNorm forward and backward for Hopper (sm_90a), plain C entries.
//
// Not a TPU kernel: the reference's norms are jnp (hadoop_tpu/ops/
// norms.py:12-18), written so XLA fuses them into one pass over the
// activation. Run eagerly in PyTorch the formula is one kernel per step
// (widen, square, mean, add, sqrt, reciprocal, two multiplies, cast), and
// autograd keeps float32 [rows, D] intermediates for the backward. Here
// the forward is one pass and the backward one pass plus a small finish.
//
// Bound: bytes. The forward reads x and w and writes y (and one float32
// 1/rms per row, kept for the backward); the backward reads dy, x, w and
// the 1/rms and writes dx and dw. Forward: one block of 256 threads per
// row, each thread holding up to NV vectors of 16 bytes of the row in
// registers (so x is read once; rows of up to 8192, NV up to 4 in the
// 2-byte dtypes and 8 in float32), a fixed-order block sum of the
// squares, then the output.
//
// Backward: a fixed grid of about two blocks an SM, each with a fixed
// share of consecutive rows (the wrapper's grid, ops/norms.py
// `_bwd_grid`). A block takes R rows at a time (R·NV = 4 vectors of 16
// bytes each of dy and x per thread) and starts the next R rows' loads
// before it works on these, so every thread keeps 64 to 128 bytes in
// flight. It sums g·x of each row by a butterfly within each warp, and
// after one barrier every thread adds the eight warps' sums in warp
// order itself (the warp sums double-buffered in shared memory: one
// barrier a group of R rows). dw's partial over the share stays in each
// thread's registers (its own columns, rows in order) and is written
// once per block. A finish kernel sums the blocks' partials per column,
// 32 columns a block and d/32 blocks: warp v of a block takes partials
// v, v+8, ... in order, in float64 (a float32 running sum would add the
// roundings up), and the eight warps' sums are added in warp order.
// Fixed grids, fixed order, no atomics: the same bits on every call
// (the pattern of adamw.cu's squared norm). x, w, y, dy, dx and dw share
// one dtype: float32, bfloat16 or float16.
//
// Numerics: float32 throughout, the reference's cast points:
//   r  = 1 / sqrt(sum(x²) / D + eps)          (per row, float32)
//   y  = (dtype) ((x · r) · w)
//   g  = dy · w
//   dx = (dtype) (r · g − x · (r·r·r · sum(g·x) / D))
//   dw = (dtype) sum over rows of dy · (x · r)  (partials in float32)
// Each product is one IEEE-rounded float32 operation (the __f*_rn
// intrinsics keep nvcc from contracting them); the sums run in another
// order than PyTorch's, so the plain version (ops/norms.py) agrees to a
// few float32 ulps of the row's largest term.
//
// Launches of the backward: two (the pass and the dw finish).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNV = 8;               // vectors of 16 bytes per thread
constexpr int kMaxD = 8192;             // the widest row taken

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

// VEC elements of T, VEC = 16 bytes / sizeof(T)
template <typename T, int VEC> struct alignas(16) Vec { T v[VEC]; };

// The sum of `x` over the block, in a fixed order (a butterfly within
// each warp, then warp 0 over the warps' sums), returned to every thread.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (threadIdx.x == 0) total = x;
  }
  __syncthreads();
  return total;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ rrms, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const long long base = (long long)blockIdx.x * d;
  const int nvec = d / VEC;
  const Vec<T, VEC>* xr = reinterpret_cast<const Vec<T, VEC>*>(x + base);
  float xv[NV][VEC];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < nvec) {
      const Vec<T, VEC> in = xr[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xv[k][j] = to_f(in.v[j]);
        acc = fmaf(xv[k][j], xv[k][j], acc);
      }
    }
  }
  const float var = __fdiv_rn(block_sum(acc), (float)d);
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  if (threadIdx.x == 0) rrms[blockIdx.x] = r;
  Vec<T, VEC>* yr = reinterpret_cast<Vec<T, VEC>*>(y + base);
  const Vec<T, VEC>* wr = reinterpret_cast<const Vec<T, VEC>*>(w);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < nvec) {
      const Vec<T, VEC> wv = wr[v];
      Vec<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = from_f<T>(__fmul_rn(__fmul_rn(xv[k][j], r), to_f(wv.v[j])));
      yr[v] = out;
    }
  }
}

// The R rows of dy and x a backward group takes: R·NV = 4 vectors of 16
// bytes of each per thread (one row at 8192 wide, or 4096 in float32)
template <int NV>
__host__ __device__ constexpr int rows_in_flight() {
  return NV < 4 ? 4 / NV : 1;
}

// Rows [row0, row0 + R) of dy and x (those before `last`) into
// registers, in their own type, and their 1/rms.
template <typename T, int VEC, int NV, int R>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ rrms, int row0, int last, int d, int nvec,
    Vec<T, VEC> (&dyv)[R][NV], Vec<T, VEC> (&xin)[R][NV], float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    r[i] = row < last ? rrms[row] : 0.f;
    const Vec<T, VEC>* dyr =
        reinterpret_cast<const Vec<T, VEC>*>(dy + (long long)row * d);
    const Vec<T, VEC>* xr =
        reinterpret_cast<const Vec<T, VEC>*>(x + (long long)row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (row < last && v < nvec) {
        dyv[i][k] = dyr[v];
        xin[i][k] = xr[v];
      }
    }
  }
}

// Tell the compiler the vector may have changed: the values widened from
// it before are not kept in registers for a later use (it widens again).
template <typename T, int VEC>
__device__ __forceinline__ void reload(Vec<T, VEC>& v) {
  uint4& u = reinterpret_cast<uint4&>(v);
  asm volatile("" : "+r"(u.x), "+r"(u.y), "+r"(u.z), "+r"(u.w));
}

// Rows [blockIdx.x * per_block, +per_block) of dx, R at a time with the
// next R rows' loads in flight, and the block's dw partial over them into
// partials[blockIdx.x * d ...]. Two resident blocks an SM (128 registers
// a thread), one for rows of 32 elements a thread (dw's partial alone
// then takes 32 registers).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, NV * 16 / sizeof(T) < 32 ? 2 : 1)
rms_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
               const T* __restrict__ w, const float* __restrict__ rrms,
               T* __restrict__ dx, float* __restrict__ partials, int rows,
               int d, int per_block) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = rows_in_flight<NV>();
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_dots[2][R][kWarps];      // double-buffered
  const int nvec = d / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Vec<T, VEC>* wr = reinterpret_cast<const Vec<T, VEC>*>(w);
  Vec<T, VEC> wv[NV];
  float dw[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < nvec) wv[k] = wr[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[k][j] = 0.f;
  }
  const int first = blockIdx.x * per_block;
  const int last = min(rows, first + per_block);
  Vec<T, VEC> dyv[R][NV], xin[R][NV];
  float r[R];
  load_rows<T, VEC, NV, R>(dy, x, rrms, first, last, d, nvec, dyv, xin, r);
  int buf = 0;
#pragma unroll 1
  for (int row0 = first; row0 < last; row0 += R, buf ^= 1) {
    Vec<T, VEC> dyn[R][NV], xn[R][NV];
    float rn[R];
    load_rows<T, VEC, NV, R>(dy, x, rrms, row0 + R, last, d, nvec, dyn, xn,
                             rn);
    float dot[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      dot[i] = 0.f;
      if (row0 + i >= last) continue;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nvec) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float dyf = to_f(dyv[i][k].v[j]);
            const float xf = to_f(xin[i][k].v[j]);
            dot[i] = fmaf(__fmul_rn(dyf, to_f(wv[k].v[j])), xf, dot[i]);
            dw[k][j] = fmaf(dyf, __fmul_rn(xf, r[i]), dw[k][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        reload(dyv[i][k]);
        reload(xin[i][k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      if (lane == 0) warp_dots[buf][i][warp] = dot[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + i;
      if (row >= last) break;
      float total = warp_dots[buf][i][0];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) total += warp_dots[buf][i][v];
      const float mean = __fdiv_rn(total, (float)d);
      const float c = __fmul_rn(__fmul_rn(__fmul_rn(r[i], r[i]), r[i]), mean);
      Vec<T, VEC>* dxr = reinterpret_cast<Vec<T, VEC>*>(dx + (long long)row * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nvec) {
          Vec<T, VEC> out;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float g = __fmul_rn(to_f(dyv[i][k].v[j]), to_f(wv[k].v[j]));
            out.v[j] = from_f<T>(__fsub_rn(__fmul_rn(r[i], g),
                                           __fmul_rn(to_f(xin[i][k].v[j]), c)));
          }
          dxr[v] = out;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      r[i] = rn[i];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        dyv[i][k] = dyn[i][k];
        xin[i][k] = xn[i][k];
      }
    }
  }
  float* part = partials + (long long)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[v * VEC + j] = dw[k][j];
    }
  }
}

// dw[c] for 32 columns a block: warp v sums partials v, v + 8, ... in
// order (float64), then the eight warps' sums are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_dw_finish_kernel(const float* __restrict__ partials, T* __restrict__ dw,
                     int blocks, int d) {
  constexpr int kWarps = kThreads / 32;
  __shared__ double sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  double acc = 0.0;
  if (col < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kWarps)
      acc += partials[(long long)b * d + col];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < d) {
    double total = sums[0][lane];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) total += sums[v][lane];
    dw[col] = from_f<T>((float)total);
  }
}

// vectors of 16 bytes each thread holds for a row of d elements of T:
// 0 for a row the kernels do not take
template <typename T>
int vectors_per_thread(int d) {
  constexpr int VEC = 16 / sizeof(T);
  if (d < 1 || d % VEC || d > kMaxD) return 0;
  const int nv = (d / VEC + kThreads - 1) / kThreads;
  for (int n = 1; n <= kMaxNV; n *= 2)
    if (nv <= n) return n;
  return 0;
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, void* rrms, int rows,
               int d, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rrms);
  switch (vectors_per_thread<T>(d)) {
    case 1:
      rms_fwd_kernel<T, 1><<<rows, kThreads, 0, st>>>(xp, wp, yp, rp, d, eps);
      break;
    case 2:
      rms_fwd_kernel<T, 2><<<rows, kThreads, 0, st>>>(xp, wp, yp, rp, d, eps);
      break;
    case 4:
      rms_fwd_kernel<T, 4><<<rows, kThreads, 0, st>>>(xp, wp, yp, rp, d, eps);
      break;
    case 8:     // float32 rows past 4096 (2-byte rows stop at 4 vectors)
      if constexpr (sizeof(T) == 4) {
        rms_fwd_kernel<T, 8><<<rows, kThreads, 0, st>>>(xp, wp, yp, rp, d,
                                                        eps);
        break;
      }
      return -1;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* w, const void* rrms,
               void* dx, void* partials, int rows, int d, int blocks,
               cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* rp = static_cast<const float*>(rrms);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partials);
  const int per = (rows + blocks - 1) / blocks;
  switch (vectors_per_thread<T>(d)) {
    case 1:
      rms_bwd_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
          dyp, xp, wp, rp, dxp, pp, rows, d, per);
      break;
    case 2:
      rms_bwd_kernel<T, 2><<<blocks, kThreads, 0, st>>>(
          dyp, xp, wp, rp, dxp, pp, rows, d, per);
      break;
    case 4:
      rms_bwd_kernel<T, 4><<<blocks, kThreads, 0, st>>>(
          dyp, xp, wp, rp, dxp, pp, rows, d, per);
      break;
    case 8:
      if constexpr (sizeof(T) == 4) {
        rms_bwd_kernel<T, 8><<<blocks, kThreads, 0, st>>>(
            dyp, xp, wp, rp, dxp, pp, rows, d, per);
        break;
      }
      return -1;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const void* partials, void* dw, int blocks, int d,
                  cudaStream_t st) {
  rms_dw_finish_kernel<T><<<(d + 31) / 32, kThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<T*>(dw), blocks, d);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 float16
#define HTPU_RMS_DISPATCH(DTYPE, CALL)                                      \
  switch (DTYPE) {                                                          \
    case 0: return CALL(float);                                             \
    case 1: return CALL(__nv_bfloat16);                                     \
    case 2: return CALL(__half);                                            \
    default: return -1;                                                     \
  }

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() after
// the launch (0 on success), or -1 for a dtype, a row width or a count it
// does not take. All pointers 16-byte aligned; x, dy, dx contiguous
// [rows, d]; w, dw [d], in x's dtype; rrms float32 [rows]. A row width
// is taken when d % (16 / itemsize) == 0 and d <= 8192.

// y = (x · r) · w per row, r = 1 / sqrt(mean(x²) + eps) into rrms.
int htpu_rms_norm_fwd(const void* x, const void* w, void* y, void* rrms,
                      int rows, int d, int dtype, float eps, void* stream) {
  if (rows < 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HTPU_FWD(T) launch_fwd<T>(x, w, y, rrms, rows, d, eps, st)
  HTPU_RMS_DISPATCH(dtype, HTPU_FWD)
#undef HTPU_FWD
}

// dx per row, and `blocks` dw partials [blocks, d] float32 over fixed
// shares of ceil(rows / blocks) consecutive rows; 1 <= blocks <= rows
// (the wrapper's `_bwd_grid`: about two blocks an SM, none empty).
int htpu_rms_norm_bwd(const void* dy, const void* x, const void* w,
                      const void* rrms, void* dx, void* partials, int rows,
                      int d, int blocks, int dtype, void* stream) {
  if (rows < 1 || blocks < 1 || blocks > rows) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HTPU_BWD(T) \
  launch_bwd<T>(dy, x, w, rrms, dx, partials, rows, d, blocks, st)
  HTPU_RMS_DISPATCH(dtype, HTPU_BWD)
#undef HTPU_BWD
}

// dw[c] = (dtype) the sum of partials[b, c] over b < blocks, in order.
int htpu_rms_norm_dw(const void* partials, void* dw, int blocks, int d,
                     int dtype, void* stream) {
  if (blocks < 1 || d < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HTPU_DW(T) launch_finish<T>(partials, dw, blocks, d, st)
  HTPU_RMS_DISPATCH(dtype, HTPU_DW)
#undef HTPU_DW
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
