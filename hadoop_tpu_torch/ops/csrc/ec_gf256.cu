// Reed-Solomon coding over GF(256) for Hopper (sm_90a), a plain C entry.
//
// Replaces `_apply_matrix` (hadoop_tpu/ops/ec_device.py:63), which
// reaches no pallas_call: XLA fuses its r·k·8 shift/and/multiply/xor
// terms into one elementwise pass over the stripe. Run eagerly in
// PyTorch, each of those ~4·r·k·8 operations is a launch of its own that
// reads and writes a whole [W] row (RS(6,3): ~576 launches an encode).
// Here they are one pass.
//
// The arithmetic is the reference's, bit for bit: a multiply by the
// constant c decomposes over the bits of the data byte,
//   gf_mul(c, b) = XOR over set bits s of b of gf_mul(c, 2^s),
// so with four bytes packed in a 32-bit word each term is
//   ((w >> s) & 0x01010101) * K[i][j][s]
// (a 0/1 byte-lane mask times a byte constant: no carry crosses a lane),
// and output word i is the XOR of the k·8 terms of its row.
//
// Bound: the floor of any implementation is bytes, (k + r)·4 B per word
// column (each data word read once, each output word written once) at
// the memory rate. This design does 4 integer operations a term, 32·k·r
// a column: RS(6,3) 576 against 36 B, 16 per byte, well above the 32-bit
// integer units' rate over the memory rate (64 a clock on each SM, ~5 per
// byte), so it is bound by its integer rate, not by memory. A table of
// GF(256) products in shared memory would do fewer operations; a simple
// kernel that is right comes first.
//
// Design: one thread per word column, a grid-stride loop over columns.
// The [r, k, 8] constants of the schema or erasure pattern are staged in
// shared memory once per block (read by all threads at one address: a
// broadcast). Each thread stages its column's k data words in its own
// slots of a shared tile (runtime k, so no local-memory array), reads
// each from device memory once, and writes each of its r output words
// once. Columns are indexed in long long: a 128 MiB unit is 2^25 words,
// and [k, W] holds k·W of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnits = 16;            // k and r at most (MAX_UNITS)
constexpr int kMaxBlocks = 132 * 8;      // 8 resident blocks on each SM
constexpr uint32_t kLanes = 0x01010101u;

__global__ void __launch_bounds__(kThreads)
gf256_apply_kernel(const uint32_t* __restrict__ data,
                   const uint32_t* __restrict__ consts,
                   uint32_t* __restrict__ out, long long W, int k, int r) {
  __shared__ uint32_t sc[kMaxUnits * kMaxUnits * 8];     // 8 KB
  __shared__ uint32_t tile[kMaxUnits * kThreads];        // 16 KB
  for (int t = threadIdx.x; t < r * k * 8; t += kThreads) sc[t] = consts[t];
  __syncthreads();
  uint32_t* mine = tile + threadIdx.x;   // word j of this column: mine[j * kThreads]
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
       col < W; col += stride) {
    for (int j = 0; j < k; ++j) mine[j * kThreads] = data[j * W + col];
    for (int i = 0; i < r; ++i) {
      const uint32_t* ci = sc + i * k * 8;
      uint32_t acc = 0;
      for (int j = 0; j < k; ++j) {
        const uint32_t w = mine[j * kThreads];
        const uint32_t* c = ci + j * 8;
#pragma unroll
        for (int s = 0; s < 8; ++s) acc ^= ((w >> s) & kLanes) * c[s];
      }
      out[i * W + col] = acc;
    }
  }
}

}  // namespace

extern "C" {

// out [r, W] = the GF(256) matrix whose bit constants are consts
// [r, k, 8] applied to data [k, W], on `stream`: 32-bit words, four bytes
// each, all three contiguous on the device. Returns cudaGetLastError()
// after the launch (0 on success), or -1 for a k, r or W it does not take.
int htpu_ec_gf256_apply(const void* data, const void* consts, void* out,
                        long long W, int k, int r, void* stream) {
  if (k < 1 || r < 1 || k > kMaxUnits || r > kMaxUnits || W < 0) return -1;
  if (W == 0) return 0;
  const long long want = (W + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  gf256_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(out), W, k, r);
  return (int)cudaGetLastError();
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
