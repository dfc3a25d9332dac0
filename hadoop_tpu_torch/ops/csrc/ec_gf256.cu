// Reed-Solomon coding over GF(256) for Hopper (sm_90a), a plain C entry.
//
// Replaces `_apply_matrix` (hadoop_tpu/ops/ec_device.py:63), which
// reaches no pallas_call: XLA fuses its r·k·8 shift/and/multiply/xor
// terms into one elementwise pass over the stripe. Run eagerly in
// PyTorch, each of those ~4·r·k·8 operations is a launch of its own that
// reads and writes a whole [W] row (RS(6,3): ~576 launches an encode).
// Here they are one pass, and the GF(256) products come from tables.
//
// The arithmetic is the reference's, bit for bit: output byte i of a
// byte column is the XOR over data units j of gf_mul(M[i][j], b_j). The
// wrapper (ops/ec_device.py, `_tables`) builds, for each data unit j and
// each byte value b, one table entry of S 32-bit words: byte q of word g
// is gf_mul(M[4g + q][j], b) (0 past the last row), so one lookup gives
// the products of b with four rows of the matrix at once, G = ceil(r/4)
// words of them (S = G, or 4 for G = 3, so an entry is one 4-, 8- or
// 16-byte shared load). Tables [k][256][S] words, k·S KB: 6 KB for
// RS(6,3), 64 KB at most (k = r = 16).
//
// Design: the block copies the tables into shared memory once. Each
// thread takes 4 consecutive word columns, one 16-byte load per data
// unit (the next unit's load started before the current one is used).
// For each of the 16 data bytes it extracts the byte (__byte_perm), adds
// it to the unit's table base and loads the entry; entry word g is
// XORed into the accumulator of (group g, data word w, byte lane p).
// That accumulator's byte q is then byte p of output row 4g + q's word
// w: a 4x4 byte transpose per (g, w), eight __byte_perm, turns the lane
// accumulators into output words, written as one 16-byte store per row.
// (A grid of one row group per block row, each entry one word, reads
// the data words G times and measured slower on decode matrices.) A row
// not a multiple of 4 words, or an address not 16-byte aligned, takes
// 4-byte loads and stores instead (the odd cells' path). Columns are
// indexed in long long: a 128 MiB unit is 2^25 words, and [k, W] holds
// k·W of them.
//
// Bound: the floor of any implementation is bytes, (k + r)·4 B per word
// column (each data word read once, each output word written once) at
// the memory rate: RS(6,3) 36 B. This design's own count per word
// column: 4k shared loads of S words, and 4k·(2 + G) + 8G integer
// operations (extract, address, G XORs per lookup; the transposes), 80
// for RS(6,3) where the bit-term design did 32·k·r = 576. The integer
// units (64 a clock on each SM) then need less time than the bytes. The
// shared loads are the other limit: 4k·S words a column, 32 banks of 4
// bytes a clock on each SM at best; random bytes hit one bank from
// several lanes (about 3.5 ways for 32 random entries of a 1 KB table),
// and a warp's load is replayed once per extra way. At one row group
// (encode, r <= 4) the bytes bound it: its time on all-zero words (every
// lane reads one entry, no conflict) is its time on random words. At
// three (RS(10,4)'s decode, 16-byte entries) the conflicted table loads
// do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnits = 16;            // k and r at most (MAX_UNITS)

// words of one table entry for G groups of four output rows
template <int G>
__host__ __device__ constexpr int entry_words() { return G == 3 ? 4 : G; }

// entry b of one unit's table: S words into e[0..S)
template <int S>
__device__ __forceinline__ void lookup(const uint32_t* tab, uint32_t b,
                                       uint32_t (&e)[S]) {
  if constexpr (S == 1) {
    e[0] = tab[b];
  } else if constexpr (S == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(tab)[b];
    e[0] = v.x; e[1] = v.y;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(tab)[b];
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  }
}

// words [col, col + 4) of one row (zero past W)
__device__ __forceinline__ void load4(const uint32_t* row, long long col,
                                      long long W, bool vec,
                                      uint32_t (&d)[4]) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + col);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] = col + w < W ? row[col + w] : 0u;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
gf256_table_kernel(const uint32_t* __restrict__ data,
                   const uint32_t* __restrict__ tables,
                   uint32_t* __restrict__ out, long long W, int k, int r,
                   bool vec) {
  constexpr int S = entry_words<G>();
  extern __shared__ __align__(16) uint32_t tab[];      // [k][256][S]
  for (int t = threadIdx.x; t < k * 64 * S; t += kThreads)
    reinterpret_cast<uint4*>(tab)[t] =
        reinterpret_cast<const uint4*>(tables)[t];
  __syncthreads();
  const long long chunks = (W + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
       c < chunks; c += stride) {
    const long long col = c * 4;
    // acc[g][w][p]: byte q is byte p of output row 4g + q, word w
    uint32_t acc[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[g][w][p] = 0u;
    uint32_t cur[4];
    load4(data, col, W, vec, cur);
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      uint32_t nxt[4] = {0u, 0u, 0u, 0u};
      if (j + 1 < k) load4(data + (long long)(j + 1) * W, col, W, vec, nxt);
      const uint32_t* tj = tab + j * 256 * S;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t e[S];
          lookup<S>(tj, __byte_perm(cur[w], 0u, 0x4440u | p), e);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][w][p] ^= e[g];
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) cur[w] = nxt[w];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t o[4][4];             // o[q][w]: output row 4g + q, word w
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t* a = acc[g][w];
        // byte q of a[p] goes to byte p of o[q][w]
        const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140u);  // a0.0 a1.0 a0.1 a1.1
        const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362u);  // a0.2 a1.2 a0.3 a1.3
        const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140u);
        const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362u);
        o[0][w] = __byte_perm(t0, t2, 0x5410u);
        o[1][w] = __byte_perm(t0, t2, 0x7632u);
        o[2][w] = __byte_perm(t1, t3, 0x5410u);
        o[3][w] = __byte_perm(t1, t3, 0x7632u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * g + q;
        if (i >= r) break;
        uint32_t* row = out + (long long)i * W;
        if (vec) {
          *reinterpret_cast<uint4*>(row + col) =
              make_uint4(o[q][0], o[q][1], o[q][2], o[q][3]);
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (col + w < W) row[col + w] = o[q][w];
        }
      }
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int G>
int launch(const void* data, const void* tables, void* out, long long W,
           int k, int r, cudaStream_t st) {
  const size_t smem = (size_t)k * 256 * entry_words<G>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gf256_table_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gf256_table_kernel<G>, kThreads, smem)) != cudaSuccess)
    return (int)err;
  // one resident wave, each block striding over the columns
  const long long want = ((W + 3) / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < most ? want : most);
  const bool vec = W % 4 == 0 && aligned(data) && aligned(out);
  gf256_table_kernel<G><<<blocks, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(data),
      static_cast<const uint32_t*>(tables), static_cast<uint32_t*>(out), W,
      k, r, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [r, W] = the GF(256) matrix whose product tables are `tables`
// [k, 256, S] 32-bit words (S = 1, 2, 4, 4 for ceil(r/4) = 1, 2, 3, 4;
// ops/ec_device.py `_tables`) applied to data [k, W], on `stream`: 32-bit
// words, four bytes each, all three contiguous on the device, the tables
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success), or -1 for a k, r, W or table address it does not take.
int htpu_ec_gf256_apply(const void* data, const void* tables, void* out,
                        long long W, int k, int r, void* stream) {
  if (k < 1 || r < 1 || k > kMaxUnits || r > kMaxUnits || W < 0 ||
      !aligned(tables))
    return -1;
  if (W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((r + 3) / 4) {
    case 1: return launch<1>(data, tables, out, W, k, r, st);
    case 2: return launch<2>(data, tables, out, W, k, r, st);
    case 3: return launch<3>(data, tables, out, W, k, r, st);
    default: return launch<4>(data, tables, out, W, k, r, st);
  }
}

const char* htpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
