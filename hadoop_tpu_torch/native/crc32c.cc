// Bulk CRC32C (Castagnoli) for the storage data plane.
//
// The port's copy of hadoop_tpu/native/src/crc32c.cc, the same C ABI:
// every storage packet carries one u32 CRC per 512-byte chunk and is
// verified at every pipeline hop, so this is the hottest byte-level loop
// of the DFS client.
//
// Two backends, chosen once at load time:
//   * SSE4.2 `crc32` instruction (x86) -- 8 bytes/insn
//   * slice-by-8 table walk -- portable
// Built at first use with the host C++ compiler and loaded with ctypes by
// hadoop_tpu_torch/util/crc.py.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli

uint32_t g_table[8][256];

struct TableInit {
  TableInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      g_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        g_table[s][i] =
            (g_table[s - 1][i] >> 8) ^ g_table[0][g_table[s - 1][i] & 0xFF];
  }
} g_table_init;

uint32_t crc_sliced(uint32_t crc, const uint8_t* p, size_t len) {
  crc = ~crc;
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;
    crc = g_table[7][w & 0xFF] ^ g_table[6][(w >> 8) & 0xFF] ^
          g_table[5][(w >> 16) & 0xFF] ^ g_table[4][(w >> 24) & 0xFF] ^
          g_table[3][(w >> 32) & 0xFF] ^ g_table[2][(w >> 40) & 0xFF] ^
          g_table[1][(w >> 48) & 0xFF] ^ g_table[0][(w >> 56) & 0xFF];
    p += 8;
    len -= 8;
  }
  while (len--) crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_hw(uint32_t crc,
                                                  const uint8_t* p,
                                                  size_t len) {
  uint64_t c = ~crc;
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    len -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (len--) c32 = _mm_crc32_u8(c32, *p++);
  return ~c32;
}

bool have_sse42() { return __builtin_cpu_supports("sse4.2"); }
#endif

using CrcFn = uint32_t (*)(uint32_t, const uint8_t*, size_t);

CrcFn pick_backend() {
#if defined(__x86_64__)
  if (have_sse42()) return crc_hw;
#endif
  return crc_sliced;
}

CrcFn g_crc = pick_backend();

inline void put_be32(uint8_t* out, uint32_t v) {
  out[0] = v >> 24;
  out[1] = v >> 16;
  out[2] = v >> 8;
  out[3] = v;
}

inline uint32_t get_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

uint32_t htpu_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
  return g_crc(crc, data, len);
}

// Compute one big-endian u32 CRC per `bytes_per_chunk` chunk of `data`
// into `out_sums` (ref: DataChecksum.calculateChunkedSums). One ctypes
// call per packet instead of one per chunk.
void htpu_crc32c_chunked(const uint8_t* data, size_t len,
                         size_t bytes_per_chunk, uint8_t* out_sums) {
  size_t off = 0, i = 0;
  while (off < len) {
    size_t n = len - off < bytes_per_chunk ? len - off : bytes_per_chunk;
    put_be32(out_sums + 4 * i, g_crc(0, data + off, n));
    off += n;
    i++;
  }
}

// Verify chunked sums; returns -1 if all match, else the index of the
// first corrupt chunk (ref: DataChecksum.verifyChunkedSums,
// bulk_crc32.c bulk_verify_crc).
int64_t htpu_crc32c_verify(const uint8_t* data, size_t len,
                           size_t bytes_per_chunk, const uint8_t* sums) {
  size_t off = 0, i = 0;
  while (off < len) {
    size_t n = len - off < bytes_per_chunk ? len - off : bytes_per_chunk;
    if (g_crc(0, data + off, n) != get_be32(sums + 4 * i))
      return static_cast<int64_t>(i);
    off += n;
    i++;
  }
  return -1;
}

}  // extern "C"
