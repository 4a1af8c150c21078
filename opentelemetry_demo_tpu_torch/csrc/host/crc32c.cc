// CRC-32C (Castagnoli polynomial 0x82F63B78, reflected) on the host: the
// checksum of every verified frame (runtime/frame.py), so a checkpoint's
// trailer and column checks run at memory rate instead of a Python byte
// loop. The same function as the reference's native ingest library
// (opentelemetry_demo_tpu/native/ingest.cc, crc32c_sw and crc32c_hw):
// slicing-by-8 tables, and the SSE4.2 crc32 instruction where the CPU has
// it (the instruction computes this very polynomial, so both paths give
// the same bits). The frame module builds this file with the host C++
// compiler at first use and binds crc32c_update with ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const Crc32cTable kTable;

uint32_t crc32c_sw(uint32_t seed, const uint8_t* p, size_t n) {
  uint32_t c = ~seed;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = kTable.t[7][c & 0xFF] ^ kTable.t[6][(c >> 8) & 0xFF] ^
        kTable.t[5][(c >> 16) & 0xFF] ^ kTable.t[4][c >> 24] ^
        kTable.t[3][hi & 0xFF] ^ kTable.t[2][(hi >> 8) & 0xFF] ^
        kTable.t[1][(hi >> 16) & 0xFF] ^ kTable.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = kTable.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t seed,
                                                     const uint8_t* p,
                                                     size_t n) {
  uint32_t c = ~seed;
#if defined(__x86_64__)
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c64 = __builtin_ia32_crc32di(c64, v);
    p += 8;
    n -= 8;
  }
  c = uint32_t(c64);
#endif
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return ~c;
}
bool crc32c_hw_available() { return __builtin_cpu_supports("sse4.2"); }
#else
uint32_t crc32c_hw(uint32_t seed, const uint8_t* p, size_t n) {
  return crc32c_sw(seed, p, n);
}
bool crc32c_hw_available() { return false; }
#endif

const bool kHw = crc32c_hw_available();

}  // namespace

extern "C" {

// CRC-32C of p[0:n], continuing from ``seed`` (0 to start).
uint32_t crc32c_update(const uint8_t* p, size_t n, uint32_t seed) {
  return kHw ? crc32c_hw(seed, p, n) : crc32c_sw(seed, p, n);
}

// 1 when the SSE4.2 instruction computes the checksum, 0 for the tables.
int crc32c_uses_hw() { return kHw ? 1 : 0; }

}  // extern "C"
