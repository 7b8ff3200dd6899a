// CRC-32C (Castagnoli; reflected polynomial 0x82F63B78), the checksum of
// the TFRecord framing.
//
// Two routes, picked once per process from what the CPU reports: the
// SSE4.2 crc32 instruction eight bytes at a time on x86-64, else
// slicing-by-8 tables (eight table lookups per eight bytes). Both give the
// same value for every input; the Python side masks it as TFRecord does.
//
// C ABI (ctypes):
//   uint32_t crc32c(const uint8_t* data, size_t n);   // init ~0, final xor ~0
//   uint32_t crc32c_tables(const uint8_t* data, size_t n);  // tables only

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

#if __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "crc32c.cpp reads 8-byte words as little-endian"
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables& tables() {
  static const Tables tab;
  return tab;
}

uint32_t update_tables(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = tables().t;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n; ++p, --n) crc = (crc >> 8) ^ t[0][(crc ^ *p) & 0xFF];
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t update_sse42(uint32_t crc,
                                                        const uint8_t* p,
                                                        size_t n) {
  uint64_t c = crc;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  for (; n; ++p, --n) c32 = _mm_crc32_u8(c32, *p);
  return c32;
}

bool has_sse42() {
  static const bool yes = __builtin_cpu_supports("sse4.2");
  return yes;
}
#endif

}  // namespace

extern "C" {

uint32_t crc32c(const uint8_t* data, size_t n) {
#if defined(__x86_64__)
  if (has_sse42()) return ~update_sse42(~0u, data, n);
#endif
  return ~update_tables(~0u, data, n);
}

uint32_t crc32c_tables(const uint8_t* data, size_t n) {
  return ~update_tables(~0u, data, n);
}

}  // extern "C"
