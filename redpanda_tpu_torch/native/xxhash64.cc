// XXH64 (xxHash 0.8) over one buffer, for the port's rpc payload checksum.
// The machine with the card has no xxhash package, and the plain-Python
// XXH64 in hashing/xx.py takes ~0.3 s a MiB; a raft append of 256 KiB is
// hashed once on each side of the wire. Built with g++ by hashing/xx.py
// (_native_xxh64) into the port's build directory; same result as
// hashing.xx.xxhash64 for every input and seed.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian host (x86-64, aarch64)
  return v;
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t round64(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  return rotl(acc, 31) * P1;
}

inline uint64_t merge64(uint64_t h, uint64_t v) {
  h ^= round64(0, v);
  return h * P1 + P4;
}

}  // namespace

extern "C" uint64_t rp_xxh64(const uint8_t* b, size_t n, uint64_t seed) {
  const uint8_t* p = b;
  const uint8_t* end = b + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, read64(p));
      v2 = round64(v2, read64(p + 8));
      v3 = round64(v3, read64(p + 16));
      v4 = round64(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= round64(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}
