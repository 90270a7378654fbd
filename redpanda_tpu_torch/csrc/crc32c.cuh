// CRC-32C of one row by one warp: the device body shared by the fused
// coproc step (csrc/coproc_step.cu: K10) and the split CRC kernel
// (csrc/crc_blocks.cu: K5, K6, K8, K9), which cuts a long row into spans,
// one warp each (lane_walk, warp_xor), and joins them (multmodp, sliced).
//
// The row is cut into 16-byte blocks and lane k takes blocks k, k+32,
// k+64, ..., so each round the warp reads 512 contiguous bytes (16-byte
// loads where the row is aligned). CRC is linear over GF(2), so a lane
// keeps the CRC register of its own blocks with the other lanes' bytes
// taken as zero: before each of its blocks after the first it advances its
// register over the 496 bytes it skipped (a fixed linear map, four
// byte-sliced table lookups), then runs the block through slicing-by-8
// twice. At the end each lane's register is advanced over the zero bytes
// between its last block and the row's end (a carry-less multiply by
// x^(8*gap) mod P, gap < 512, from a table) and the 32 registers are XORed
// together with shuffles. Lane 0 starts from 0xFFFFFFFF and the others from
// 0, so the XOR is the register of the whole row. The tables
// (slicing-by-8, the 496-byte skip, the powers) are built on the host
// (ops/crc32c_device.py kernel_tables) and staged in shared memory per
// block. The split kernel moves a lane's register past its span's end by a
// carry-less multiply, x^(8m) for m < 512 from the staged powers and
// x^(8*512*q) from a table in global memory (ops/crc32c_device.py
// round_powers), and a register over a whole span with a byte-sliced table
// of that span's advance, as skip does over 496 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp_crc {

constexpr int kBlock = 16;              // bytes a lane takes per round
constexpr int kRound = 32 * kBlock;     // bytes the warp takes per round
constexpr int kSkipOff = 8 * 256;       // after the slicing-by-8 tables
constexpr int kPowOff = kSkipOff + 4 * 256;
constexpr int kTables = kPowOff + kRound;  // uint32 words of the staged tables
constexpr uint32_t kPoly = 0x82F63B78u;    // reflected Castagnoli polynomial

__device__ __forceinline__ uint32_t byte_step(const uint32_t* t, uint32_t c, uint32_t b) {
  return t[(c ^ b) & 0xff] ^ (c >> 8);
}

// Eight bytes (lo = bytes 0..3, hi = bytes 4..7, little-endian) at once.
__device__ __forceinline__ uint32_t step8(const uint32_t* t, uint32_t c, uint32_t lo, uint32_t hi) {
  c ^= lo;
  return t[7 * 256 + (c & 0xff)] ^ t[6 * 256 + ((c >> 8) & 0xff)] ^
         t[5 * 256 + ((c >> 16) & 0xff)] ^ t[4 * 256 + (c >> 24)] ^
         t[3 * 256 + (hi & 0xff)] ^ t[2 * 256 + ((hi >> 8) & 0xff)] ^
         t[1 * 256 + ((hi >> 16) & 0xff)] ^ t[hi >> 24];
}

// The register advanced over a fixed run of zero bytes, read from its
// byte-sliced table s (4 x 256 words: a linear map, one lookup a byte).
__device__ __forceinline__ uint32_t sliced(const uint32_t* s, uint32_t c) {
  return s[c & 0xff] ^ s[256 + ((c >> 8) & 0xff)] ^ s[512 + ((c >> 16) & 0xff)] ^
         s[768 + (c >> 24)];
}

// The register advanced over kRound - kBlock zero bytes.
__device__ __forceinline__ uint32_t skip(const uint32_t* t, uint32_t c) {
  return sliced(t + kSkipOff, c);
}

// a * b mod P in the reflected representation (bit 31 is x^0).
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    if (a & (0x80000000u >> k)) p ^= b;
    b = (b & 1) ? (b >> 1) ^ kPoly : (b >> 1);
  }
  return p;
}

// Stage the kTables words of `tables` in the block's shared memory `t`.
// Every thread of the block calls it (it ends in __syncthreads).
__device__ __forceinline__ void load_tables(uint32_t* t, const uint32_t* __restrict__ tables) {
  for (int i = threadIdx.x; i < kTables; i += blockDim.x) t[i] = tables[i];
  __syncthreads();
}

// The calling lane's part of the warp's walk over src[0, len): the
// register of its own blocks, started from `init` at lane 0 and from 0
// elsewhere, and in `gap` the zero bytes from its last block's end to len
// (a lane without a block holds 0, or lane 0's init at len 0).
__device__ __forceinline__ uint32_t lane_walk(const uint32_t* t, const uint8_t* __restrict__ src,
                                              int len, int lane, uint32_t init, int& gap) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  uint32_t acc = lane == 0 ? init : 0u;
  int end = 0;  // end of this lane's last block
  for (int p = lane * kBlock; p < len; p += kRound) {
    if (p >= kRound) acc = skip(t, acc);  // the other lanes' 496 bytes
    if (p + kBlock <= len) {
      uint32_t w[4];
      if (aligned) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + p));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint8_t* q = src + p + 4 * k;
          w[k] = (uint32_t)q[0] | ((uint32_t)q[1] << 8) | ((uint32_t)q[2] << 16) |
                 ((uint32_t)q[3] << 24);
        }
      }
      acc = step8(t, acc, w[0], w[1]);
      acc = step8(t, acc, w[2], w[3]);
      end = p + kBlock;
    } else {
      for (int q = p; q < len; ++q) acc = byte_step(t, acc, src[q]);
      end = len;
    }
  }
  gap = len - end;
  return acc;
}

// The XOR of the warp's 32 lane registers; every lane gets it.
__device__ __forceinline__ uint32_t warp_xor(uint32_t acc) {
#pragma unroll
  for (int off = 16; off; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The CRC-32C (init and xorout 0xFFFFFFFF) of src[0, len) by the calling
// warp; every lane gets it. len is already clipped to [0, r].
__device__ __forceinline__ uint32_t crc_row(const uint32_t* t, const uint8_t* __restrict__ src,
                                            int len, int lane) {
  int gap;
  uint32_t acc = lane_walk(t, src, len, lane, 0xFFFFFFFFu, gap);
  // lanes without a block hold 0, which needs no advance
  if (gap > 0 && acc != 0) acc = multmodp(t[kPowOff + gap], acc);
  return warp_xor(acc) ^ 0xFFFFFFFFu;
}

}  // namespace rp_crc
