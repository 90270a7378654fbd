// Batched CRC-32C (K5) and the batch validator (K6) on Hopper.
//
// Replaces the JAX programs redpanda_tpu/ops/crc32c_device.py:84
// (make_crc_fn.crc_fn) and redpanda_tpu/ops/pipeline.py:53
// (make_batch_validator.validate). One kernel serves both: it computes the
// CRC-32C (Castagnoli, init and xorout 0xFFFFFFFF) of each row's first
// clip(len, 0, r) bytes, writes it when `crc_out` is given, and writes
// ok[i] = (crc == claimed[i]) && (len[i] > 0) -- the raw length, not the
// clipped one -- when `claimed` is given. Bytes past a row's length are
// never read.
//
// The same kernel serves the sharded checks of the mesh (K8,
// redpanda_tpu/parallel/collectives.py:124 make_crc_vote_step._local, and
// K9, :155 make_sharded_crc_check._local): given `bad_out` and a segment
// length `seg`, it also counts bad[row / seg] += 1 for every row whose
// length is > 0 and whose ok is false -- the JAX programs'
// sum(~ok & (lens > 0)) per partition. A row of length 0 (a padding row)
// is neither ok nor bad. The entry point zeroes bad_out on the launch's
// stream first; the count is one atomicAdd per bad row, and bad rows are
// rare.
//
// What bounds it on an H100: bytes. Each valid byte is read once; the
// work per byte is about 1.25 table lookups in shared memory. The TPU
// program multiplied a bit-unpacked [N, r*8] matrix by a 0/1 GF(2) matrix
// on the MXU and unwound the zero padding; here a table walk does the
// same arithmetic with no padding and no bit expansion.
//
// Design: one warp per row, coalesced. The row is cut into 16-byte blocks
// and lane k takes blocks k, k+32, k+64, ..., so each round the warp reads
// 512 contiguous bytes (16-byte loads where the row is aligned). CRC is
// linear over GF(2), so a lane keeps the CRC register of its own blocks
// with the other lanes' bytes taken as zero: before each of its blocks
// after the first it advances its register over the 496 bytes it skipped
// (a fixed linear map, four byte-sliced table lookups), then runs the
// block through slicing-by-8 twice. At the end each lane's register is
// advanced over the zero bytes between its last block and the row's end
// (a carry-less multiply by x^(8*gap) mod P, gap < 512, from a table) and
// the 32 registers are XORed together with shuffles. Lane 0 starts from
// 0xFFFFFFFF and the others from 0, so the XOR is the register of the
// whole row. The tables (slicing-by-8, the 496-byte skip, the powers)
// are built on the host (ops/crc32c_device.py) and staged in shared
// memory per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;
constexpr int kBlock = 16;              // bytes a lane takes per round
constexpr int kRound = 32 * kBlock;     // bytes the warp takes per round
constexpr int kSkipOff = 8 * 256;       // after the slicing-by-8 tables
constexpr int kPowOff = kSkipOff + 4 * 256;
constexpr int kTables = kPowOff + kRound;
constexpr uint32_t kPoly = 0x82F63B78u;  // reflected Castagnoli polynomial

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

// The register advanced over kRound - kBlock zero bytes.
__device__ __forceinline__ uint32_t skip(const uint32_t* t, uint32_t c) {
  const uint32_t* s = t + kSkipOff;
  return s[c & 0xff] ^ s[256 + ((c >> 8) & 0xff)] ^ s[512 + ((c >> 16) & 0xff)] ^
         s[768 + (c >> 24)];
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

__global__ void crc_kernel(const uint8_t* __restrict__ data, long long stride,
                           const int32_t* __restrict__ lens, int n, int r,
                           const uint32_t* __restrict__ tables, uint32_t* __restrict__ crc_out,
                           const uint32_t* __restrict__ claimed, uint8_t* __restrict__ ok_out,
                           int32_t* __restrict__ bad_out, int seg) {
  __shared__ uint32_t t[kTables];
  for (int i = threadIdx.x; i < kTables; i += blockDim.x) t[i] = tables[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += gridDim.x * kWarpsPerBlock) {
    const int raw = lens[row];
    const int len = raw < 0 ? 0 : (raw > r ? r : raw);
    const uint8_t* src = data + (long long)row * stride;
    const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    uint32_t acc = lane == 0 ? 0xFFFFFFFFu : 0u;
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
    // lanes without a block hold 0, which needs no advance
    const int gap = len - end;
    if (gap > 0 && acc != 0) acc = multmodp(t[kPowOff + gap], acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const uint32_t crc = acc ^ 0xFFFFFFFFu;
      if (crc_out != nullptr) crc_out[row] = crc;
      if (claimed != nullptr) {
        const bool ok = crc == claimed[row] && raw > 0;
        ok_out[row] = ok ? 1 : 0;
        if (bad_out != nullptr && raw > 0 && !ok) atomicAdd(&bad_out[row / seg], 1);
      }
    }
  }
}

}  // namespace

// bad_out (optional, with claimed): int32 [ceil(n / seg)] bad rows per
// segment of seg rows; nullptr skips the count.
extern "C" int rp_crc32c(const void* data, long long stride, const void* lens, int n, int r,
                         const void* tables, void* crc_out, const void* claimed, void* ok_out,
                         void* bad_out, int seg, void* stream) {
  if (n <= 0) return 0;
  if ((claimed == nullptr) != (ok_out == nullptr) || (crc_out == nullptr && ok_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bad_out != nullptr) {
    if (claimed == nullptr || seg <= 0) return (int)cudaErrorInvalidValue;
    const cudaError_t rc = cudaMemsetAsync(
        bad_out, 0, sizeof(int32_t) * (size_t)((n + seg - 1) / seg), (cudaStream_t)stream);
    if (rc != cudaSuccess) return (int)rc;
  }
  int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  crc_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, stride, (const int32_t*)lens, n, r, (const uint32_t*)tables,
      (uint32_t*)crc_out, (const uint32_t*)claimed, (uint8_t*)ok_out, (int32_t*)bad_out, seg);
  return (int)cudaGetLastError();
}
