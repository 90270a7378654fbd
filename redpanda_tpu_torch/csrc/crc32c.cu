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
// What bounds it on an H100: bytes. Each valid byte is read once; the
// work per byte is about 1.25 table lookups in shared memory. The TPU
// program multiplied a bit-unpacked [N, r*8] matrix by a 0/1 GF(2) matrix
// on the MXU and unwound the zero padding; here a table walk does the
// same arithmetic with no padding and no bit expansion.
//
// Design: one warp per row (the body is crc_row in csrc/crc32c.cuh, which
// the fused coproc step shares); the tables are staged in shared memory
// per block. The sharded checks of the mesh (K8, K9) and their bad counts
// are csrc/crc_blocks.cu's, which cuts long rows across warps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32c.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;

__global__ void crc_kernel(const uint8_t* __restrict__ data, long long stride,
                           const int32_t* __restrict__ lens, int n, int r,
                           const uint32_t* __restrict__ tables, uint32_t* __restrict__ crc_out,
                           const uint32_t* __restrict__ claimed, uint8_t* __restrict__ ok_out) {
  __shared__ uint32_t t[rp_crc::kTables];
  rp_crc::load_tables(t, tables);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += gridDim.x * kWarpsPerBlock) {
    const int raw = lens[row];
    const int len = raw < 0 ? 0 : (raw > r ? r : raw);
    const uint32_t crc = rp_crc::crc_row(t, data + (long long)row * stride, len, lane);
    if (lane == 0) {
      if (crc_out != nullptr) crc_out[row] = crc;
      if (claimed != nullptr) ok_out[row] = (crc == claimed[row] && raw > 0) ? 1 : 0;
    }
  }
}

}  // namespace

// crc_out (optional): uint32 [n] CRCs; claimed and ok_out (optional,
// together): uint32 [n] claimed CRCs and u8 [n] ok flags. One of the two
// outputs at least.
extern "C" int rp_crc32c(const void* data, long long stride, const void* lens, int n, int r,
                         const void* tables, void* crc_out, const void* claimed, void* ok_out,
                         void* stream) {
  if (n <= 0) return 0;
  if ((claimed == nullptr) != (ok_out == nullptr) || (crc_out == nullptr && ok_out == nullptr))
    return (int)cudaErrorInvalidValue;
  int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  crc_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, stride, (const int32_t*)lens, n, r, (const uint32_t*)tables,
      (uint32_t*)crc_out, (const uint32_t*)claimed, (uint8_t*)ok_out);
  return (int)cudaGetLastError();
}
