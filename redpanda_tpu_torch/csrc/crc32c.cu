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
// Design: one warp per row (the body is crc_row in csrc/crc32c.cuh, which
// the fused coproc step shares); the tables are staged in shared memory
// per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32c.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;

__global__ void crc_kernel(const uint8_t* __restrict__ data, long long stride,
                           const int32_t* __restrict__ lens, int n, int r,
                           const uint32_t* __restrict__ tables, uint32_t* __restrict__ crc_out,
                           const uint32_t* __restrict__ claimed, uint8_t* __restrict__ ok_out,
                           int32_t* __restrict__ bad_out, int seg) {
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
