// The v1 payload transform (K3) and its packed pipeline (K4) on Hopper.
//
// Replaces the JAX programs redpanda_tpu/ops/transforms.py:378
// (_compile_cached.fn: _find_pattern, _gather_window, _parse_int_at,
// _find_byte_from) and redpanda_tpu/ops/pipeline.py:73
// (_packed_pipeline_cached.run) / :100 (_record_pipeline_cached.run). One
// kernel serves all three: the input row either carries its LE32 length in
// trailing meta columns (packed) or the lengths come as their own array,
// and the output is either packed rows with the masked LE32 out_len, the
// keep byte and 3 zero bytes, or separate out / out_len / keep arrays.
//
// What bounds it on an H100: bytes. At the engine's bench shape a launch
// reads 32768 staged rows of 1160 B (38 MB) and writes 32768 x 78 B
// (2.6 MB), about 12 us at 3.35 TB/s; the work per byte is a few byte
// compares per pattern. The TPU program compared every pattern at every
// row offset as dense [N, r] masks; here the per-row scan stops at the
// first valid match, so the compares the data needs are far fewer.
//
// Design: one warp per row (the body is transform_row in
// csrc/payload_transform.cuh, which the fused coproc step shares), staged
// in shared memory. A simple kernel first: no TMA, no overlap of one row's
// load with the next row's scan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "payload_transform.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into

__global__ void payload_kernel(const uint8_t* __restrict__ in, long long in_stride,
                               const int32_t* __restrict__ lens, int n, int r_in,
                               uint8_t* __restrict__ out, long long out_stride,
                               int32_t* __restrict__ out_len, uint8_t* __restrict__ keep_out,
                               int r_out, int mask_len, const int32_t* __restrict__ desc,
                               int n_filters, int mapper, int n_fields,
                               const uint8_t* __restrict__ pats, int per_warp, int wpb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // uniform per warp: the warp collectives stay full
  uint8_t* row = smem + warp * per_warp;
  const uint8_t* g = in + i * in_stride;
  int len;
  if (lens != nullptr) {
    len = lens[i];
  } else {
    const uint8_t* m = g + r_in;  // LE32 length in the meta columns
    len = (int)((uint32_t)m[0] | ((uint32_t)m[1] << 8) | ((uint32_t)m[2] << 16) |
                ((uint32_t)m[3] << 24));
  }
  rp_payload::transform_row(g, len, row, row + rp_payload::align16(r_in), r_in,
                            out + i * out_stride, out_len == nullptr ? nullptr : out_len + i,
                            keep_out == nullptr ? nullptr : keep_out + i, r_out, mask_len, desc,
                            n_filters, mapper, n_fields, pats, lane);
}

}  // namespace

extern "C" int rp_payload_transform(const void* in, long long in_stride, const void* lens, int n,
                                    int r_in, void* out, long long out_stride, void* out_len,
                                    void* keep, int r_out, int mask_len, const void* desc,
                                    int n_filters, int mapper, int n_fields, const void* pats,
                                    void* stream) {
  if (n <= 0) return 0;
  int per_warp = rp_payload::smem_per_warp(r_in, r_out, mapper);
  if ((size_t)per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int wpb = (int)(kDefaultSmem / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
  size_t smem = (size_t)per_warp * wpb;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + wpb - 1) / wpb;
  payload_kernel<<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_stride, (const int32_t*)lens, n, r_in, (uint8_t*)out, out_stride,
      (int32_t*)out_len, (uint8_t*)keep, r_out, mask_len, (const int32_t*)desc, n_filters, mapper,
      n_fields, (const uint8_t*)pats, per_warp, wpb);
  return (int)cudaGetLastError();
}
