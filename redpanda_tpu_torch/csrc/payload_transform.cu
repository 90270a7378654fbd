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
// Design (chip_tools/payload_ablation.py measured the first one, a warp a
// row that staged its row, scanned it and exited: its load alone took a
// third of the launch, and the filter's byte-at-a-time scan as much again):
//   - a persistent grid, sized from the SM count and the kernel's
//     occupancy: each warp walks rows i, i + W, ... (W warps in all)
//     through a ring of two stages in its shared memory, the next row
//     arriving by cp.async while the current one is scanned, so every warp
//     keeps a row in flight;
//   - every row is copied in 16-byte pieces from the 16-byte boundary at
//     or below its start, whatever its alignment (engine rows are staged at
//     a stride of 1160, so every other row is only 8-byte aligned), its
//     offset inside the stage kept in a register. Rounding the start down
//     and the end up reads up to 15 bytes outside the row: inside the
//     launch's rows those are its own meta or a neighbour's bytes, and a
//     piece that reaches before the first row or past the last row's end
//     is read byte by byte instead;
//   - the scan takes sixteen starts a lane, 512 a window, with a
//     zero-byte test on the pattern's first two bytes, four starts an
//     instruction (csrc/payload_transform.cuh find_pattern); the Int parse
//     is warp-parallel; map_uppercase maps four bytes a lane at a time.
// The body (transform_staged) is shared with the fused coproc step.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "payload_transform.cuh"

namespace {

constexpr int kWarps = 8;  // warps a CTA at most
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the `need` bytes at g into `stage`: the 16-byte pieces
// from the boundary at or below g, each by cp.async when it lies inside
// the launch's rows [lo, hi), else byte by byte (only the first and last
// rows' pieces can reach outside).
__device__ __forceinline__ void stage_row(uint8_t* stage, const uint8_t* g, int need,
                                          const uint8_t* lo, const uint8_t* hi, int lane) {
  const uint8_t* a0 = g - (reinterpret_cast<uintptr_t>(g) & 15);
  const int pieces = (int)((g + need - a0 + 15) >> 4);
  if (a0 >= lo && a0 + 16 * pieces <= hi) {  // every row but the launch's first and last
    for (int c = lane; c < pieces; c += 32) cp_async16(stage + 16 * c, a0 + 16 * c);
    return;
  }
  for (int c = lane; c < pieces; c += 32) {
    const uint8_t* s = a0 + 16 * c;
    uint8_t* d = stage + 16 * c;
    if (s >= lo && s + 16 <= hi) {
      cp_async16(d, s);
    } else {
      for (int b = 0; b < 16; ++b)
        if (s + b >= lo && s + b < hi) d[b] = s[b];
    }
  }
}

__global__ void payload_kernel(const uint8_t* __restrict__ in, long long in_stride,
                               const int32_t* __restrict__ lens, int n, int r_in,
                               uint8_t* __restrict__ out, long long out_stride,
                               int32_t* __restrict__ out_len, uint8_t* __restrict__ keep_out,
                               int r_out, int mask_len, const int32_t* __restrict__ desc,
                               int n_filters, int mapper, int n_fields,
                               const uint8_t* __restrict__ pats, int stage, int stages,
                               int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  uint8_t* ring = smem + warp * per_warp;
  uint8_t* orow = ring + stages * stage;
  const int need = r_in + (lens == nullptr ? 4 : 0);  // a packed row's length follows it
  const uint8_t* hi = in + (long long)(n - 1) * in_stride + need;
  const long long step = (long long)gridDim.x * wpb;
  long long i = (long long)blockIdx.x * wpb + warp;
  int len = lens != nullptr && i < n ? lens[i] : 0;
  if (stages == 2 && i < n) stage_row(ring, in + i * in_stride, need, in, hi, lane);
  cp_commit();
  for (int t = 0; i < n; i += step, ++t) {  // uniform per warp
    const uint8_t* g = in + i * in_stride;
    uint8_t* cur = ring + (t & (stages - 1)) * stage;
    const bool more = i + step < n;
    const int next_len = lens != nullptr && more ? lens[i + step] : 0;
    if (stages == 2) {  // the next row arrives while this one is scanned
      if (more) stage_row(ring + ((t + 1) & 1) * stage, g + step * in_stride, need, in, hi, lane);
      cp_commit();
      cp_wait<1>();
    } else {
      stage_row(cur, g, need, in, hi, lane);
      cp_commit();
      cp_wait<0>();
    }
    __syncwarp();
    uint8_t* row = cur + (reinterpret_cast<uintptr_t>(g) & 15);
    if (lens == nullptr) {
      const uint8_t* m = row + r_in;  // LE32 length in the meta columns
      len = (int)((uint32_t)m[0] | ((uint32_t)m[1] << 8) | ((uint32_t)m[2] << 16) |
                  ((uint32_t)m[3] << 24));
      __syncwarp();  // map_uppercase rewrites the word that holds it
    }
    rp_payload::transform_staged(row, len, orow, r_in, out + i * out_stride,
                                 out_len == nullptr ? nullptr : out_len + i,
                                 keep_out == nullptr ? nullptr : keep_out + i, r_out, mask_len,
                                 desc, n_filters, mapper, n_fields, pats, lane);
    len = next_len;
    __syncwarp();  // the stage and orow are the next rows'
  }
}

// CTAs of wpb warps and smem bytes that fit on the current device at once
// (cached for the last shape asked on each device).
int resident_ctas(int wpb, int smem, int* out) {
  static std::atomic<unsigned long long> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long key = ((unsigned long long)smem << 8 | (unsigned)wpb) << 32;
  if (dev >= 0 && dev < kMaxDevices) {
    const unsigned long long got = cache[dev].load();
    if (got >> 32 == key >> 32 && (got & 0xffffffffu) > 0) {
      *out = (int)(got & 0xffffffffu);
      return 0;
    }
  }
  if ((size_t)smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, payload_kernel, 32 * wpb, smem);
  if (e != cudaSuccess) return (int)e;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices) cache[dev].store(key | (unsigned)*out);
  return 0;
}

}  // namespace

// The transform over n rows at in (r_in bytes each, in_stride apart). With
// lens null, row i's LE32 length lies in its meta columns at r_in and the
// output is packed rows (out_stride apart: r_out bytes, then the meta);
// else lens i32 [n] and the outputs out (out_stride apart), out_len i32
// [n] and keep u8 [n]. desc / pats / n_filters / mapper / n_fields are the
// transform program's (ops/transforms.py TransformProgram).
extern "C" int rp_payload_transform(const void* in, long long in_stride, const void* lens, int n,
                                    int r_in, void* out, long long out_stride, void* out_len,
                                    void* keep, int r_out, int mask_len, const void* desc,
                                    int n_filters, int mapper, int n_fields, const void* pats,
                                    void* stream) {
  if (n <= 0) return 0;
  if (r_in < 1 || r_out < 0 || in_stride < 0 || out_stride < 0 ||
      (lens != nullptr && (out_len == nullptr || keep == nullptr)))
    return (int)cudaErrorInvalidValue;
  // a stage holds the row from the 16-byte boundary below its start, its
  // length, and the scan's slack
  const int stage = rp_payload::row_bytes(r_in + (lens == nullptr ? 4 : 0) + 15);
  const int orow = rp_payload::out_row_bytes(r_out, mapper);
  int stages = 2;
  if ((size_t)(2 * stage + orow) > kMaxSmem) stages = 1;  // rows too wide for a ring
  const int per_warp = stages * stage + orow;
  if ((size_t)per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int wpb = (int)(kDefaultSmem / per_warp);  // several CTAs an SM where the rows allow
  wpb = wpb < 1 ? 1 : (wpb > kWarps ? kWarps : wpb);
  const int smem = per_warp * wpb;
  int cap = 0;
  const int e = resident_ctas(wpb, smem, &cap);
  if (e != 0) return e;
  long long blocks = ((long long)n + wpb - 1) / wpb;
  if (blocks > cap) blocks = cap;  // the warps walk the rest
  payload_kernel<<<(unsigned)blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_stride, (const int32_t*)lens, n, r_in, (uint8_t*)out, out_stride,
      (int32_t*)out_len, (uint8_t*)keep, r_out, mask_len, (const int32_t*)desc, n_filters, mapper,
      n_fields, (const uint8_t*)pats, stage, stages, per_warp);
  return (int)cudaGetLastError();
}
