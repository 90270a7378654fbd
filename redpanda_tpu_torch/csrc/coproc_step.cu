// The per-tick coproc step of the partition mesh (K10) on Hopper: the batch
// validator, the payload transform and the vote tally of a card's shards
// in one launch.
//
// Replaces the JAX program redpanda_tpu/parallel/collectives.py:71
// (make_sharded_coproc_step._local: per device, the batch validator over
// its [P/D, B, r_batch] batch rows, the v1 payload transform over its
// [P/D, N, r_rec] record rows, and the psum of its [P/D, G] votes). The JAX
// program is one shard_map, one program per device; here it is one launch
// per card (parallel/collectives.py make_sharded_coproc_step), on the
// caller's current stream, over every shard block that card holds.
//
// The launch reads its inputs through a table of block pointers passed by
// value in its parameters: six a shard (batch rows, batch lengths, claimed
// CRCs, record rows, record lengths, votes), 480 pointers in all (3840 B,
// inside the classic 4 KB parameter space with the other arguments), so a
// launch takes at most 80 shards and the wrapper cuts a card's shards into
// chunks of that many. Every block of one kind has one shape. The outputs
// are contiguous over the launch's shards in table order: ok [n_blocks *
// rows_b], out [n_blocks * rows_r, r_out], out_len and keep [n_blocks *
// rows_r], and the int32 [G] column sums of all the launch's votes.
//
// What bounds it on an H100: bytes -- the valid batch bytes, each record
// row and the output rows, read or written once. At chip_smoke.py's full
// width (64 partitions x 4 batches of ~16 KB, 64 x 512 records of 1152 B)
// that is about 40 MB, some 12 us at 3.35 TB/s; the host's enqueue work
// around the launches, not the device, set the step's time before. The
// design makes the step one launch with a grid split by role, so the three
// programs of a tick share the card's SMs instead of running one after the
// other:
//   - CTAs [0, A) validate the batch rows, one warp per row (crc_row of
//     csrc/crc32c.cuh), with the CRC slicing tables staged once per CTA in
//     shared memory; they come first, as they hold the longest rows;
//   - CTAs [A, A + T) run the transform over the record rows, one warp per
//     row staged in shared memory (transform_row of
//     csrc/payload_transform.cuh), writing the unmasked out_len, as the JAX
//     package's compile_transform returns it;
//   - the last ceil(G / 256) CTAs sum the votes, one thread per column over
//     every row of every block, coalesced across the columns (the body of
//     csrc/vote_tally.cuh, which the vote tally and the CRC + vote step
//     share).
// A CTA's dynamic shared memory is the larger of the two first roles'
// needs. Every row is independent and integer sums are exact, so the
// result is bit-identical to the plain version in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32c.cuh"
#include "payload_transform.cuh"
#include "vote_tally.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kThreads == rp_vote::kThreads, "a tally CTA is one CTA of this kernel");
constexpr int kPtrsPerShard = 6;
constexpr int kMaxPtrs = 480;  // 80 shards: 3840 B of parameters
constexpr int kMaxValidateCtas = 4096;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into

enum Slot : int { B_ROWS = 0, B_LENS, CLAIMED, R_ROWS, R_LENS, VOTES };

struct Table {
  const void* p[kMaxPtrs];
};

template <typename T>
__device__ __forceinline__ const T* slot(const Table& t, long long block, int s) {
  return static_cast<const T*>(t.p[block * kPtrsPerShard + s]);
}

__global__ void __launch_bounds__(kThreads)
coproc_step_kernel(const __grid_constant__ Table table, int n_blocks, int a_ctas, int t_ctas,
                   int rows_b, int r_batch, const uint32_t* __restrict__ crc_tables,
                   uint8_t* __restrict__ ok, int rows_r, int r_rec, uint8_t* __restrict__ out,
                   int32_t* __restrict__ out_len, uint8_t* __restrict__ keep, int r_out,
                   const int32_t* __restrict__ desc, int n_filters, int mapper, int n_fields,
                   const uint8_t* __restrict__ pats, int per_warp, int wpb, int vote_rows,
                   int g, int32_t* __restrict__ tally) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int cta = blockIdx.x;
  if (cta < a_ctas) {  // the batch validator (K6)
    uint32_t* t = reinterpret_cast<uint32_t*>(smem);
    rp_crc::load_tables(t, crc_tables);
    const long long total = (long long)n_blocks * rows_b;
    for (long long i = (long long)cta * kWarps + warp; i < total;
         i += (long long)a_ctas * kWarps) {
      const long long b = i / rows_b;
      const int k = (int)(i - b * rows_b);
      const int raw = slot<int32_t>(table, b, B_LENS)[k];
      const int len = raw < 0 ? 0 : (raw > r_batch ? r_batch : raw);
      const uint8_t* src = slot<uint8_t>(table, b, B_ROWS) + (long long)k * r_batch;
      const uint32_t crc = rp_crc::crc_row(t, src, len, lane);
      if (lane == 0)
        ok[i] = (crc == slot<uint32_t>(table, b, CLAIMED)[k] && raw > 0) ? 1 : 0;
    }
    return;
  }
  cta -= a_ctas;
  if (cta < t_ctas) {  // the payload transform (K3), unmasked out_len
    if (warp >= wpb) return;  // uniform per warp
    const long long i = (long long)cta * wpb + warp;
    if (i >= (long long)n_blocks * rows_r) return;
    const long long b = i / rows_r;
    const int k = (int)(i - b * rows_r);
    uint8_t* row = smem + warp * per_warp;
    rp_payload::transform_row(slot<uint8_t>(table, b, R_ROWS) + (long long)k * r_rec,
                              slot<int32_t>(table, b, R_LENS)[k], row,
                              row + rp_payload::row_bytes(r_rec), r_rec, out + i * r_out,
                              out_len + i, keep + i, r_out, /*mask_len=*/0, desc, n_filters,
                              mapper, n_fields, pats, lane);
    return;
  }
  cta -= t_ctas;  // the vote tally (K7) of this launch's shards
  rp_vote::tally_columns<uint8_t>(table.p + VOTES, kPtrsPerShard, n_blocks, vote_rows, g, cta,
                                  tally);
}

}  // namespace

// One step over n_blocks shards (1..80) of one card: `table` is a host
// array of 6 * n_blocks device pointers, shard b's at [6 b, 6 b + 6):
// batch rows u8 [rows_b, r_batch], batch lengths i32 [rows_b], claimed
// CRCs u32 [rows_b], record rows u8 [rows_r, r_rec], record lengths i32
// [rows_r] and votes u8 [vote_rows, g]. Writes ok u8 [n_blocks * rows_b],
// out u8 [n_blocks * rows_r, r_out], out_len i32 and keep u8 [n_blocks *
// rows_r], and tally i32 [g]. desc / pats / n_filters / mapper / n_fields
// are the transform program's (ops/transforms.py TransformProgram) and
// crc_tables the CRC kernel's (ops/crc32c_device.py kernel_tables).
extern "C" int rp_coproc_step(const void* const* table, int n_blocks, int rows_b, int r_batch,
                              const void* crc_tables, void* ok, int rows_r, int r_rec, void* out,
                              void* out_len, void* keep, int r_out, const void* desc,
                              int n_filters, int mapper, int n_fields, const void* pats,
                              int vote_rows, int g, void* tally, void* stream) {
  if (n_blocks < 1 || n_blocks * kPtrsPerShard > kMaxPtrs || rows_b < 0 || rows_r < 0 ||
      vote_rows < 0 || g < 0 || r_batch < 0 || r_rec < 1 || r_out < 0)
    return (int)cudaErrorInvalidValue;
  const int per_warp = rp_payload::smem_per_warp(r_rec, r_out, mapper);
  if ((size_t)per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int wpb = (int)(kDefaultSmem / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > kWarps ? kWarps : wpb);
  const long long total_b = (long long)n_blocks * rows_b;
  const long long total_r = (long long)n_blocks * rows_r;
  long long a = (total_b + kWarps - 1) / kWarps;
  if (a > kMaxValidateCtas) a = kMaxValidateCtas;  // the validator strides over the rest
  const long long t = (total_r + wpb - 1) / wpb;
  const long long v = ((long long)g + rp_vote::kThreads - 1) / rp_vote::kThreads;
  if (a + t + v == 0) return 0;
  if (a + t + v > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)per_warp * wpb;
  const size_t crc_smem = sizeof(uint32_t) * rp_crc::kTables;
  if (a > 0 && smem < crc_smem) smem = crc_smem;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        coproc_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Table tab = {};
  for (int k = 0; k < n_blocks * kPtrsPerShard; ++k) tab.p[k] = table[k];
  coproc_step_kernel<<<(unsigned)(a + t + v), kThreads, smem, (cudaStream_t)stream>>>(
      tab, n_blocks, (int)a, (int)t, rows_b, r_batch, (const uint32_t*)crc_tables,
      (uint8_t*)ok, rows_r, r_rec, (uint8_t*)out, (int32_t*)out_len, (uint8_t*)keep, r_out,
      (const int32_t*)desc, n_filters, mapper, n_fields, (const uint8_t*)pats, per_warp, wpb,
      vote_rows, g, (int32_t*)tally);
  return (int)cudaGetLastError();
}
