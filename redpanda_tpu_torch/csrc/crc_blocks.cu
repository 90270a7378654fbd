// The split CRC-32C kernel on Hopper: the batch CRC (K5), the batch
// validator (K6), the sharded CRC check (K9) and the CRC + vote step (K8)
// of the partition mesh, one launch per card over a table of its blocks.
//
// Replaces the JAX programs redpanda_tpu/ops/crc32c_device.py:84
// (make_crc_fn.crc_fn: the CRC-32C, init and xorout 0xFFFFFFFF, of each
// row's first clip(len, 0, r) bytes), redpanda_tpu/ops/pipeline.py:53
// (make_batch_validator.validate: ok = crc == claimed && len > 0, the raw
// length), redpanda_tpu/parallel/collectives.py:155
// (make_sharded_crc_check._local: per device, the batch validator over its
// [P/D, B, r] rows and bad = sum(~ok & (lens > 0)) over each partition's B
// rows) and :124 (make_crc_vote_step._local: the same, and the psum of the
// [., G] votes). K5 and K6 are the one-block case (ops/crc32c_device.py
// crc32c_rows, validate_rows), launched through rp_crc_rows, which takes
// the block's pointers as arguments instead of a host table (the table and
// its arguments cost their calls about 10 us of the host's time a launch);
// so is the validator with a bad count per segment of rows
// (validate_segments). The JAX mesh programs are one
// shard_map each, one program per device, and here each is one launch per
// card (parallel/collectives.py), on the caller's current stream, over
// every shard block that card holds. Bytes past a row's length are never
// read.
//
// The launch reads its inputs through a table of block pointers passed by
// value: four a shard (rows u8 [rows, r] at a stride of r, lengths i32
// [rows], claimed CRCs i32 [rows] or none, votes u8 [vote_rows, G]), 480 in
// all (3840 B, inside the classic 4 KB parameter space with the other
// arguments), so a launch takes at most 120 shards and the wrapper cuts a
// card's shards into chunks of that many. The outputs are contiguous over
// the launch's shards in table order, each optional: crc u32 [n_blocks *
// rows]; ok u8 [n_blocks * rows], with the claims; bad int32 [n_bad],
// bad[i / seg] += 1 for every row i of length > 0 whose ok is false (zeroed
// here first, on the launch's stream; one atomicAdd per bad row, and bad
// rows are rare); and for K8 the int32 [G] column sums of all the launch's
// votes.
//
// What bounds it on an H100: each valid byte is read once and costs about
// 1.25 table lookups in shared memory (slicing-by-8 and the 496-byte skip,
// csrc/crc32c.cuh), so the bytes over 3.35 TB/s and the lookups over the
// SMs' shared-memory ports are the two limits; at the port's shapes the
// chain of dependent steps a row takes (staging, loads, lookups, the
// joins' carry-less multiplies) weighs more than either (PERF.md,
// chip_tools/crc_split_ablation.py). A warp per row gives a shard of
// config 5's append (256 rows of 16 KB) 256 warps, ~2 of the 64 an SM
// holds, each walking its row in 32 dependent rounds: the card stays
// nearly empty. The design fills it:
//   - when the launch's rows are too few to fill the card, each row is cut
//     into `wpr` spans of whole rounds (2, 4 or 8, each span 2 KB or more)
//     that the warps of one CTA share; each warp builds its span's register
//     with the lane scheme of crc_row (lane_walk), each lane moving its
//     register past its span's end by a carry-less multiply, as crc_row's
//     lanes do, and a span before the last also over the last span's L
//     bytes in that multiply (x^(8 (gap + L)) mod P: CRC is linear over
//     GF(2)); the warps' registers meet in shared memory, and one thread
//     joins them by Horner's rule, over each full span with four lookups
//     in a byte-sliced table of the span's advance; it writes the CRC,
//     compares it with the claim, writes ok and counts a bad row. A multiply costs
//     ~200 instructions, as much as a span's own walk of four rounds, so
//     the lanes do all of them in parallel before the join, one or two
//     each;
//   - once the rows fill the card a split only adds that work, so a row
//     keeps one warp, eight rows to a CTA (the host's split_layout aims at
//     16 warps an SM);
//   - the grid is persistent: sized from the SM count and the kernel's
//     occupancy, it walks the launch's rows, so the tables (18 KB) are
//     staged in shared memory once per CTA, with 16-byte loads that are
//     all in flight at once;
//   - the last ceil(G / 256) CTAs sum the votes (csrc/vote_tally.cuh), as
//     in the fused coproc step, so K8 launches no separate tally.
// The host picks (wpr, span) (ops/crc32c_device.py split_layout) and builds
// the span's table (span_table) and the x^(8*512*q) table (round_powers).
// Every row is independent and XORs and integer sums are exact, so the
// result is bit-identical to the plain version in any order.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32c.cuh"
#include "vote_tally.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kThreads == rp_vote::kThreads, "a tally CTA is one CTA of this kernel");
constexpr int kPtrsPerShard = 4;
constexpr int kMaxPtrs = 480;  // 120 shards: 3840 B of parameters
constexpr int kMaxDevices = 64;
constexpr int kSpanTable = 4 * 256;  // words of the byte-sliced advance over one span

enum Slot : int { ROWS = 0, LENS, CLAIMED, VOTES };

// The table of a launch's block pointers, passed by value: kMaxPtrs for
// the mesh's launches, one shard's four for a launch over one block (K5,
// K6, validate_segments), whose parameters are then 3.8 KB smaller.
template <int kPtrs>
struct Table {
  const void* p[kPtrs];
};

template <typename T, int kPtrs>
__device__ __forceinline__ const T* slot(const Table<kPtrs>& t, long long block, int s) {
  return static_cast<const T*>(t.p[block * kPtrsPerShard + s]);
}

// Stage the CRC tables and, for split rows, the span table in shared
// memory with 16-byte loads, every load issued before the first store.
__device__ __forceinline__ void stage_tables(uint32_t* t, uint32_t* ts,
                                             const uint32_t* __restrict__ crc_tables,
                                             const uint32_t* __restrict__ span_table,
                                             bool split) {
  constexpr int kCrc4 = rp_crc::kTables / 4, kAll4 = kCrc4 + kSpanTable / 4;
  constexpr int kPer = (kAll4 + kThreads - 1) / kThreads;
  const int n4 = split ? kAll4 : kCrc4;
  uint4 v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kCrc4)
      v[u] = __ldg(reinterpret_cast<const uint4*>(crc_tables) + i);
    else if (i < n4)
      v[u] = __ldg(reinterpret_cast<const uint4*>(span_table) + (i - kCrc4));
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kCrc4)
      reinterpret_cast<uint4*>(t)[i] = v[u];
    else if (i < n4)
      reinterpret_cast<uint4*>(ts)[i - kCrc4] = v[u];
  }
  __syncthreads();
}

template <int kPtrs>
__global__ void __launch_bounds__(kThreads)
crc_blocks_kernel(const __grid_constant__ Table<kPtrs> table, int n_blocks, int rows, int r,
                  int seg, int wpr, int span, int crc_ctas,
                  const uint32_t* __restrict__ crc_tables, const uint32_t* __restrict__ rounds,
                  const uint32_t* __restrict__ span_table, uint32_t* __restrict__ crc_out,
                  uint8_t* __restrict__ ok, int32_t* __restrict__ bad, int vote_rows, int g,
                  int32_t* __restrict__ tally) {
  __shared__ __align__(16) uint32_t t[rp_crc::kTables];
  __shared__ __align__(16) uint32_t ts[kSpanTable];
  __shared__ uint32_t part[kWarps];
  if ((int)blockIdx.x >= crc_ctas) {  // the vote tally (K7) of this launch's shards
    rp_vote::tally_columns<uint8_t>(table.p + VOTES, kPtrsPerShard, n_blocks, vote_rows, g,
                                    blockIdx.x - crc_ctas, tally);
    return;
  }
  stage_tables(t, ts, crc_tables, span_table, wpr > 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_cta = kWarps / wpr;  // rows a CTA takes at a time
  const int j = warp % wpr;          // this warp's span of its row
  const long long total = (long long)n_blocks * rows;
  // the loop's bound is the CTA's, so every warp reaches every barrier
  for (long long base = (long long)blockIdx.x * per_cta; base < total;
       base += (long long)crc_ctas * per_cta) {
    const long long i = base + warp / wpr;
    const bool live = i < total;
    const long long b = live ? i / rows : 0;
    const int k = live ? (int)(i - b * rows) : 0;
    int raw = 0, len = 0, m = 1;
    uint32_t reg = 0;  // spans past the row's end hold 0
    if (live) {
      raw = slot<int32_t>(table, b, LENS)[k];
      len = raw < 0 ? 0 : (raw > r ? r : raw);
      m = len > 0 ? (len - 1) / span + 1 : 1;  // the row's non-empty spans
      const int s0 = j * span;
      if (j == 0 || s0 < len) {  // span 0 carries the init even for an empty row
        // a span before the last moves over the last span's `tail` bytes
        // here, with its lanes' own moves: x^(8 (gap + tail)), whose
        // x^(8*512*q) is one of two powers, loaded before the walk
        const int tail = j < m - 1 ? len - (m - 1) * span : 0;
        const int q = tail / rp_crc::kRound;
        const uint32_t pow_lo = q > 0 ? __ldg(rounds + q) : 0u;
        const uint32_t pow_hi =
            tail > 0 && (q + 1) * rp_crc::kRound <= r ? __ldg(rounds + q + 1) : 0u;
        const int s1 = len - s0 > span ? s0 + span : len;
        int gap;
        reg = rp_crc::lane_walk(t, slot<uint8_t>(table, b, ROWS) + (long long)k * r + s0,
                                s1 - s0, lane, j == 0 ? 0xFFFFFFFFu : 0u, gap);
        const int d = gap + tail;
        if (d > 0 && reg != 0) {
          const int dm = d % rp_crc::kRound, dq = d / rp_crc::kRound;
          if (dm) reg = rp_crc::multmodp(t[rp_crc::kPowOff + dm], reg);
          if (dq) reg = rp_crc::multmodp(dq == q ? pow_lo : pow_hi, reg);
        }
        reg = rp_crc::warp_xor(reg);
      }
    }
    if (wpr > 1) {
      if (lane == 0) part[warp] = reg;
      __syncthreads();
      if (live && j == 0 && lane == 0) {
        // Horner over the row's m non-empty spans, the earlier ones already
        // moved past the last: over each full span by the span table
        for (int w = 1; w < m - 1; ++w) reg = rp_crc::sliced(ts, reg) ^ part[warp + w];
        if (m > 1) reg ^= part[warp + m - 1];
      }
    }
    if (live && j == 0 && lane == 0) {
      const uint32_t crc = reg ^ 0xFFFFFFFFu;
      if (crc_out != nullptr) crc_out[i] = crc;
      if (ok != nullptr) {
        const bool good = crc == slot<uint32_t>(table, b, CLAIMED)[k] && raw > 0;
        ok[i] = good ? 1 : 0;
        if (bad != nullptr && raw > 0 && !good) atomicAdd(&bad[i / seg], 1);
      }
    }
    if (wpr > 1) __syncthreads();  // `part` is the next row's
  }
}

// CTAs of the kernel that fit on the current device at once (cached).
template <int kPtrs>
int resident_ctas(int* out) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices && (*out = cache[dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc_blocks_kernel<kPtrs>, kThreads,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices) cache[dev].store(*out);
  return 0;
}

// One launch over the table's n_blocks (<= kPtrs / 4) blocks: a persistent
// grid of CRC CTAs, then the tally's.
template <int kPtrs>
int launch(const void* const* table, int n_blocks, long long total, int rows, int r, int seg,
           int wpr, int span, const void* crc_tables, const void* rounds, const void* span_table,
           void* crc_out, void* ok, void* bad, int vote_rows, int g, void* tally, void* stream) {
  const int per_cta = kWarps / wpr;
  long long crc_ctas = (total + per_cta - 1) / per_cta;
  if (crc_ctas > 0) {
    int cap = 0;
    const int e = resident_ctas<kPtrs>(&cap);
    if (e != 0) return e;
    if (crc_ctas > cap) crc_ctas = cap;  // the CTAs walk the rest
  }
  const long long v = ((long long)g + kThreads - 1) / kThreads;
  if (crc_ctas + v == 0) return 0;
  if (crc_ctas + v > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Table<kPtrs> tab = {};
  for (int k = 0; k < n_blocks * kPtrsPerShard; ++k) tab.p[k] = table[k];
  crc_blocks_kernel<kPtrs><<<(unsigned)(crc_ctas + v), kThreads, 0, (cudaStream_t)stream>>>(
      tab, n_blocks, rows, r, seg, wpr, span, (int)crc_ctas, (const uint32_t*)crc_tables,
      (const uint32_t*)rounds, (const uint32_t*)span_table, (uint32_t*)crc_out, (uint8_t*)ok,
      (int32_t*)bad, vote_rows, g, (int32_t*)tally);
  return (int)cudaGetLastError();
}

}  // namespace

// The check over n_blocks shards (1..120) of one card: `table` is a host
// array of 4 * n_blocks device pointers, shard b's at [4 b, 4 b + 4): rows
// u8 [rows, r] at a stride of r, lengths i32 [rows], claimed CRCs u32
// [rows] (null when ok is null, and only then) and votes u8 [vote_rows, g]
// (read only when g > 0). Writes, each when given: crc_out u32 [n_blocks *
// rows], the CRCs; ok u8 [n_blocks * rows]; bad i32 [n_bad] (with ok;
// every bad index (n_blocks * rows - 1) / seg at most lies inside); and,
// when g > 0, tally i32 [g]. At least one of crc_out and ok. Rows are cut
// into wpr spans of `span` bytes (ops/crc32c_device.py split_layout);
// crc_tables are the CRC tables (kernel_tables), rounds the n_rounds powers
// x^(8*512*q) (round_powers), which must cover r when wpr > 1, and
// span_table the byte-sliced advance over `span` zero bytes (span_table;
// read only when wpr > 1).
extern "C" int rp_crc_blocks(const void* const* table, int n_blocks, int rows, int r, int seg,
                             int wpr, int span, const void* crc_tables, const void* rounds,
                             int n_rounds, const void* span_table, void* crc_out, void* ok,
                             void* bad, int n_bad, int vote_rows, int g, void* tally,
                             void* stream) {
  if (n_blocks < 1 || n_blocks * kPtrsPerShard > kMaxPtrs || rows < 0 || r < 0 || seg < 1 ||
      (wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) || span < rp_crc::kRound ||
      span % rp_crc::kRound != 0 || (long long)wpr * span < r ||
      (wpr > 1 && (n_rounds <= r / rp_crc::kRound || span_table == nullptr)) ||
      (crc_out == nullptr && ok == nullptr) || (bad != nullptr && ok == nullptr) || n_bad < 0 ||
      vote_rows < 0 || g < 0 || (g > 0 && tally == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_blocks; ++k)  // the claims and ok come as a pair
    if ((table[k * kPtrsPerShard + CLAIMED] == nullptr) != (ok == nullptr))
      return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_blocks * rows;
  if (bad != nullptr && total > 0 && n_bad <= (total - 1) / seg) return (int)cudaErrorInvalidValue;
  if (bad != nullptr && n_bad > 0) {
    const cudaError_t e =
        cudaMemsetAsync(bad, 0, sizeof(int32_t) * (size_t)n_bad, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return n_blocks == 1
             ? launch<kPtrsPerShard>(table, n_blocks, total, rows, r, seg, wpr, span, crc_tables,
                                     rounds, span_table, crc_out, ok, bad, vote_rows, g, tally,
                                     stream)
             : launch<kMaxPtrs>(table, n_blocks, total, rows, r, seg, wpr, span, crc_tables,
                                rounds, span_table, crc_out, ok, bad, vote_rows, g, tally, stream);
}

// The one-block case (K5, K6): rp_crc_blocks over the block (rows u8
// [rows, r] at a stride of r, lengths, claimed CRCs or null) without a
// host table of its pointers, and without a bad count or votes.
extern "C" int rp_crc_rows(const void* rows_p, const void* lens, const void* claimed, int rows,
                           int r, int wpr, int span, const void* crc_tables, const void* rounds,
                           int n_rounds, const void* span_table, void* crc_out, void* ok,
                           void* stream) {
  const void* table[kPtrsPerShard] = {rows_p, lens, claimed, nullptr};
  return rp_crc_blocks(table, 1, rows, r, 1, wpr, span, crc_tables, rounds, n_rounds, span_table,
                       crc_out, ok, nullptr, 0, 0, 0, nullptr, stream);
}
