// The vote tally (K7) on Hopper: column sums of row-major [rows, G] vote
// blocks into int32 [G].
//
// Replaces the JAX program redpanda_tpu/parallel/collectives.py:39
// (make_vote_aggregator._local: votes.astype(int32).sum(axis=0), then a
// psum over the mesh's 'p' axis). The psum is done per card
// (parallel/collectives.py): rp_vote_tally_blocks sums up to 64 shard
// blocks that lie on one card in one launch, reading them through a table
// of device pointers passed by value. On a mesh of one card with at most
// 64 shards that launch writes the tally itself. Otherwise each card (each
// run of 64 of its shards) writes one int32 [G] partial, the partials are
// gathered on the mesh's first card, and one more launch sums the stacked
// int32 [C, G] partials there as a single block (C + 1 launches, C - 1
// copies for C cards). vote_tally() of one matrix is the same entry point
// with one block. Integer sums are exact, so the order does not matter.
//
// What bounds it on an H100: bytes, and at the shapes the port uses (a few
// rows by 256 groups, a few KB) the launch latency and the host's enqueue
// work around it. The design spends one launch per card on it; the column
// sums are the body of csrc/vote_tally.cuh, which the fused coproc step and
// the CRC + vote step share. The table is a __grid_constant__ parameter, so
// the body reads the pointers where they lie.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_tally.cuh"

namespace {

constexpr int kMaxBlocks = 64;  // 512 B of pointers, well inside the 4 KB parameter limit

struct BlockTable {
  const void* ptr[kMaxBlocks];
};

template <typename T>
__global__ void tally_blocks_kernel(const __grid_constant__ BlockTable table, int nblocks, int rows,
                                    int g, int32_t* __restrict__ out) {
  rp_vote::tally_columns<T>(table.ptr, 1, nblocks, rows, g, blockIdx.x, out);
}

}  // namespace

// The column sums over nblocks blocks of one card, each [rows, g] of one
// dtype (0: uint8 votes, 1: int32 partials): `blocks` is a host array of
// nblocks device pointers (1..64), copied into the launch's parameters.
extern "C" int rp_vote_tally_blocks(const void* const* blocks, int nblocks, int rows, int g,
                                    int dtype, void* out, void* stream) {
  if (nblocks < 1 || nblocks > kMaxBlocks || rows < 0 || g < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  BlockTable table = {};
  for (int b = 0; b < nblocks; ++b) table.ptr[b] = blocks[b];
  const int grid = (g + rp_vote::kThreads - 1) / rp_vote::kThreads;
  if (dtype == 0)
    tally_blocks_kernel<uint8_t><<<grid, rp_vote::kThreads, 0, (cudaStream_t)stream>>>(
        table, nblocks, rows, g, (int32_t*)out);
  else
    tally_blocks_kernel<int32_t><<<grid, rp_vote::kThreads, 0, (cudaStream_t)stream>>>(
        table, nblocks, rows, g, (int32_t*)out);
  return (int)cudaGetLastError();
}
