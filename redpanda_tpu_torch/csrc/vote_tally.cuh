// Column sums of row-major [rows, G] vote blocks into int32 [G]: the device
// body shared by the vote tally (csrc/vote_tally.cu: K7), the fused coproc
// step (csrc/coproc_step.cu: K10) and the CRC + vote step
// (csrc/crc_blocks.cu: K8).
//
// One thread per column loops over every row of every block; neighbouring
// threads read neighbouring columns, so each row's read is coalesced. Each
// thread writes its column once, so the output needs no zeroing and no
// atomics. Integer sums are exact, so the order does not matter.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp_vote {

constexpr int kThreads = 256;  // columns one tally CTA sums

// out[col] for the kThreads columns of tally CTA `cta` (there are
// ceil(g / kThreads) of them, each of kThreads threads): the sum over
// every row of nblocks blocks, block b at ptrs[b * stride]. A table that
// holds several pointers a shard passes the address of its first vote slot
// and its pointers per shard.
template <typename T>
__device__ __forceinline__ void tally_columns(const void* const* ptrs, int stride, int nblocks,
                                              int rows, int g, int cta,
                                              int32_t* __restrict__ out) {
  const int col = cta * kThreads + threadIdx.x;
  if (col >= g) return;
  int32_t acc = 0;
  for (int b = 0; b < nblocks; ++b) {
    const T* __restrict__ votes = static_cast<const T*>(ptrs[(long long)b * stride]);
    for (int r = 0; r < rows; ++r) acc += (int32_t)votes[(long long)r * g + col];
  }
  out[col] = acc;
}

}  // namespace rp_vote
