// The vote tally (K7) on Hopper: column sums of a row-major [rows, G]
// matrix into int32 [G].
//
// Replaces the JAX program redpanda_tpu/parallel/collectives.py:39
// (make_vote_aggregator._local: votes.astype(int32).sum(axis=0), then a
// psum over the mesh's 'p' axis). The psum is two launches of this kernel
// (parallel/collectives.py): each shard sums its own block of u8 votes
// into an i32 partial on its device, the partials are copied to the
// mesh's first device, and the same kernel sums the stacked i32 [D, G]
// partials there. Integer sums are exact, so the order does not matter.
//
// What bounds it on an H100: bytes, and at the shapes the port uses (a few
// rows by 256 groups, a few KB) the launch latency. One thread per column
// loops over the rows; neighbouring threads read neighbouring columns, so
// each row's read is coalesced. Each thread writes its column once, so the
// output needs no zeroing and no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void tally_kernel(const T* __restrict__ votes, int rows, int g,
                             int32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= g) return;
  int32_t acc = 0;
  for (int r = 0; r < rows; ++r) acc += (int32_t)votes[(long long)r * g + col];
  out[col] = acc;
}

}  // namespace

// dtype 0: votes are uint8; dtype 1: votes are int32 partials.
extern "C" int rp_vote_tally(const void* votes, int rows, int g, int dtype, void* out,
                             void* stream) {
  if (rows < 0 || g < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int threads = 256;
  const int blocks = (g + threads - 1) / threads;
  if (dtype == 0)
    tally_kernel<uint8_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)votes, rows, g, (int32_t*)out);
  else
    tally_kernel<int32_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)votes, rows, g, (int32_t*)out);
  return (int)cudaGetLastError();
}
