// LZ4 block decode of n streams (K11) on Hopper.
//
// Replaces the JAX program redpanda_tpu/ops/lz4_device.py:52
// (make_block_decoder.decode). The JAX program is a byte machine that
// advances every stream one step at a time in lockstep: a token, a length
// extension byte, an offset byte, one literal byte or one match byte per
// step. It stops a stream at the end of its input after literals (done)
// or at the first failed check: a write at op >= max_out, a consumed byte
// at ip >= comp_len, a match copy with offset <= 0 or > op. This kernel
// gives exactly that machine's three outputs on every stream, rejected
// ones included:
//   - the output row starts zeroed;
//   - reads clip their index to the buffer (a failing match copy still
//     reads out[clip(op - off)], a read past max_in reads the last byte);
//   - the step that fails still writes its byte, at clip(op, 0, max_out-1);
//   - out_len is the final op, even past max_out;
//   - comp_len <= 0 is ok with out_len 0;
//   - a stream that ends after a match is rejected (ok needs done).
//
// What bounds it on an H100: bytes on paper (each compressed byte read
// once, each decoded byte written once: 6.4 us for 16384 x 1 KiB rows).
// What holds it back is the serial dependency chain inside a stream: a
// match reads bytes the stream itself has just written.
//
// Design: one warp per stream, several warps per block. Each warp stages
// its stream in a slice of shared memory (the input bytes the machine can
// read, and its zeroed output row), so the chain runs on shared memory,
// and global memory sees only coalesced 16-byte loads and stores. Every
// lane runs the same scalar machine state and reads the same shared byte
// (a broadcast), so tokens, extensions and offsets need no shuffles. The
// warp does a run of steps at once only where no check of the machine
// could fail inside it:
//   - whole sequences (the common case): the token, up to 14 literals,
//     then the end of the input, or the offset, at most one match-length
//     extension byte and the match; the lanes copy the literals and the
//     match, and sequences follow one another without the byte machine;
//   - literals: the steps that read inside the row and the input and
//     write inside the output, 32 bytes a round, then (when the run is
//     done) the machine's next step, which reads and writes nothing;
//   - a match with 0 < offset <= op: the steps that write inside the
//     output; lane j writes out[op + j] = out[op - off + (j mod off)].
//     Every source byte lies below op, so the rounds are exact for an
//     overlapping match (offset < length) too.
// Each copy ends in __syncwarp, so a later read sees every lane's bytes.
// Every other step (a length that wrapped, comp_len past max_in, a copy
// that would cross max_out or comp_len, a bad offset) is the byte
// machine's own single step, lane 0 writing its byte. At the end the warp
// writes its whole row, zeros included, back to global memory.
//
// What is left: the warp runs the stream's scalar control once for all
// 32 lanes, tens of instructions a sequence and some 80 sequences a 1 KiB
// text record, so at 16384 records the kernel is bound by instruction
// throughput, not by bytes (PERF.md has its times). Several streams a
// warp would share those instructions; that is later work.
//
// A warp's slice is max_in + max_out rounded up to 16 bytes; a block takes
// up to eight warps within 48 KB (rows of 512 in and 1 KiB out: eight
// warps in 12 KB). Where one slice passes 48 KB the same warp code runs on
// the rows in global memory instead (kShared false): chosen by shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // streams per block
constexpr int kSharedBytes = 48 * 1024;  // a block's shared memory without an opt-in
enum Phase { TOKEN, LIT_EXT, LIT_COPY, OFF_LO, OFF_HI, M_EXT, M_COPY, DONE };

__host__ __device__ __forceinline__ long long round16(long long x) { return (x + 15) & ~15LL; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 addition that wraps, as the JAX program's does (no signed overflow)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// n bytes from src to dst by the warp: 16 bytes a lane where both are
// 16-byte aligned, the tail (or everything, unaligned) a byte a lane
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src, int n, int lane) {
  int k0 = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int nv = n >> 4;
    for (int k = lane; k < nv; k += 32)
      reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
    k0 = nv << 4;
  }
  for (int k = k0 + lane; k < n; k += 32) dst[k] = src[k];
}

__device__ __forceinline__ void warp_zero(uint8_t* dst, int n, int lane) {
  int k0 = 0;
  if (aligned16(dst)) {
    const int nv = n >> 4;
    for (int k = lane; k < nv; k += 32) reinterpret_cast<uint4*>(dst)[k] = make_uint4(0, 0, 0, 0);
    k0 = nv << 4;
  }
  for (int k = k0 + lane; k < n; k += 32) dst[k] = 0;
}

// n match bytes at out[op..op + n) from offset off (0 < off <= op) by the
// warp: lane j of a round writes out[op + j] = out[op - off + (j mod off)].
// Every source byte lies below op, so the rounds need no sync between them,
// for an overlapping match (off < n) too. Most matches take one round.
__device__ __forceinline__ void match_copy(uint8_t* o, int op, int off, int n, int lane) {
  const uint8_t* src = o + (op - off);
  if (n <= 32) {  // lane j < n reads src[j mod off]: a division only where j >= off
    if (lane < n) o[op + lane] = src[lane < off ? lane : lane % off];
    return;
  }
  int r = lane < off ? lane : lane % off;
  const int inc = off > 32 ? 32 : 32 % off;
  for (int j = lane; j < n; j += 32) {
    o[op + j] = src[r];
    r += inc;
    if (r >= off) r -= off;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
lz4_warp_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_len, int n,
                int max_in, uint8_t* __restrict__ out, int32_t* __restrict__ out_len,
                uint8_t* __restrict__ ok_out, int max_out, int slice) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp
  const uint8_t* gin = comp + (long long)i * max_in;
  uint8_t* gout = out + (long long)i * max_out;
  const int clen = comp_len[i];
  const uint8_t* in = gin;
  uint8_t* o = gout;
  if (kShared) {
    o = reinterpret_cast<uint8_t*>(smem) + warp * slice;
    uint8_t* in_s = o + round16(max_out);
    // the bytes the machine can read: it stops at the first consumed byte
    // at ip >= comp_len, so it never reads past min(comp_len, max_in - 1)
    warp_copy(in_s, gin, clen <= 0 ? 0 : (clen >= max_in ? max_in : clen + 1), lane);
    in = in_s;
  }
  warp_zero(o, max_out, lane);
  __syncwarp();

  const int last = max_in - 1;
  const int in_end = clen < max_in ? clen : max_in;
  int ip = 0, op = 0, lit = 0, mlen = 0, moff = 0;
  int phase = clen > 0 ? TOKEN : DONE;
  bool ok = true;
  while (phase != DONE && ok) {
    if (phase == TOKEN) {
      // Whole sequences, one after another, while no check of the machine
      // could fail in any of their steps: the token, up to 14 literals
      // inside the row, the input and the output, then either the end of
      // the input or the two offset bytes, at most one match-length
      // extension byte below 255 and a match with 0 < offset <= op inside
      // the output. At a token the machine's lit, mlen and moff are dead
      // (the token and offset steps set them), so only ip and op carry.
      while (ip < in_end) {
        const int t = in[ip];
        const int l0 = t >> 4;
        const int ip1 = ip + 1 + l0, op1 = op + l0;
        if (l0 == 15 || ip1 > in_end || op1 > max_out) break;
        if (ip1 >= clen) {  // the last sequence: its literals, then done
          if (lane < l0) o[op + lane] = in[ip + 1 + lane];
          ip = ip1;
          op = op1;
          phase = DONE;
          break;
        }
        if (ip1 + 1 >= in_end) break;
        const int off = in[ip1] | (in[ip1 + 1] << 8);
        int ml = (t & 15) + 4, ipn = ip1 + 2;
        if (ml == 19) {
          if (ipn >= in_end || in[ipn] == 255) break;
          ml += in[ipn];
          ipn += 1;
        }
        if (off == 0 || off > op1 || op1 + ml > max_out) break;
        if (l0) {
          if (lane < l0) o[op + lane] = in[ip + 1 + lane];
          __syncwarp();
        }
        match_copy(o, op1, off, ml, lane);
        __syncwarp();
        ip = ipn;
        op = op1 + ml;
      }
      if (phase == DONE) break;
    }
    if (phase == LIT_COPY && lit > 0) {
      const int nb = min(min(lit, in_end - ip), max_out - op);
      if (nb > 0) {  // nb literal steps, none of which can fail
        for (int j = lane; j < nb; j += 32) o[op + j] = in[ip + j];
        __syncwarp();
        ip += nb;
        op += nb;
        lit -= nb;
        if (lit == 0) phase = ip >= clen ? DONE : OFF_LO;  // the machine's next step
        continue;
      }
    } else if (phase == M_COPY && moff > 0 && moff <= op) {
      // mlen <= 0 (a wrapped length) counts as more than the room left
      const int nb = (int)min((unsigned)mlen, (unsigned)(max_out - op));
      if (nb > 0) {  // nb match steps, none of which can fail
        match_copy(o, op, moff, nb, lane);
        __syncwarp();
        op += nb;
        mlen = wrap_add(mlen, -nb);
        if (mlen == 0) phase = TOKEN;  // the last step was the one at mlen == 1
        continue;
      }
    }
    // one step of the byte machine
    const int cur = in[clampi(ip, 0, last)];
    bool consumed = false, wrote = false;
    int wbyte = 0;
    switch (phase) {
      case TOKEN:
        lit = cur >> 4;
        mlen = cur & 15;
        phase = lit == 15 ? LIT_EXT : LIT_COPY;
        consumed = true;
        break;
      case LIT_EXT:
        lit = wrap_add(lit, cur);
        if (cur != 255) phase = LIT_COPY;
        consumed = true;
        break;
      case LIT_COPY:
        if (lit > 0) {
          wbyte = cur;
          wrote = consumed = true;
          lit -= 1;
        } else {
          phase = ip >= clen ? DONE : OFF_LO;
        }
        break;
      case OFF_LO:
        moff = cur;
        phase = OFF_HI;
        consumed = true;
        break;
      case OFF_HI:
        moff |= cur << 8;
        consumed = true;
        if (mlen == 15) {
          phase = M_EXT;
        } else {
          phase = M_COPY;
          mlen += 4;
        }
        break;
      case M_EXT:
        mlen = wrap_add(mlen, cur);
        consumed = true;
        if (cur != 255) {
          phase = M_COPY;
          mlen = wrap_add(mlen, 4);
        }
        break;
      case M_COPY:
        wbyte = o[clampi(op - moff, 0, max_out - 1)];
        wrote = true;
        if (moff <= 0 || moff > op) ok = false;
        if (mlen == 1) phase = TOKEN;
        mlen = wrap_add(mlen, -1);
        break;
    }
    if (wrote) {
      if (op >= max_out) ok = false;
      if (lane == 0) o[clampi(op, 0, max_out - 1)] = (uint8_t)wbyte;
      __syncwarp();
      op = wrap_add(op, 1);
    }
    if (consumed) {
      if (ip >= clen) ok = false;
      ip = wrap_add(ip, 1);
    }
  }
  if (kShared) {
    __syncwarp();
    warp_copy(gout, o, max_out, lane);
  }
  if (lane == 0) {
    out_len[i] = op;
    ok_out[i] = (ok && phase == DONE) ? 1 : 0;
  }
}

}  // namespace

extern "C" int rp_lz4_block_decode(const void* comp, const void* comp_len, int n, int max_in,
                                   void* out, void* out_len, void* ok, int max_out, void* stream) {
  if (n <= 0) return 0;
  if (max_in <= 0 || max_out <= 0) return (int)cudaErrorInvalidValue;
  const long long slice = round16(max_in) + round16(max_out);
  if (slice <= kSharedBytes) {
    const int warps = (int)(kSharedBytes / slice < kWarps ? kSharedBytes / slice : kWarps);
    lz4_warp_kernel<true><<<(n + warps - 1) / warps, warps * 32, warps * slice,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int32_t*)comp_len, n, max_in, (uint8_t*)out,
        (int32_t*)out_len, (uint8_t*)ok, max_out, (int)slice);
  } else {
    lz4_warp_kernel<false><<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int32_t*)comp_len, n, max_in, (uint8_t*)out,
        (int32_t*)out_len, (uint8_t*)ok, max_out, 0);
  }
  return (int)cudaGetLastError();
}
