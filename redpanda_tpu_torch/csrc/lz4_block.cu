// LZ4 block decode of n streams (K11) on Hopper.
//
// Replaces the JAX program redpanda_tpu/ops/lz4_device.py:52
// (make_block_decoder.decode). The JAX program is a byte machine that
// advances every stream one step at a time in lockstep: a token, a length
// extension byte, an offset byte, one literal byte or one match byte per
// step. It stops a stream at the end of its input after literals (done)
// or at the first failed check: a write at op >= max_out, a consumed byte
// at ip >= comp_len, a match copy with offset <= 0 or > op. This kernel
// runs exactly that machine, so all three outputs agree on every stream,
// rejected ones included:
//   - the output row starts zeroed;
//   - reads clip their index to the buffer (a failing match copy still
//     reads out[clip(op - off)], a read past max_in reads the last byte);
//   - the step that fails still writes its byte, at clip(op, 0, max_out-1);
//   - out_len is the final op, even past max_out;
//   - comp_len <= 0 is ok with out_len 0;
//   - a stream that ends after a match is rejected (ok needs done).
//
// What bounds it on an H100: bytes, by a wide margin on paper (each
// compressed byte read once, each decoded byte written once). In practice
// it is latency: the machine is a serial dependency chain inside a stream,
// and a match reads bytes the stream itself just wrote.
//
// Design: one thread per stream, which is what a CUDA thread does well and
// the TPU's lanes could not (they ran every stream's step as masked vector
// ops with a one-hot write over the whole row). The thread zeroes its
// output row, then runs the machine with its row in global memory (the
// recent output stays in L1). Warp-cooperative literal and match copies
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
enum Phase { TOKEN, LIT_EXT, LIT_COPY, OFF_LO, OFF_HI, M_EXT, M_COPY, DONE };

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 addition that wraps, as the JAX program's does (no signed overflow)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void lz4_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_len,
                           int n, int max_in, uint8_t* __restrict__ out,
                           int32_t* __restrict__ out_len, uint8_t* __restrict__ ok_out,
                           int max_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* in = comp + (long long)i * max_in;
  uint8_t* o = out + (long long)i * max_out;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int nv = max_out >> 4;
    for (int k = 0; k < nv; ++k) reinterpret_cast<uint4*>(o)[k] = make_uint4(0, 0, 0, 0);
    for (int k = nv << 4; k < max_out; ++k) o[k] = 0;
  } else {
    for (int k = 0; k < max_out; ++k) o[k] = 0;
  }
  const int clen = comp_len[i];
  int ip = 0, op = 0, lit = 0, mlen = 0, moff = 0;
  int phase = clen > 0 ? TOKEN : DONE;
  bool ok = true;
  while (phase != DONE && ok) {
    const int cur = in[clampi(ip, 0, max_in - 1)];
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
      o[clampi(op, 0, max_out - 1)] = (uint8_t)wbyte;
      op = wrap_add(op, 1);
    }
    if (consumed) {
      if (ip >= clen) ok = false;
      ip = wrap_add(ip, 1);
    }
  }
  out_len[i] = op;
  ok_out[i] = (ok && phase == DONE) ? 1 : 0;
}

}  // namespace

extern "C" int rp_lz4_block_decode(const void* comp, const void* comp_len, int n, int max_in,
                                   void* out, void* out_len, void* ok, int max_out, void* stream) {
  if (n <= 0) return 0;
  if (max_in <= 0 || max_out <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  lz4_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)comp_len, n, max_in, (uint8_t*)out,
      (int32_t*)out_len, (uint8_t*)ok, max_out);
  return (int)cudaGetLastError();
}
