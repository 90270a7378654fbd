// The v1 payload transform of one staged row by one warp: the device body
// shared by the payload kernel (csrc/payload_transform.cu: K3, K4) and the
// fused coproc step (csrc/coproc_step.cu: K10).
//
// The row lies in shared memory at any alignment: the payload kernel
// stages it with 16-byte copies from the 16-byte boundary at or below its
// start, so its first byte sits at that start's offset inside the stage;
// the fused step stages it at the start of its buffer (warp_load). A
// pattern is scanned sixteen starts a lane, 512 a warp-wide window: each
// lane takes a 16-byte chunk of the buffer and flags the starts whose
// first two bytes are the pattern's with a zero-byte test over words (four
// starts an instruction; find_pattern). Candidate starts are checked in
// ascending order by the whole warp, one pattern byte a lane, so the first
// valid start -- the lowest lane by ballot, then the lowest byte inside
// that lane -- is the minimum the JAX program's argmax takes. Int fields
// parse warp-parallel inside their 12-byte window (lane k takes byte k;
// ballots give the terminator and the digits, a shuffle sum the value);
// Str fields find the closing quote with a ballot scan and copy their
// window. The spec descriptor (patterns, negate and nonnum flags,
// field kinds, max_len) is built once per spec on the host
// (ops/transforms.py TransformProgram) and read from device memory.
//
// The scan reads up to 30 bytes past a row's r bytes (the chunk after the
// one that holds its last start), so a row's buffer keeps 32 bytes of
// slack after it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp_payload {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntWindow = 12;
constexpr int kMapperUppercase = 1, kMapperProject = 2;
constexpr int kOutMeta = 8;  // packed output meta: LE32 out_len, keep byte, 3 zero bytes

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// Bytes of a buffer that holds a row of r bytes at its start, with the
// scan's slack after it.
__host__ __device__ __forceinline__ int row_bytes(int r) { return align16(r) + 32; }

// Bytes of the projection's output row (with room for the packed meta).
__host__ __device__ __forceinline__ int out_row_bytes(int r_out, int mapper) {
  return mapper == kMapperProject ? align16(r_out + kOutMeta) : 0;
}

// Shared memory one warp of the fused step stages a row in: the row, then
// (for a projection) its output row.
__host__ __device__ __forceinline__ int smem_per_warp(int r_in, int r_out, int mapper) {
  return row_bytes(r_in) + out_row_bytes(r_out, mapper);
}

// Copy nbytes from global src to 16-byte-aligned shared dst, warp-wide.
__device__ __forceinline__ void warp_load(uint8_t* dst, const uint8_t* src, int nbytes, int lane) {
  uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((a & 15) == 0) {
    int nv = nbytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < nv; i += 32) d[i] = __ldg(s + i);
    done = nv << 4;
  } else if ((a & 7) == 0) {
    int nv = nbytes >> 3;
    const uint2* s = reinterpret_cast<const uint2*>(src);
    uint2* d = reinterpret_cast<uint2*>(dst);
    for (int i = lane; i < nv; i += 32) d[i] = __ldg(s + i);
    done = nv << 3;
  } else if ((a & 3) == 0) {
    int nv = nbytes >> 2;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int i = lane; i < nv; i += 32) d[i] = __ldg(s + i);
    done = nv << 2;
  }
  for (int i = done + lane; i < nbytes; i += 32) dst[i] = __ldg(src + i);
}

// Copy n bytes from shared src to global dst, warp-wide, with the widest
// stores the two addresses' common alignment allows.
template <typename V>
__device__ __forceinline__ void copy_vec(uint8_t* dst, const uint8_t* src, int n, int lane) {
  constexpr int k = sizeof(V);
  int head = (int)((k - (reinterpret_cast<uintptr_t>(dst) & (k - 1))) & (k - 1));
  head = head < n ? head : n;
  const int nv = (n - head) / k;
  if (lane < head) dst[lane] = src[lane];
  V* d = reinterpret_cast<V*>(dst + head);
  const V* s = reinterpret_cast<const V*>(src + head);
  for (int i = lane; i < nv; i += 32) d[i] = s[i];
  for (int i = head + nv * k + lane; i < n; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src, int n, int lane) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(dst) - reinterpret_cast<uintptr_t>(src);
  if ((x & 15) == 0)
    copy_vec<uint4>(dst, src, n, lane);
  else if ((x & 7) == 0)
    copy_vec<uint2>(dst, src, n, lane);
  else if ((x & 3) == 0)
    copy_vec<uint32_t>(dst, src, n, lane);
  else
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ bool is_num_char(uint8_t c) {
  return (c >= '0' && c <= '9') || c == '.' || c == 'e' || c == 'E' || c == '+' || c == '-';
}

// Bit 7 of each byte of x set where that byte is zero, exactly (no carry
// crosses a byte).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// Nonzero when x has a zero byte (the flags may also mark bytes above a
// zero one: exact only as a whole).
__device__ __forceinline__ uint32_t has_zero_byte(uint32_t x) {
  return (x - 0x01010101u) & ~x & 0x80808080u;
}

// Bits 7, 15, 23, 31 of m as bits 0..3.
__device__ __forceinline__ unsigned nibble(uint32_t m) {
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
}

// First start s of pat in the row with s <= len - l (and s <= r - l), else
// -1; with nonnum, the byte after the match must not continue a number
// unless the match ends at the row's length. Same result on every lane.
//
// Lane k of a window takes the row's 16-byte shared chunk c0 + k (chunk c
// holds row bytes [16c - o, 16c - o + 16), o the row's offset in its
// buffer) and the next chunk's first word (from lane k + 1), and flags the
// starts whose first two bytes are the pattern's with a zero-byte test of
// (word ^ p0) | (word >> 8 ^ p1), four starts an instruction. The flagged
// starts in [0, last] are checked in ascending order by the whole warp,
// one pattern byte a lane.
__device__ __forceinline__ int find_pattern(const uint8_t* row, int r, int len, const uint8_t* pat,
                                            int l, bool nonnum, int lane) {
  if (l == 0 || l > r) return -1;
  const int last = min(r - l, len - l);
  if (last < 0) return -1;
  const uint32_t p0 = 0x01010101u * __ldg(pat);
  const uint32_t p1 = 0x01010101u * (l > 1 ? __ldg(pat + 1) : 0u);
  const uint8_t pk = lane < l ? __ldg(pat + lane) : 0;  // pattern byte `lane`
  // pointer arithmetic on row, not an integer round trip, so that the
  // compiler keeps these loads in shared memory (LDS, not generic loads)
  const int o = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const uint4* chunk = reinterpret_cast<const uint4*>(row - o);
  const int n_chunks = (o + last) / 16 + 1;  // the chunks that hold a start in [0, last]
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    const int c = c0 + lane;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c <= n_chunks) v = chunk[c];  // and the chunk after the last, for its first word
    uint32_t next = __shfl_down_sync(kFull, v.x, 1);
    if (lane == 31 && c < n_chunks) next = chunk[c + 1].x;
    const uint32_t w[5] = {v.x, v.y, v.z, v.w, next};
    uint32_t z[4], any = 0;  // byte j of z[i] is zero: start 4i + j matches
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[i] = w[i] ^ p0;
      if (l > 1) z[i] |= __funnelshift_r(w[i], w[i + 1], 8) ^ p1;
      any |= has_zero_byte(z[i]);
    }
    unsigned cm = 0;  // bit b: start 16c - o + b matches the first two bytes
    if (any != 0 && c < n_chunks) {  // rare: the flags again, one bit a start
#pragma unroll
      for (int i = 0; i < 4; ++i) cm |= nibble(zero_bytes(z[i])) << (4 * i);
      const int s0 = 16 * c - o;
      if (s0 < 0) cm &= ~0u << -s0;
      if (last - s0 < 15) cm &= (2u << (last - s0)) - 1;  // s0 <= last here
    }
    for (;;) {  // the candidates in ascending order, by the whole warp
      const unsigned lanes = __ballot_sync(kFull, cm != 0);
      if (lanes == 0) break;
      const int src = __ffs(lanes) - 1;
      const int b = __ffs(__shfl_sync(kFull, cm, src)) - 1;
      if (lane == src) cm &= cm - 1;
      const int s = 16 * (c0 + src) - o + b;
      bool match = true;
      if (l > 2) {
        bool eq = true;
        for (int k0 = 0; k0 < l; k0 += 32) {
          const int k = k0 + lane;
          const uint8_t pb = k0 == 0 ? pk : (k < l ? __ldg(pat + k) : 0);
          if (k < l && row[s + k] != pb) eq = false;
        }
        match = __all_sync(kFull, eq);
      }
      if (match && nonnum) {
        const int e = s + l;
        if (e < len) match = !is_num_char(e < r ? row[e] : 0);
      }
      if (match) return s;
    }
  }
  return -1;
}

// row[pos + i] when pos >= 0 and pos + i < r, else 0 (_gather_window).
__device__ __forceinline__ uint8_t at(const uint8_t* row, int r, int pos, int i) {
  int c = pos + i;
  return (pos >= 0 && c < r) ? row[c] : 0;
}

// Four bytes mapped by map_uppercase: a..z less 32, every other byte kept.
__device__ __forceinline__ uint32_t upper4(uint32_t x) {
  const uint32_t low7 = x & 0x7f7f7f7fu;
  const uint32_t ge_a = low7 + 0x1f1f1f1fu;  // bit 7 set where the byte is >= 'a'
  const uint32_t gt_z = low7 + 0x05050505u;  // bit 7 set where the byte is > 'z'
  const uint32_t lower = ge_a & ~gt_z & ~x & 0x80808080u;
  return x - (lower >> 2);
}

// 10^e mod 2^32, e < kIntWindow.
__device__ __forceinline__ uint32_t pow10_u32(int e) {
  uint32_t p = 1;
#pragma unroll
  for (int q = 0; q < kIntWindow - 1; ++q)
    if (q < e) p *= 10u;
  return p;
}

// The transform of the row staged at `row` (r_in bytes in shared memory, at
// any alignment, of which len are the record) by the calling warp, with
// `orow` (16-byte-aligned shared memory, out_row_bytes) for a projection's
// output row. Writes r_out output bytes to dst (only for a kept row under a
// projection: dropped projection rows are undefined output, as the JAX
// program's are), then either out_len[0] (the masked length when mask_len,
// else the unmasked one) and keep_out[0], or, with out_len nullptr, the
// packed meta at dst + r_out: the masked LE32 out_len, the keep byte and 3
// zero bytes. map_uppercase rewrites the staged row in place (and the up to
// three bytes of its buffer before it and after it).
__device__ __forceinline__ void transform_staged(
    uint8_t* row, int len, uint8_t* orow, int r_in, uint8_t* __restrict__ dst, int32_t* out_len,
    uint8_t* keep_out, int r_out, int mask_len, const int32_t* __restrict__ desc, int n_filters,
    int mapper, int n_fields, const uint8_t* __restrict__ pats, int lane) {
  bool keep = len > 0;
  for (int f = 0; f < n_filters && keep; ++f) {
    const int32_t* d = desc + 4 * f;
    int hit = find_pattern(row, r_in, len, pats + d[0], d[1], d[3] != 0, lane) >= 0;
    keep = d[2] ? !hit : hit;
  }

  int olen = len;
  const uint8_t* src = row;
  if (mapper == kMapperUppercase) {  // map_uppercase maps the whole row, not only its length
    const int a = (int)(reinterpret_cast<uintptr_t>(row) & 3);
    uint32_t* w = reinterpret_cast<uint32_t*>(row - a);
    const int nw = (a + r_in + 3) >> 2;
    for (int k = lane; k < nw; k += 32) w[k] = upper4(w[k]);
    __syncwarp();
  } else if (mapper == kMapperProject) {
    src = orow;
    if (keep) {
      bool ok_all = true;
      int off = 0;
      for (int f = 0; f < n_fields; ++f) {
        const int32_t* d = desc + 4 * (n_filters + f);
        int l = d[2];
        int pos = find_pattern(row, r_in, len, pats + d[1], l, false, lane);
        int vpos = pos >= 0 ? pos + l : -1;
        if (d[0] == 0) {  // Int: sign, <= 9 digits, terminator in the window
          const int c = lane < kIntWindow ? at(row, r_in, vpos, lane) : 0;
          const int dg = c - '0';
          const bool isdig = lane < kIntWindow && dg >= 0 && dg <= 9;
          const bool neg = __shfl_sync(kFull, c, 0) == '-';
          const unsigned stops =
              __ballot_sync(kFull, lane < kIntWindow && !isdig && !(lane == 0 && neg));
          const int stop = stops ? __ffs(stops) - 1 : kIntWindow;
          const unsigned active = __ballot_sync(kFull, isdig) & ((1u << stop) - 1);
          // digit k weighs 10^(the active digits after it): Horner's sum mod 2^32
          uint32_t val =
              (active >> lane) & 1 ? (uint32_t)dg * pow10_u32(__popc(active >> lane) - 1) : 0;
#pragma unroll
          for (int o = 16; o; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
          const uint32_t v = neg ? 0u - val : val;
          if (lane < 4) orow[off + lane] = (v >> (8 * lane)) & 0xff;
          ok_all = ok_all && active != 0 && stops != 0 && __popc(active) <= 9 && vpos >= 0;
          off += 4;
        } else {  // Str: closing quote within max_len, LE u16 length + body
          int max_len = d[3];
          int width = max_len + 1;
          int slen = width;
          for (int base = 0; base < width; base += 32) {
            int k = base + lane;
            unsigned b = __ballot_sync(kFull, k < width && at(row, r_in, vpos, k) == '"');
            if (b) {
              slen = base + __ffs(b) - 1;
              break;
            }
          }
          bool found = slen <= max_len;
          slen = min(slen, max_len);
          ok_all = ok_all && pos >= 0 && found;
          if (lane < 2) orow[off + lane] = (slen >> (8 * lane)) & 0xff;
          for (int k = lane; k < max_len; k += 32)
            orow[off + 2 + k] = k < slen ? at(row, r_in, vpos, k) : 0;
          off += 2 + max_len;
        }
      }
      keep = ok_all;
    }
    olen = keep ? r_out : 0;
  }

  const int32_t masked = keep ? olen : 0;
  const uint8_t meta = lane < 4 ? (uint8_t)((masked >> (8 * lane)) & 0xff)
                                : (uint8_t)(lane == 4 && keep ? 1 : 0);
  // a kept projection row goes out with its packed meta in one copy
  const bool with_meta = out_len == nullptr && mapper == kMapperProject && keep;
  if (with_meta && lane < kOutMeta) orow[r_out + lane] = meta;
  __syncwarp();
  const int nbytes = r_out + (with_meta ? kOutMeta : 0);
  if (mapper != kMapperProject || keep) warp_copy(dst, src, nbytes, lane);
  if (out_len == nullptr) {
    if (!with_meta && lane < kOutMeta) dst[r_out + lane] = meta;
  } else if (lane == 0) {
    out_len[0] = mask_len ? masked : olen;
    keep_out[0] = keep ? 1 : 0;
  }
}

// The transform of the row at g by the calling warp, staged first at the
// start of the warp's shared `row` (row_bytes(r_in)), with `orow` its
// projection's output row: the fused coproc step's body.
__device__ __forceinline__ void transform_row(
    const uint8_t* __restrict__ g, int len, uint8_t* row, uint8_t* orow, int r_in,
    uint8_t* __restrict__ dst, int32_t* out_len, uint8_t* keep_out, int r_out, int mask_len,
    const int32_t* __restrict__ desc, int n_filters, int mapper, int n_fields,
    const uint8_t* __restrict__ pats, int lane) {
  warp_load(row, g, r_in, lane);
  __syncwarp();
  transform_staged(row, len, orow, r_in, dst, out_len, keep_out, r_out, mask_len, desc, n_filters,
                   mapper, n_fields, pats, lane);
}

}  // namespace rp_payload
