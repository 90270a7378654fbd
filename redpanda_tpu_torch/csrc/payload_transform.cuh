// The v1 payload transform of one row by one warp: the device body shared
// by the payload kernel (csrc/payload_transform.cu: K3, K4) and the fused
// coproc step (csrc/coproc_step.cu: K10).
//
// The warp stages its row in shared memory with the widest loads the row's
// alignment allows (16 B when aligned), then scans each pattern
// warp-parallel -- lane k tests start base+k, and __ballot_sync + __ffs
// give the first valid start of each 32-wide window, which is the minimum
// the JAX program's argmax takes. Int fields parse in one lane inside their
// 12-byte window; Str fields find the closing quote with the same ballot
// scan and copy their window. The spec descriptor (patterns, negate and
// nonnum flags, field kinds, max_len) is built once per spec on the host
// (ops/transforms.py TransformProgram) and read from device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rp_payload {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntWindow = 12;
constexpr int kMapperUppercase = 1, kMapperProject = 2;

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// Shared memory one warp stages a row in: the row, then (for a projection)
// its output row, each 16-byte aligned.
__host__ __device__ __forceinline__ int smem_per_warp(int r_in, int r_out, int mapper) {
  return align16(r_in) + (mapper == kMapperProject ? align16(r_out) : 0);
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

// Copy nbytes from 16-byte-aligned shared src to global dst, warp-wide.
__device__ __forceinline__ void warp_store(uint8_t* dst, const uint8_t* src, int nbytes, int lane) {
  uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  int done = 0;
  if ((a & 15) == 0) {
    int nv = nbytes >> 4;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv << 4;
  } else if ((a & 7) == 0) {
    int nv = nbytes >> 3;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(src)[i];
    done = nv << 3;
  } else if ((a & 3) == 0) {
    int nv = nbytes >> 2;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
    done = nv << 2;
  }
  for (int i = done + lane; i < nbytes; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ bool is_num_char(uint8_t c) {
  return (c >= '0' && c <= '9') || c == '.' || c == 'e' || c == 'E' || c == '+' || c == '-';
}

// First start s of pat in the row with s <= len - l (and s <= r - l), else
// -1; with nonnum, the byte after the match must not continue a number
// unless the match ends at the row's length. Same result on every lane.
__device__ __forceinline__ int find_pattern(const uint8_t* row, int r, int len, const uint8_t* pat,
                                            int l, bool nonnum, int lane) {
  if (l == 0 || l > r) return -1;
  int last = min(r - l, len - l);
  for (int base = 0; base <= last; base += 32) {
    int s = base + lane;
    bool m = s <= last;
    for (int k = 0; m && k < l; ++k) m = row[s + k] == __ldg(pat + k);
    if (m && nonnum) {
      int e = s + l;
      if (e < len) m = !is_num_char(e < r ? row[e] : 0);
    }
    unsigned b = __ballot_sync(kFull, m);
    if (b) return base + __ffs(b) - 1;
  }
  return -1;
}

// row[pos + i] when pos >= 0 and pos + i < r, else 0 (_gather_window).
__device__ __forceinline__ uint8_t at(const uint8_t* row, int r, int pos, int i) {
  int c = pos + i;
  return (pos >= 0 && c < r) ? row[c] : 0;
}

// The transform of the row at g (r_in bytes, of which len are the record)
// by the calling warp, staged in the warp's shared `row` (and `orow`, its
// projected output row). Writes r_out output bytes to dst (only for a kept
// row under a projection: dropped projection rows are undefined output, as
// the JAX program's are), then either out_len[0] (the masked length when
// mask_len, else the unmasked one) and keep_out[0], or, with out_len
// nullptr, the packed meta at dst + r_out: the masked LE32 out_len, the
// keep byte and 3 zero bytes.
__device__ __forceinline__ void transform_row(
    const uint8_t* __restrict__ g, int len, uint8_t* row, uint8_t* orow, int r_in,
    uint8_t* __restrict__ dst, int32_t* out_len, uint8_t* keep_out, int r_out, int mask_len,
    const int32_t* __restrict__ desc, int n_filters, int mapper, int n_fields,
    const uint8_t* __restrict__ pats, int lane) {
  warp_load(row, g, r_in, lane);
  __syncwarp();

  bool keep = len > 0;
  for (int f = 0; f < n_filters && keep; ++f) {
    const int32_t* d = desc + 4 * f;
    int hit = find_pattern(row, r_in, len, pats + d[0], d[1], d[3] != 0, lane) >= 0;
    keep = d[2] ? !hit : hit;
  }

  int olen = len;
  const uint8_t* src = row;
  if (mapper == kMapperUppercase) {  // map_uppercase maps the whole row, not only its length
    for (int k = lane; k < r_in; k += 32) {
      uint8_t c = row[k];
      row[k] = (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
    }
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
          if (lane == 0) {
            bool neg = at(row, r_in, vpos, 0) == '-';
            uint32_t val = 0;
            int nd = 0;
            bool seen = false, stopped = false;
            for (int k = 0; k < kIntWindow; ++k) {
              int dg = (int)at(row, r_in, vpos, k) - '0';
              bool isdig = dg >= 0 && dg <= 9;
              stopped = stopped || (!isdig && !(k == 0 && neg));
              if (!stopped && isdig) {
                val = val * 10u + (uint32_t)dg;
                ++nd;
                seen = true;
              }
            }
            uint32_t v = neg ? 0u - val : val;
            orow[off] = v & 0xff;
            orow[off + 1] = (v >> 8) & 0xff;
            orow[off + 2] = (v >> 16) & 0xff;
            orow[off + 3] = (v >> 24) & 0xff;
            ok_all = ok_all && seen && stopped && nd <= 9 && vpos >= 0;
          }
          ok_all = __shfl_sync(kFull, ok_all, 0);
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
          if (lane == 0) {
            orow[off] = slen & 0xff;
            orow[off + 1] = (slen >> 8) & 0xff;
          }
          for (int k = lane; k < max_len; k += 32)
            orow[off + 2 + k] = k < slen ? at(row, r_in, vpos, k) : 0;
          off += 2 + max_len;
        }
      }
      __syncwarp();
      keep = ok_all;
    }
    olen = keep ? r_out : 0;
  }

  if (mapper != kMapperProject || keep) warp_store(dst, src, r_out, lane);
  if (lane == 0) {
    int32_t masked = keep ? olen : 0;
    if (out_len == nullptr) {
      uint8_t* m = dst + r_out;
      m[0] = masked & 0xff;
      m[1] = (masked >> 8) & 0xff;
      m[2] = (masked >> 16) & 0xff;
      m[3] = (masked >> 24) & 0xff;
      m[4] = keep ? 1 : 0;
      m[5] = m[6] = m[7] = 0;
    } else {
      out_len[0] = mask_len ? masked : olen;
      keep_out[0] = keep ? 1 : 0;
    }
  }
}

}  // namespace rp_payload
