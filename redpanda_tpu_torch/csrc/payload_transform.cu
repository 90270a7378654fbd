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
// Design: one warp per row. The warp stages its row in shared memory with
// the widest loads the row's alignment allows (16 B when aligned), then
// scans each pattern warp-parallel -- lane k tests start base+k, and
// __ballot_sync + __ffs give the first valid start of each 32-wide window,
// which is the minimum the JAX program's argmax takes. Int fields parse in
// one lane inside their 12-byte window; Str fields find the closing quote
// with the same ballot scan and copy their window. The spec descriptor
// (patterns, negate and nonnum flags, field kinds, max_len) is built once
// per spec on the host and read from device memory. A simple kernel first:
// no TMA, no overlap of one row's load with the next row's scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kIntWindow = 12;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt into

__device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// Copy nbytes from global src to 16-byte-aligned shared dst, warp-wide.
__device__ void warp_load(uint8_t* dst, const uint8_t* src, int nbytes, int lane) {
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
__device__ void warp_store(uint8_t* dst, const uint8_t* src, int nbytes, int lane) {
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
__device__ int find_pattern(const uint8_t* row, int r, int len, const uint8_t* pat, int l,
                            bool nonnum, int lane) {
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

__global__ void payload_kernel(const uint8_t* __restrict__ in, long long in_stride,
                               const int32_t* __restrict__ lens, int n, int r_in,
                               uint8_t* __restrict__ out, long long out_stride,
                               int32_t* __restrict__ out_len, uint8_t* __restrict__ keep_out,
                               int r_out, int mask_len, const int32_t* __restrict__ desc,
                               int n_filters, int mapper, int n_fields,
                               const uint8_t* __restrict__ pats, int per_warp, int wpb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * wpb + warp;
  if (i >= n) return;  // uniform per warp: the warp collectives below stay full
  uint8_t* row = smem + warp * per_warp;
  uint8_t* orow = row + align16(r_in);
  const uint8_t* g = in + i * in_stride;
  warp_load(row, g, r_in, lane);
  int len;
  if (lens != nullptr) {
    len = lens[i];
  } else {
    const uint8_t* m = g + r_in;  // LE32 length in the meta columns
    len = (int)((uint32_t)m[0] | ((uint32_t)m[1] << 8) | ((uint32_t)m[2] << 16) |
                ((uint32_t)m[3] << 24));
  }
  __syncwarp();

  bool keep = len > 0;
  for (int f = 0; f < n_filters && keep; ++f) {
    const int32_t* d = desc + 4 * f;
    int hit = find_pattern(row, r_in, len, pats + d[0], d[1], d[3] != 0, lane) >= 0;
    keep = d[2] ? !hit : hit;
  }

  int olen = len;
  const uint8_t* src = row;
  uint8_t* dst = out + i * out_stride;
  if (mapper == 1) {  // map_uppercase maps the whole row, not only its length
    for (int k = lane; k < r_in; k += 32) {
      uint8_t c = row[k];
      row[k] = (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
    }
    __syncwarp();
  } else if (mapper == 2) {  // map_project
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

  // dropped projection rows are undefined output (the JAX program's too):
  // only rows whose projection was computed are written
  if (mapper != 2 || keep) warp_store(dst, src, r_out, lane);
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
      out_len[i] = mask_len ? masked : olen;
      keep_out[i] = keep ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int rp_payload_transform(const void* in, long long in_stride, const void* lens, int n,
                                    int r_in, void* out, long long out_stride, void* out_len,
                                    void* keep, int r_out, int mask_len, const void* desc,
                                    int n_filters, int mapper, int n_fields, const void* pats,
                                    void* stream) {
  if (n <= 0) return 0;
  // host-side twin of align16 (the device one is __device__ only)
  int per_warp = ((r_in + 15) & ~15) + (mapper == 2 ? ((r_out + 15) & ~15) : 0);
  if ((size_t)per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int wpb = (int)(kDefaultSmem / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
  size_t smem = (size_t)per_warp * wpb;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + wpb - 1) / wpb;
  payload_kernel<<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_stride, (const int32_t*)lens, n, r_in, (uint8_t*)out, out_stride,
      (int32_t*)out_len, (uint8_t*)keep, r_out, mask_len, (const int32_t*)desc, n_filters, mapper,
      n_fields, (const uint8_t*)pats, per_warp, wpb);
  return (int)cudaGetLastError();
}
