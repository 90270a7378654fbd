// The columnar predicate (K1) on Hopper: a predicate interpreter.
//
// Replaces the JAX program redpanda_tpu/coproc/column_plan.py:213
// (_compile_device_locked.predicate: _build_expr, _contains, _packbits, with
// constants from _prepare_cmp_consts). The JAX package traces one XLA
// program per deployed spec; deploys arrive over the wire at run time, so
// this kernel compiles nothing per spec. At enable time the host turns the
// expression tree into a flat postfix program (one 8-int instruction per
// node: opcode, column slots, constants, needle offsets; see
// coproc/column_plan.py compile_predicate) and keeps it on the device. Each
// launch passes the column pointers by value.
//
// What bounds it on an H100: neither bytes nor operations. At the engine's
// bench shape (32768 rows, one 5-byte string column) a launch reads about
// 0.3 MB and writes 4 KB -- well under a microsecond at 3.35 TB/s -- so the
// launch latency sets its time. The design keeps it one launch with no
// host round trip: one thread per row walks the program (uniform across
// the warp, so instruction reads broadcast) and evaluates it on a bit stack.
//
// The bit stack lives in a 64-bit register: a push shifts the word left.
// Trees deeper than 64 spill whole words to a global scratch of
// [ceil(depth / 64) - 1, n_pad] words, so any depth the DSL can build works.
// The keep bits pack with __ballot_sync: the ballot is LSB-first by lane and
// _packbits is MSB-first, so each byte is bit-reversed before its store.
// n_pad is a multiple of 8 but not always of 32: lanes past n_pad vote 0 and
// store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 64;
constexpr int kInsn = 8;

enum Op : int {
  OP_EXISTS = 1,    // a1 exists col
  OP_STR_EQ = 2,    // a1 bytes, a2 vlen, a3 w, a4 needle off, a5 len, a6 negate
  OP_CONTAINS = 3,  // a1 bytes, a2 vlen, a3 w, a4 needle off, a5 len, a6 window
  OP_BOOL = 4,      // a1 i32, a2 flags, a3 value 0/1, a6 negate
  OP_NULL = 5,      // a1 flags, a6 negate
  OP_NUM = 6,       // a1 f32, a2 i32, a3 flags, a4 cmp, a5 f32 bits, a6 has i32, a7 i32
  OP_AND = 7,
  OP_OR = 8,
  OP_NOT = 9,
};

// lattice flags of the numeric extractor (ops/exprs.py F_*)
constexpr uint8_t F_PRESENT = 1, F_NUMBER = 2, F_INT_EXACT = 4, F_BOOL = 8, F_NULL = 16;

struct Cols {
  const void* p[kMaxCols];
};

template <typename T>
__device__ __forceinline__ bool cmp(int op, T a, T b) {
  switch (op) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ const uint8_t* u8(const Cols& c, int k) {
  return static_cast<const uint8_t*>(c.p[k]);
}
__device__ __forceinline__ const int32_t* i32(const Cols& c, int k) {
  return static_cast<const int32_t*>(c.p[k]);
}

__device__ bool eval_leaf(const Cols& c, const int* ins, const uint8_t* needles, long long row) {
  switch (ins[0]) {
    case OP_EXISTS:
      return u8(c, ins[1])[row] != 0;
    case OP_STR_EQ: {
      int v = i32(c, ins[2])[row];
      bool present = v >= 0;
      int len = ins[5];
      bool eq = present && v == len;
      const uint8_t* b = u8(c, ins[1]) + row * ins[3];
      for (int k = 0; eq && k < len; ++k) eq = b[k] == needles[ins[4] + k];
      return ins[6] ? (present && !eq) : eq;
    }
    case OP_CONTAINS: {
      int v = i32(c, ins[2])[row];
      bool present = v >= 0;
      int w = ins[3], l = ins[5];
      int weff = min(ins[6], w);  // this predicate's own window, even in a wider column
      if (l == 0) return present;
      if (!present || l > weff) return false;
      int last = min(v, weff) - l;  // last start inside min(vlen, window)
      const uint8_t* b = u8(c, ins[1]) + row * w;
      const uint8_t* nd = needles + ins[4];
      for (int s = 0; s <= last; ++s) {
        bool m = true;
        for (int k = 0; m && k < l; ++k) m = b[s + k] == nd[k];
        if (m) return true;
      }
      return false;
    }
    case OP_BOOL: {
      uint8_t fl = u8(c, ins[2])[row];
      bool isbool = (fl & F_BOOL) != 0;
      bool eq = isbool && i32(c, ins[1])[row] == ins[3];
      return ins[6] ? (isbool && !eq) : eq;
    }
    case OP_NULL: {
      uint8_t fl = u8(c, ins[1])[row];
      bool isnull = (fl & F_NULL) != 0;
      return ins[6] ? ((fl & F_PRESENT) != 0 && !isnull) : isnull;
    }
    default: {  // OP_NUM: int32 path only for an int32-exact constant and row
      uint8_t fl = u8(c, ins[3])[row];
      if ((fl & F_NUMBER) == 0) return false;
      if (ins[6] && (fl & F_INT_EXACT)) return cmp<int32_t>(ins[4], i32(c, ins[2])[row], ins[7]);
      const float* f = static_cast<const float*>(c.p[ins[1]]);
      return cmp<float>(ins[4], f[row], __int_as_float(ins[5]));
    }
  }
}

__global__ void predicate_kernel(Cols cols, const int* __restrict__ code, int n_ops,
                                 const uint8_t* __restrict__ needles, int n_pad,
                                 unsigned long long* __restrict__ scratch,
                                 uint8_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = row < n_pad;
  unsigned long long cur = 0;  // top word of the bit stack
  int sp = 0;                  // items on the stack
  if (valid) {
    for (int pc = 0; pc < n_ops; ++pc) {
      const int* ins = code + pc * kInsn;
      int op = ins[0];
      bool bit;
      if (op == OP_AND || op == OP_OR || op == OP_NOT) {
        bool b = cur & 1ull;
        cur >>= 1;
        --sp;
        if (sp > 0 && (sp & 63) == 0) cur = scratch[(size_t)((sp >> 6) - 1) * n_pad + row];
        if (op == OP_NOT) {
          bit = !b;
        } else {
          bool a = cur & 1ull;
          cur >>= 1;
          --sp;
          if (sp > 0 && (sp & 63) == 0) cur = scratch[(size_t)((sp >> 6) - 1) * n_pad + row];
          bit = op == OP_AND ? (a && b) : (a || b);
        }
      } else {
        bit = eval_leaf(cols, ins, needles, row);
      }
      if (sp > 0 && (sp & 63) == 0) {
        scratch[(size_t)((sp >> 6) - 1) * n_pad + row] = cur;
        cur = 0;
      }
      cur = (cur << 1) | (bit ? 1ull : 0ull);
      ++sp;
    }
  }
  unsigned ballot = __ballot_sync(0xffffffffu, valid && (cur & 1ull));
  int lane = threadIdx.x & 31;
  if (valid && (lane & 7) == 0) {
    unsigned byte = (ballot >> lane) & 0xffu;
    out[row >> 3] = (uint8_t)(__brev(byte) >> 24);  // MSB-first, as _packbits
  }
}

}  // namespace

extern "C" int rp_predicate(const void* const* cols, int n_cols, const void* code, int n_ops,
                            const void* needles, int n_pad, void* scratch, void* out,
                            void* stream) {
  if (n_cols > kMaxCols || n_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return 0;
  Cols c = {};
  for (int k = 0; k < n_cols; ++k) c.p[k] = cols[k];
  const int threads = 256;
  int blocks = (n_pad + threads - 1) / threads;
  predicate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      c, (const int*)code, n_ops, (const uint8_t*)needles, n_pad,
      (unsigned long long*)scratch, (uint8_t*)out);
  return (int)cudaGetLastError();
}
