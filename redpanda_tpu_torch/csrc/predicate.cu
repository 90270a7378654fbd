// The columnar predicate (K1) and the stacked predicate (K2) on Hopper: a
// predicate interpreter over a table of column pointers.
//
// Replaces the JAX programs redpanda_tpu/coproc/column_plan.py:213
// (_compile_device_locked.predicate: _build_expr, _contains, _packbits, with
// constants from _prepare_cmp_consts) and :268 (_compile_stacked_locked
// ._local: the same per device over stacks [D, n_pad, ...]). The JAX
// package traces one XLA program per deployed spec; deploys arrive over the
// wire at run time, so this kernel compiles nothing per spec. At enable time
// the host turns the expression tree into a flat postfix program (one 8-int
// instruction per node: opcode, column slots, constants, needle offsets; see
// coproc/column_plan.py compile_predicate) and keeps it on the device.
//
// One kernel body serves two entry points, so that K1 and K2 cannot drift
// apart (predicate_kernel, a template over the size of its pointer table):
//
//  * rp_predicate_leg (K1) is one engine launch's whole device leg in one
//    native crossing: on the stream it is given, one copy of the launch's
//    column block from a pinned host block into a device block, the kernel
//    over the block's columns (the device base plus each column's offset,
//    passed by value), one copy of the n_pad / 8 keep bytes down into pinned
//    memory, and four timing events recorded between those steps. Without a
//    host block it launches over a block already resident (a column-cache
//    hit). K1 is bound by neither bytes nor
//    operations -- at the bench's 32768 rows a launch reads about 0.3 MB and
//    writes 4 KB, under a microsecond at 3.35 TB/s -- but by the host's work
//    around the launch: one crossing from buffers made once per staging slot
//    (coproc/engine.py) replaces a pinning, a copy and an allocation per
//    column, four torch events and the wrapper's Python per launch.
//  * rp_predicate_blocks (K2) evaluates the program over n_blocks blocks of
//    n_pad rows, block b reading its column k at table[b * n_cols + k], into
//    one contiguous uint8 [n_blocks, n_pad / 8] output: one launch per card
//    over the blocks of that card's mesh shards (coproc/column_plan.py
//    predicate_blocks). The table goes by value in the launch's parameters:
//    480 pointers (3840 B, inside the classic 4 KB parameter space with the
//    other arguments), so a launch takes at most 480 / n_cols blocks and the
//    wrapper cuts a card's shards into chunks of that many.
//
// The kernel keeps each launch free of host round trips: one thread per row
// walks the program (uniform across the warp, so instruction reads
// broadcast) and evaluates it on a bit stack; grid (ceil(n_pad / 256),
// n_blocks), so a block's rows never share a warp with another block's.
//
// The bit stack lives in a 64-bit register: a push shifts the word left.
// Trees deeper than 64 spill whole words to a global scratch of
// [ceil(depth / 64) - 1, n_blocks * n_pad] words, so any depth the DSL can
// build works. The keep bits pack with __ballot_sync: the ballot is
// LSB-first by lane and _packbits is MSB-first, so each byte is
// bit-reversed before its store. n_pad is a multiple of 8 but not always of
// 32: lanes past n_pad vote 0 and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 64;   // column arrays a block may read (K1's table: 512 B)
constexpr int kMaxPtrs = 480;  // K2's table: 3840 B of parameters
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

template <int N>
struct Table {
  const void* p[N];
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

// Block b's column k is c[k] with c = &table.p[b * n_cols]: the table is
// a __grid_constant__ parameter, so its address is taken without a copy.
__device__ __forceinline__ const uint8_t* u8(const void* const* c, int k) {
  return static_cast<const uint8_t*>(c[k]);
}
__device__ __forceinline__ const int32_t* i32(const void* const* c, int k) {
  return static_cast<const int32_t*>(c[k]);
}

__device__ bool eval_leaf(const void* const* c, const int* ins, const uint8_t* needles,
                          long long row) {
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
      const float* f = static_cast<const float*>(c[ins[1]]);
      return cmp<float>(ins[4], f[row], __int_as_float(ins[5]));
    }
  }
}

template <int N>
__global__ void predicate_kernel(const __grid_constant__ Table<N> table, int n_cols,
                                 const int* __restrict__ code, int n_ops,
                                 const uint8_t* __restrict__ needles, int n_pad,
                                 unsigned long long* __restrict__ scratch,
                                 uint8_t* __restrict__ out) {
  const int b = blockIdx.y;
  const void* const* cols = &table.p[b * n_cols];
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = row < n_pad;
  // this block's spill words: word w of its row at scratch[w * (n_blocks * n_pad) + row]
  const size_t spill_stride = (size_t)gridDim.y * n_pad;
  unsigned long long* spill = scratch + (size_t)b * n_pad + row;
  unsigned long long cur = 0;  // top word of the bit stack
  int sp = 0;                  // items on the stack
  if (valid) {
    for (int pc = 0; pc < n_ops; ++pc) {
      const int* ins = code + pc * kInsn;
      int op = ins[0];
      bool bit;
      if (op == OP_AND || op == OP_OR || op == OP_NOT) {
        bool b1 = cur & 1ull;
        cur >>= 1;
        --sp;
        if (sp > 0 && (sp & 63) == 0) cur = spill[((sp >> 6) - 1) * spill_stride];
        if (op == OP_NOT) {
          bit = !b1;
        } else {
          bool a = cur & 1ull;
          cur >>= 1;
          --sp;
          if (sp > 0 && (sp & 63) == 0) cur = spill[((sp >> 6) - 1) * spill_stride];
          bit = op == OP_AND ? (a && b1) : (a || b1);
        }
      } else {
        bit = eval_leaf(cols, ins, needles, row);
      }
      if (sp > 0 && (sp & 63) == 0) {
        spill[((sp >> 6) - 1) * spill_stride] = cur;
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
    out[(size_t)b * (n_pad >> 3) + (row >> 3)] = (uint8_t)(__brev(byte) >> 24);  // MSB-first
  }
}

}  // namespace

// The predicate over n_blocks blocks (1..480 / n_cols) of n_pad rows each:
// `table` is a host array of n_blocks * n_cols device pointers, block b's
// column arrays at [b * n_cols, (b + 1) * n_cols), copied into the launch's
// parameters. out is uint8 [n_blocks, n_pad / 8]; scratch (words of
// [ceil(depth / 64) - 1, n_blocks * n_pad]) may be null for depth <= 64.
extern "C" int rp_predicate_blocks(const void* const* table, int n_blocks, int n_cols,
                                   const void* code, int n_ops, const void* needles, int n_pad,
                                   void* scratch, void* out, void* stream) {
  if (n_blocks < 1 || n_cols < 1 || n_cols > kMaxCols || n_blocks * n_cols > kMaxPtrs ||
      n_pad < 0 || n_pad % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return 0;
  Table<kMaxPtrs> t = {};
  for (int k = 0; k < n_blocks * n_cols; ++k) t.p[k] = table[k];
  const int threads = 256;
  const dim3 grid((n_pad + threads - 1) / threads, n_blocks);
  predicate_kernel<kMaxPtrs><<<grid, threads, 0, (cudaStream_t)stream>>>(
      t, n_cols, (const int*)code, n_ops, (const uint8_t*)needles, n_pad,
      (unsigned long long*)scratch, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// K1's device leg over one block of n_pad rows, in one crossing, all on
// `stream`:
//   events[0]; host_block -> dev_block (block_bytes, when host_block is not
//   null); events[1]; the kernel over the columns at dev_block + col_off[k]
//   into bits (uint8 [n_pad / 8] on the card); events[2]; bits -> bits_host
//   (when not null); events[3].
// events (four cudaEvent_t, or null) time the copy up, the kernel and the
// copy down; the last one fences the whole leg, so the caller reuses the
// host block and bits_host only once it has completed. A refused argument
// returns cudaErrorInvalidValue with nothing enqueued; a refused launch
// records events[3] behind the copy already enqueued and returns its error.
extern "C" int rp_predicate_leg(const void* host_block, void* dev_block, long long block_bytes,
                                const long long* col_off, int n_cols, const void* code, int n_ops,
                                const void* needles, int n_pad, void* scratch, void* bits,
                                void* bits_host, void* const* events, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || n_pad < 0 || n_pad % 8 != 0 || block_bytes < 0 ||
      dev_block == nullptr || bits == nullptr || col_off == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Table<kMaxCols> t = {};
  for (int k = 0; k < n_cols; ++k) t.p[k] = (const char*)dev_block + col_off[k];
  cudaError_t err = cudaSuccess;
  if (events != nullptr && (err = cudaEventRecord((cudaEvent_t)events[0], s)) != cudaSuccess)
    return (int)err;
  if (host_block != nullptr && block_bytes > 0 &&
      (err = cudaMemcpyAsync(dev_block, host_block, (size_t)block_bytes, cudaMemcpyHostToDevice,
                             s)) != cudaSuccess)
    return (int)err;
  if (events != nullptr && (err = cudaEventRecord((cudaEvent_t)events[1], s)) != cudaSuccess)
    return (int)err;
  if (n_pad > 0) {
    const int threads = 256;
    predicate_kernel<kMaxCols><<<dim3((n_pad + threads - 1) / threads, 1), threads, 0, s>>>(
        t, n_cols, (const int*)code, n_ops, (const uint8_t*)needles, n_pad,
        (unsigned long long*)scratch, (uint8_t*)bits);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      if (events != nullptr) cudaEventRecord((cudaEvent_t)events[3], s);
      return (int)err;
    }
  }
  if (events != nullptr && (err = cudaEventRecord((cudaEvent_t)events[2], s)) != cudaSuccess)
    return (int)err;
  if (bits_host != nullptr && n_pad > 0 &&
      (err = cudaMemcpyAsync(bits_host, bits, (size_t)(n_pad / 8), cudaMemcpyDeviceToHost, s)) !=
          cudaSuccess)
    return (int)err;
  if (events != nullptr && (err = cudaEventRecord((cudaEvent_t)events[3], s)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

// A staging slot's four timing events: created (create != 0) or destroyed.
extern "C" int rp_leg_events(void** events, int n, int create) {
  for (int k = 0; k < n; ++k) {
    cudaError_t err = create ? cudaEventCreate((cudaEvent_t*)&events[k])
                             : cudaEventDestroy((cudaEvent_t)events[k]);
    if (err != cudaSuccess) return (int)err;
    if (!create) events[k] = nullptr;
  }
  return 0;
}

// Whether the leg fenced by `event` has completed: 0 (done), cudaErrorNotReady
// (600) while it runs, or the error that ended it.
extern "C" int rp_leg_query(void* event) { return (int)cudaEventQuery((cudaEvent_t)event); }

// Wait for a leg's last event, then its three intervals in ms: the copy up,
// the kernel (with the host's enqueue of it) and the copy down.
extern "C" int rp_leg_wait(void* const* events, float* ms) {
  cudaError_t err = cudaEventSynchronize((cudaEvent_t)events[3]);
  for (int k = 0; err == cudaSuccess && k < 3; ++k)
    err = cudaEventElapsedTime(&ms[k], (cudaEvent_t)events[k], (cudaEvent_t)events[k + 1]);
  return (int)err;
}
