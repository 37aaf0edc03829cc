// Generic DEFLATE token decode for Hopper (sm_90a): each stream's symbols
// from its own 15-bit litlen and distance tables.
//
// Replaces no Pallas kernel: the reference computes this function as an XLA
// scan, libflate_tpu/ops/deflate_decode.py `decode_symbols_chunked`
// (:81-127) and `decode_symbols` (:131-197), one lockstep step per symbol
// across the batch.  Torch ops cannot express a serial bit cursor without a
// launch per symbol, so the port runs it here: one thread per stream walks
// its cursor until the end-of-block symbol, a bad code, or the step budget.
//
// Semantics (each as the reference's step has it):
//   * a litlen entry is (sym << 4) | width; width 0 is a bad code;
//   * a length symbol takes li = clip(sym - 257, 0, 28), so the fixed
//     code's 286 / 287 decode as length 258 with no extra bits;
//   * a distance entry's symbol is clipped to [0, 29]; a length whose
//     distance entry has width 0 is a bad code;
//   * on a bad step the cursor still advances; the end bit is the cursor
//     after the last step taken (just past the EOB on success);
//   * token t is written at column t only while the stream is active and
//     the step is neither the EOB nor bad, and only below max_tokens;
//     n_tokens counts every written step, also those past max_tokens;
//   * a stream runs at most `steps` steps (the reference's chunked scan
//     length, a multiple of its chunk); err = bad or no EOB in that budget;
//   * a 15-bit peek at word w reads words min(w, W - 1) and min(w + 1,
//     W - 1) of its row, as XLA clamps a gather: reads never leave the row.
//
// What bounds it: latency.  A symbol is a chain of dependent loads: the
// word pair under the cursor (L1 after the first touch of a line), the
// litlen entry, and for a length the distance entry, both random in a
// 128 KiB table of the stream's own, so in L2 or device memory.  Only B
// threads run (1024 on the main path: under 8 a SM), so nothing hides the
// chain; chip_smoke.py prints the longest stream's steps times the
// dependent loads beside the bytes bound.  The design is the simple one:
// a thread a stream, tables read through L2, the peek from two 32-bit
// words; the output slots are zeroed by the wrapper, and a thread writes
// its row's tokens in order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTableBits = 15;

__constant__ int32_t c_len_base[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int32_t c_len_extra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int32_t c_dist_base[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
__constant__ int32_t c_dist_extra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// 15 bits (or fewer, by `mask`) of the row at bit `pos`, LSB first.
__device__ __forceinline__ uint32_t peek(const uint32_t* __restrict__ row,
                                         int n_words, int pos,
                                         uint32_t mask) {
  const int w = pos >> 5;
  const uint32_t sh = static_cast<uint32_t>(pos & 31);
  const uint32_t lo = __ldg(row + min(w, n_words - 1));
  const uint32_t hi = __ldg(row + min(w + 1, n_words - 1));
  return __funnelshift_r(lo, hi, sh) & mask;
}

__global__ void __launch_bounds__(kThreads)
decode_symbols_kernel(const uint32_t* __restrict__ words, int n_words,
                      const int32_t* __restrict__ start_bit,
                      const int32_t* __restrict__ lit_t,
                      const int32_t* __restrict__ dist_t,
                      const int32_t* __restrict__ table_idx, int n_streams,
                      int max_tokens, int64_t steps,
                      int32_t* __restrict__ a_out, int32_t* __restrict__ b_out,
                      int32_t* __restrict__ n_tokens,
                      int32_t* __restrict__ end_bit,
                      uint8_t* __restrict__ err) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_streams) return;
  const uint32_t* row = words + static_cast<int64_t>(s) * n_words;
  const int64_t tab = static_cast<int64_t>(table_idx ? table_idx[s] : s)
                      << kTableBits;
  const int32_t* lt = lit_t + tab;
  const int32_t* dt = dist_t + tab;
  int32_t* a_row = a_out + static_cast<int64_t>(s) * max_tokens;
  int32_t* b_row = b_out + static_cast<int64_t>(s) * max_tokens;
  constexpr uint32_t kMask = (1u << kTableBits) - 1;
  int pos = start_bit[s];
  bool done = false, bad = false;
  int64_t t = 0;
  for (; t < steps; ++t) {
    const int32_t e = __ldg(lt + peek(row, n_words, pos, kMask));
    const int width = e & 15;
    const int sym = e >> 4;
    const bool is_len = sym > 256;
    int p = pos + width;
    int a = sym, b = 0;
    bool step_bad = width == 0;
    if (is_len) {
      const int li = min(max(sym - 257, 0), 28);
      const int nb = c_len_extra[li];
      a = c_len_base[li] + static_cast<int>(
          peek(row, n_words, p, (1u << nb) - 1));
      p += nb;
      const int32_t de = __ldg(dt + peek(row, n_words, p, kMask));
      const int dwidth = de & 15;
      const int dsym = min(max(de >> 4, 0), 29);
      step_bad |= dwidth == 0;
      p += dwidth;
      const int dnb = c_dist_extra[dsym];
      b = c_dist_base[dsym] + static_cast<int>(
          peek(row, n_words, p, (1u << dnb) - 1));
      p += dnb;
    }
    pos = p;
    if (step_bad) {
      bad = true;
      break;
    }
    if (sym == 256) {
      done = true;
      break;
    }
    if (t < max_tokens) {
      a_row[t] = a;
      b_row[t] = b;
    }
  }
  // steps taken = t + 1 when the loop broke; the written ones exclude it
  n_tokens[s] = static_cast<int32_t>(t);
  end_bit[s] = pos;
  err[s] = bad || !done;
}

}  // namespace

// Launch the decode of n_streams rows of n_words words each.  lit_t and
// dist_t hold one 2^15-entry table per stream, or per table_idx[s] when
// table_idx is not null.  a_out / b_out (n_streams, max_tokens) must be
// zeroed by the caller.
extern "C" int lf_decode_symbols(const void* words, int n_words,
                                 const void* start_bit, const void* lit_t,
                                 const void* dist_t, const void* table_idx,
                                 int n_streams, int max_tokens, int64_t steps,
                                 void* a_out, void* b_out, void* n_tokens,
                                 void* end_bit, void* err, void* stream) {
  if (n_streams <= 0) return 0;
  if (n_words < 1 || max_tokens < 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_streams + kThreads - 1) / kThreads;
  decode_symbols_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(start_bit),
      static_cast<const int32_t*>(lit_t), static_cast<const int32_t*>(dist_t),
      static_cast<const int32_t*>(table_idx), n_streams, max_tokens, steps,
      static_cast<int32_t*>(a_out), static_cast<int32_t*>(b_out),
      static_cast<int32_t*>(n_tokens), static_cast<int32_t*>(end_bit),
      static_cast<uint8_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

// One thread follows `hops` links of the chain next[] (L2-only loads), so
// the time over hops is the latency of a dependent L2 load: chip_smoke.py
// takes the decode's latency bound from it, on a chain that fits the L2.
__global__ void load_chase_kernel(const int32_t* __restrict__ next,
                                  int64_t hops, int32_t* __restrict__ sink) {
  int32_t p = 0;
  for (int64_t i = 0; i < hops; ++i) p = __ldcg(next + p);
  *sink = p;
}

extern "C" int lf_load_chase(const void* next, int64_t hops, void* sink,
                             void* stream) {
  load_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), hops, static_cast<int32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// The kernel as compiled: out[0..3] = registers, static shared bytes,
// spill bytes, threads per block.
extern "C" int lf_decode_symbols_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, decode_symbols_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = kThreads;
  return 0;
}
