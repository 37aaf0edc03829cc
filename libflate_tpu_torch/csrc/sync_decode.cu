// Sync-indexed DEFLATE symbol decode for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_sync_decode.py
// `_sync_kernel` (wrapper `sync_decode`).  The PGZF encoder records the bit
// offset of every K-th token in the member header ("LS" subfield), so every
// K-token chunk decodes on its own: one thread per chunk slot runs the
// K-step symbol loop.
//
// Input is the whole stream uploaded once as little-endian 32-bit words
// plus each slot's absolute start bit; the TPU kernel's per-slot staged
// columns (a host byte gather) are not needed.  Words past the end read 0.
// Output is slot-major (n_slots, K) int32; token i of a slot is
// clip(a, 0, 511) | clip(b, 0, 65535) << 9 (a: literal byte or match
// length, b: distance, 0 for a literal), and entries past the slot's count
// are 0.  Invalid table entries (width 0) decode exactly as the reference
// does: symbol 0 of width 0.
//
// What bounds it: the chain, not bytes.  A 64 MiB shard reads ~22 MB of
// stream and writes ~68 MB of tokens (0.027 ms at 3.35 TB/s), but each
// slot is a chain of K dependent steps (window -> litlen lookup ->
// distance lookup -> cursor), and the main path has only ~66,560 slots:
// 16 warps a SM.  A step is almost all integer instructions (window
// select, two dependent shared lookups, field extraction); with 16 warps
// a SM the integer pipes set the pace, with a few the chain's latency
// does (chip_smoke.py prints the time a step takes both ways).  A thread
// per slot that loads its window from global memory and stores each
// token into its own 1 KiB row makes every warp access touch 32 cache
// lines, and the load/store unit sets the pace instead.  The design
// keeps that traffic off the chain:
//
// * Window in registers.  A thread keeps three aligned 16-byte quads of
//   the stream: q0:q1 hold the 64-bit window at the cursor (words c .. c
//   + 2 of them, c = cursor / 32 mod 4, funnel-shifted: the same bits as
//   the plain version's window), and the third is in flight.  A token
//   reads at most 48 bits, so a step moves the window by at most one
//   quad; each move issues one 16-byte load, about one every twelve
//   literals, and a load is first read at the move after the one that
//   issued it (a step that read the quad it had just loaded would wait
//   out the load's latency, and with 32 slots a warp some slot moves at
//   nearly every step).
// * Merged tables.  At block start the block builds, in shared memory,
//   one word per litlen root entry (width, length extra count, base: the
//   literal byte or the length base; and an is-length bit) and one per
//   distance root entry (width, extra count, base) from lit_t, dist_t and
//   the length / distance rows, with the clamps of the plain version, so
//   a token takes two shared lookups (six before).
// * Coalesced stores.  Each warp stages its 32 slots' tokens in a 32 x 32
//   tile in shared memory (pitch 33: a step's column writes and a flush's
//   row reads are both free of bank conflicts) and flushes it every 32
//   steps as one 128-byte line per slot row; steps past a slot's count
//   write 0, so the zero tail goes out the same way.  Any K >= 1 works:
//   the last flush writes the columns left, K - 32 * floor((K - 1) / 32).
// * A block of 64 threads, so the slots spread over every SM in blocks of
//   two warps (ops/sync_decode.kernel_info gives registers, shared memory
//   and resident blocks).
//
// The debug-checks form (the reference's kernel traced with
// LIBFLATE_DEBUG_CHECKS=1, pallas_sync_decode.py:63-77, :165-168) is a
// second instantiation of the same template, `kDebug`, with its own entry
// point; the default instantiation compiles as before.  The reference
// staged d_words words from each slot's start bit rounded down to a word,
// and marked a token with bit 30 (DEBUG_POISON) when its cursor, relative
// to that word, was past d_words * 32 - 55 at the token's start.  This
// kernel reads the whole stream, so it keeps that window's end as a bound
// and applies the same predicate to active tokens: a corrupt LS index or
// bitstream shows as a mark, which the host turns into a DeflateError.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLenCodes = 29;
constexpr int kDistCodes = 30;
constexpr int kRows = 2 * kLenCodes + 2 * kDistCodes;   // 118
constexpr int kDistRoot = 256;
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = 33;                               // tile row pitch

// Merged litlen entry: width (bits 0-3) | extra count (4-6) | base (7-15)
// | is-length (16).  A literal has extra count 0 and its byte as base.
__device__ __forceinline__ uint32_t merge_lit(int e, const int32_t* rows) {
  const int sym = e >> 4;
  const bool is_len = sym > 256;
  const int li = min(max(sym - 257, 0), kLenCodes - 1);
  const int nx = is_len ? rows[kLenCodes + li] : 0;
  const int base = is_len ? rows[li] : max(sym, 0);
  return static_cast<uint32_t>((e & 15) | nx << 4 | base << 7
                               | (is_len ? 1 << 16 : 0));
}

// Merged distance entry: width (bits 0-3) | extra count (4-7) | base (8-22).
__device__ __forceinline__ uint32_t merge_dist(int de, const int32_t* rows) {
  const int dsym = min(max(de >> 4, 0), kDistCodes - 1);
  return static_cast<uint32_t>(
      (de & 15) | rows[2 * kLenCodes + kDistCodes + dsym] << 4
      | rows[2 * kLenCodes + dsym] << 8);
}

// Quad q of the stream (words 4q .. 4q + 3), clamped to the last of the
// n_full whole quads so the load never leaves the stream; fix_quad then
// gives quads at or past n_full their true words.
__device__ __forceinline__ uint4 load_quad(const uint4* __restrict__ quads,
                                           int q, int n_full) {
  return __ldg(quads + min(q, n_full - 1));
}

// Quad q as loaded by load_quad: a whole quad as it is, quad n_full the
// stream's last n_words mod 4 words (`tail`, zero-padded), later ones 0.
__device__ __forceinline__ uint4 fix_quad(const uint4& v, int q, int n_full,
                                          const uint4& tail) {
  return q < n_full ? v : q == n_full ? tail : make_uint4(0, 0, 0, 0);
}

// A slot's decoder: quads qn and qn + 1 of the stream, the raw load of
// quad qn + 2, and the cursor's bit o (< 128) within q0:q1.
struct Window {
  uint4 q0, q1, p;
  int qn;
  uint32_t o;
};

// Decode the token at the cursor, packed a | b << 9, and move past it.
__device__ __forceinline__ uint32_t decode_token(
    Window& w, const uint32_t* s_lit, const uint32_t* s_dist,
    uint32_t root_mask, const uint4* __restrict__ quads, int n_full,
    const uint4& tail) {
  // words c .. c + 2 of q0:q1 (c = o / 32 <= 3), then the 64-bit window
  // hi:lo at bit o
  const bool c2 = w.o & 64, c1 = w.o & 32;
  const uint32_t y0 = c2 ? w.q0.z : w.q0.x, y1 = c2 ? w.q0.w : w.q0.y;
  const uint32_t y2 = c2 ? w.q1.x : w.q0.z, y3 = c2 ? w.q1.y : w.q0.w;
  const uint32_t x0 = c1 ? y1 : y0, x1 = c1 ? y2 : y1;
  const uint32_t x2 = c1 ? y3 : y2;
  const uint32_t lo = __funnelshift_r(x0, x1, w.o);
  const uint32_t hi = __funnelshift_r(x1, x2, w.o);
  const uint32_t e = s_lit[lo & root_mask];
  const uint32_t width = e & 15;
  const uint32_t nx = (e >> 4) & 7;
  // width + nx <= 20 bits, so the extra bits lie in lo
  const uint32_t a = ((e >> 7) & 511) + ((lo >> width) & ((1u << nx) - 1));
  // the distance code and its extra bits (<= 28) in the 32 bits from k2,
  // looked up for every token and used by lengths only
  const uint32_t k2 = width + nx;
  const uint32_t d = __funnelshift_r(lo, hi, k2);
  const uint32_t de = s_dist[d & (kDistRoot - 1)];
  const uint32_t dw = de & 15;
  const uint32_t dnx = (de >> 4) & 15;
  const bool is_len = e >> 16;
  const uint32_t b =
      is_len ? (de >> 8) + ((d >> dw) & ((1u << dnx) - 1)) : 0u;
  // adv <= 48 and o <= 127: the window moves by at most one quad
  w.o += is_len ? k2 + dw + dnx : width;
  if (w.o >= 128) {
    ++w.qn;
    w.q0 = w.q1;
    w.q1 = fix_quad(w.p, w.qn + 1, n_full, tail);
    w.p = load_quad(quads, w.qn + 2, n_full);
    w.o -= 128;
  }
  return a | b << 9;
}

constexpr uint32_t kDebugPoison = 1u << 30;

template <bool kDebug>
__global__ void __launch_bounds__(kThreads)
sync_decode_kernel(const uint32_t* __restrict__ words, int n_words,
                   const int64_t* __restrict__ start_bits,
                   const int32_t* __restrict__ counts,
                   const int32_t* __restrict__ lit_t,
                   const int32_t* __restrict__ dist_t,
                   const int32_t* __restrict__ rows, int root_bits,
                   int32_t* __restrict__ out, int n_slots, int k_tokens,
                   int d_words) {
  extern __shared__ uint32_t s_lit[];                    // 2^root_bits
  __shared__ uint32_t s_dist[kDistRoot];
  __shared__ int32_t s_rows[kRows];
  __shared__ int32_t s_tile[kWarps][32 * kPitch];
  const int lit_n = 1 << root_bits;
  for (int i = threadIdx.x; i < kRows; i += kThreads) s_rows[i] = rows[i];
  __syncthreads();
  for (int i = threadIdx.x; i < lit_n; i += kThreads)
    s_lit[i] = merge_lit(lit_t[i], s_rows);
  for (int i = threadIdx.x; i < kDistRoot; i += kThreads)
    s_dist[i] = merge_dist(dist_t[i], s_rows);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * kThreads
                        + (threadIdx.x & ~31);
  const int64_t slot = slot0 + lane;
  const bool live = slot < n_slots;
  const int cnt = live ? min(counts[slot], k_tokens) : 0;
  const int64_t cursor = cnt > 0 ? start_bits[slot] : 0;
  const uint4* quads = reinterpret_cast<const uint4*>(words);
  const int n_full = n_words >> 2;
  const int t0 = n_full << 2;
  const uint4 tail = make_uint4(
      t0 < n_words ? words[t0] : 0u, t0 + 1 < n_words ? words[t0 + 1] : 0u,
      t0 + 2 < n_words ? words[t0 + 2] : 0u, 0u);
  Window w;
  w.qn = static_cast<int>(cursor >> 7);
  w.o = static_cast<uint32_t>(cursor & 127);
  w.q0 = w.q1 = w.p = make_uint4(0, 0, 0, 0);
  if (cnt > 0) {
    w.q0 = fix_quad(load_quad(quads, w.qn, n_full), w.qn, n_full, tail);
    w.q1 = fix_quad(load_quad(quads, w.qn + 1, n_full), w.qn + 1, n_full,
                    tail);
    w.p = load_quad(quads, w.qn + 2, n_full);
  }
  const uint32_t root_mask = (1u << root_bits) - 1;
  int32_t* tile = s_tile[threadIdx.x >> 5] + lane * kPitch;
  // debug form: the last cursor that is not marked
  const int64_t limit = (cursor & ~int64_t{31})
                        + static_cast<int64_t>(d_words) * 32 - 55;

  for (int step0 = 0; step0 < k_tokens; step0 += 32) {
    if constexpr (kDebug) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        // the cursor at the token's start against the staged window
        const bool mark = static_cast<int64_t>(w.qn) * 128 + w.o > limit;
        tile[j] = step0 + j < cnt
            ? static_cast<int32_t>(decode_token(w, s_lit, s_dist, root_mask,
                                                quads, n_full, tail)
                                   | (mark ? kDebugPoison : 0u))
            : 0;
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < 32; ++j)
        tile[j] = step0 + j < cnt
            ? static_cast<int32_t>(decode_token(w, s_lit, s_dist, root_mask,
                                                quads, n_full, tail))
            : 0;
    }
    __syncwarp();
    // row i of the tile: slot slot0 + i, steps step0 .. step0 + 31
    const int cols = min(32, k_tokens - step0);
    if (lane < cols) {
      int32_t* dst = out + slot0 * k_tokens + step0 + lane;
      for (int i = 0; i < 32 && slot0 + i < n_slots; ++i)
        dst[static_cast<int64_t>(i) * k_tokens] =
            s_tile[threadIdx.x >> 5][i * kPitch + lane];
    }
    __syncwarp();
  }
}

size_t dynamic_smem(int root_bits) {
  return sizeof(uint32_t) << root_bits;
}

template <bool kDebug>
int launch_sync(const void* words, int64_t n_words, const void* start_bits,
                const void* counts, const void* lit_t, const void* dist_t,
                const void* rows, int root_bits, void* out, int n_slots,
                int k_tokens, int d_words, void* stream) {
  if (n_slots <= 0 || k_tokens <= 0) return 0;
  if (root_bits < 1 || root_bits > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte quads, at least one whole; cursors below 2^36 bits
  if ((reinterpret_cast<uintptr_t>(words) & 15) || n_words < 4
      || n_words > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // at most 16 KB (12-bit root) plus ~9.7 KB static: no opt-in needed
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  sync_decode_kernel<kDebug><<<blocks, kThreads, dynamic_smem(root_bits),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int>(n_words),
      static_cast<const int64_t*>(start_bits),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(lit_t), static_cast<const int32_t*>(dist_t),
      static_cast<const int32_t*>(rows), root_bits,
      static_cast<int32_t*>(out), n_slots, k_tokens, d_words);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDebug>
int sync_info(int root_bits, void* out) {
  int* o = static_cast<int*>(out);
  if (root_bits < 1 || root_bits > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sync_decode_kernel<kDebug>);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = static_cast<int>(dynamic_smem(root_bits));
  o[5] = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], sync_decode_kernel<kDebug>, kThreads, dynamic_smem(root_bits)));
}

}  // namespace

extern "C" int lf_sync_decode(const void* words, int64_t n_words,
                              const void* start_bits, const void* counts,
                              const void* lit_t, const void* dist_t,
                              const void* rows, int root_bits, void* out,
                              int n_slots, int k_tokens, void* stream) {
  return launch_sync<false>(words, n_words, start_bits, counts, lit_t, dist_t,
                            rows, root_bits, out, n_slots, k_tokens, 0,
                            stream);
}

// The debug-checks form: as lf_sync_decode, and a token whose cursor is
// past its slot's staged window of d_words words carries bit 30.
extern "C" int lf_sync_decode_debug(const void* words, int64_t n_words,
                                    const void* start_bits,
                                    const void* counts, const void* lit_t,
                                    const void* dist_t, const void* rows,
                                    int root_bits, int d_words, void* out,
                                    int n_slots, int k_tokens, void* stream) {
  return launch_sync<true>(words, n_words, start_bits, counts, lit_t, dist_t,
                           rows, root_bits, out, n_slots, k_tokens, d_words,
                           stream);
}

// The kernel as compiled: out[0..5] = registers, static shared bytes,
// spill bytes, dynamic shared bytes at root_bits, resident blocks per SM
// at that size, threads per block; lf_sync_debug_info for the debug form.
extern "C" int lf_sync_info(int root_bits, void* out) {
  return sync_info<false>(root_bits, out);
}

extern "C" int lf_sync_debug_info(int root_bits, void* out) {
  return sync_info<true>(root_bits, out);
}
