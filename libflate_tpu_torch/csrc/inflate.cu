// Generic DEFLATE token decode for Hopper (sm_90a): each stream's symbols
// from its own 15-bit litlen and distance tables.
//
// Replaces no Pallas kernel: the reference computes this function as an XLA
// scan, libflate_tpu/ops/deflate_decode.py `decode_symbols_chunked`
// (:81-127) and `decode_symbols` (:131-197), one lockstep step per symbol
// across the batch.  Torch ops cannot express a serial bit cursor without a
// launch per symbol, so the port runs it here: a warp per stream walks its
// cursor until the end-of-block symbol, a bad code, or the step budget.
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
// What bounds it: latency.  A symbol is a chain of dependent steps: the
// litlen entry under the cursor gives the width that places the next
// peek, and a length adds its extra bits, the distance entry and its
// extra bits.  The tables are any int32 of 2^15 entries a stream, 128 KiB
// each: the main path's 1024 generic members hold 1024 table pairs, 256
// MiB, five times the L2, so a thread that looks them up in device
// memory (this kernel's first design) waits out an HBM miss per lookup
// (~1.3 us a step measured).  This design takes the tables and the bits
// on chip:
//
// * A warp a stream, a block a warp.  The block's static shared memory
//   holds the stream's tables in a compact form and a word ring (21,504
//   bytes): 10 blocks fit on an SM, so the 1024 members run in one wave on
//   132 SMs (kernel_info gives the occupancy).  Every lane runs the same
//   decode in lockstep (broadcast shared loads, uniform branches), so the
//   lanes are there for the prologue, the ring and the stores.
// * Compact tables, built by the warp in a prologue from the reference's
//   15-bit tables (read once, int4 loads, coalesced).  A root of 2^R
//   entries (R = 10 litlen, 9 distance) is indexed by the peek's low R
//   bits; a prefix is uniform when its 2^(15-R) extensions all hold the
//   same entry, and its root entry is that entry.  Otherwise the root
//   entry is kSubtable | slot: the prefix's full extension is subtable
//   `slot` (32 or 64 entries), slots numbered by ascending prefix.  The
//   subtable area is fixed (80 litlen, 16 distance slots); a prefix past
//   it reads the original table in device memory, inside the kernel.  The
//   form is exact for every int32 table: ops/deflate_decode.
//   compact_tables_plain models it (its COMPACT holds the geometry), and
//   `lf_decode_compact_tables` dumps the kernel's own build for the card
//   tests to compare; the dump refuses a row width other than its own, so
//   a geometry that drifts from the model's fails there.
// * Merged entries.  What the decode reads from an entry is kept, and
//   nothing else: a litlen entry at or below 4111 (a literal, the EOB,
//   any negative value) stays as it is; a length entry becomes kLenMark |
//   base << 7 | extra bits << 4 | width (li clipped as above), a distance
//   entry base << 8 | extra bits << 4 | width (symbol clipped).  Neither
//   reaches kSubtable, so the root needs no flag array, and a match takes
//   no lookup of the length or distance rows.
// * A 64-bit bit buffer in registers, at least 15 bits at each step's
//   start.  A refill takes the next word, already in a register, when 32
//   bits or fewer are left, by selects (no branch); a step refills while
//   its root entry loads, and a match also before its distance code (20
//   bits may be gone) and after it (28 more).  The words come from a ring
//   of eight 32-word segments in shared memory, filled by 4-byte cp.async
//   a word a lane: every 32 steps the warp fetches through 5 segments
//   past the cursor's and waits for the previous fetch only, so a row's
//   load latency hides behind a batch of steps.
// * The next step's root entry is loaded before the step's bookkeeping
//   (exit test, token staging), which then runs in the load's shadow.
// * Coalesced stores.  Lane j keeps token j of a batch of 32 in registers;
//   each batch ends with one 128-byte line of a and one of b.  The wrapper
//   zeroes the outputs, as the contract needs the slots past n_tokens.
// What is left: a warp issues in order, and a step is a chain of ~45
// instructions for a literal, ~90 for a match, most waiting on the one
// before (~100 ns a token measured, against 14 ns for a dependent shared
// load).  chip_smoke.py prints the longest stream's dependent table loads
// times a dependent shared load (`lf_smem_chase`), beside the L2 one
// (`lf_load_chase`) and the bytes bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableBits = 15;
constexpr int kLitRoot = 10;
constexpr int kDistRoot = 9;
constexpr int kLitCap = 80;                 // litlen subtable slots
constexpr int kDistCap = 16;                // distance subtable slots
constexpr int kSegWords = 32;               // a ring segment: a word a lane
constexpr int kSegs = 8;                    // a power of two
constexpr int kRingWords = kSegWords * kSegs;
constexpr int kAhead = 5;                   // segments fetched ahead
constexpr int kBatch = 32;                  // steps between ring upkeeps
constexpr int32_t kSubtable = 0x40000000;   // root entry: kSubtable | slot
constexpr int32_t kLenMark = 1 << 20;       // merged length entry
constexpr int32_t kMaxLiteral = 4111;       // (256 << 4) | 15

// A stream's shared memory: the compact tables and the word ring (static,
// so that every lookup addresses it by an immediate offset).
struct Tables {
  int32_t lit_root[1 << kLitRoot];
  int32_t lit_sub[kLitCap << (kTableBits - kLitRoot)];
  int32_t dist_root[1 << kDistRoot];
  int32_t dist_sub[kDistCap << (kTableBits - kDistRoot)];
  uint32_t ring[kRingWords];
};
// the tables as lf_decode_compact_tables writes them: everything but the
// ring, in this order
constexpr int kTableWords = (sizeof(Tables) - sizeof(uint32_t) * kRingWords)
                            / sizeof(int32_t);
static_assert(kLitCap <= kRingWords && kDistCap <= kRingWords,
              "the build's slot list lives in the ring");
// A batch takes at most kBatch * 48 bits, and the word in nextw stays
// within 2 of the cursor's, so a batch reads words up to 50 past the one
// in nextw at its start: from segment c, segments c .. c + 2.  An upkeep
// at segment c fetches through c + kAhead - 1 and waits for the last
// one's fetch, which reached at least (c - 2) + kAhead - 1: the next
// batch's segments are in the ring, and the fetches in flight land in
// slots that no segment in use holds.
static_assert((kSegWords - 1) + kBatch * 48 / 32 + 2 < 3 * kSegWords
              && kAhead >= 5 && kAhead <= kSegs, "ring geometry");
constexpr int kMinBlocks = 10;              // blocks (streams) a SM
constexpr int kThreads = 32;                // a warp a stream
constexpr int kDynamicSmem = 0;             // each launch's dynamic shared
static_assert(kThreads == 32, "the lanes of one warp");

// The entry as the decode reads it (see the header).  Length rows
// (RFC 1951 3.2.5) by arithmetic, so that lanes holding different
// symbols do not serialise on a constant bank.
__device__ __forceinline__ int32_t merge_lit(int32_t e) {
  if (e <= kMaxLiteral) return e;
  const int li = min((e >> 4) - 257, 28);
  const int x = (li < 8 || li == 28) ? 0 : (li - 4) >> 2;
  const int base = li < 8 ? li + 3
                   : li == 28 ? 258 : ((4 + (li & 3)) << x) + 3;
  return kLenMark | (base << 7) | (x << 4) | (e & 15);
}

__device__ __forceinline__ int32_t merge_dist(int32_t e) {
  const int ds = min(max(e >> 4, 0), 29);
  const int x = ds < 4 ? 0 : (ds >> 1) - 1;
  const int base = ds < 4 ? ds + 1 : ((2 + (ds & 1)) << x) + 1;
  return (base << 8) | (x << 4) | (e & 15);
}

template <bool kLit>
__device__ __forceinline__ int32_t merge(int32_t e) {
  return kLit ? merge_lit(e) : merge_dist(e);
}

// Build one table's compact form from its 2^15 entries g: the root (2^R
// words), the first min(n, cap) subtables, with `list` (cap words) as
// scratch.  Returns n, the non-uniform prefixes.  Called by the whole warp.
template <int R, bool kLit>
__device__ int build_table(const int32_t* __restrict__ g,
                           int32_t* __restrict__ root,
                           int32_t* __restrict__ sub, int cap,
                           int32_t* __restrict__ list, int lane) {
  constexpr int kNX = 1 << (kTableBits - R);    // extensions a prefix
  constexpr int kM = (1 << R) / 128;            // int4 a lane in a row
  constexpr int kU = 16 / kM;                   // rows a batch: 16 int4
  constexpr int kK = kNX / 32;                  // extensions a lane
  static_assert(kM >= 1 && kNX % kU == 0 && kK >= 1, "geometry");
  const int4* g4 = reinterpret_cast<const int4*>(g);
  // lane l sees prefixes 128 m + 4 l + c of each row hi (entries
  // hi << R | prefix): bit 4 m + c of nonu marks a prefix whose entries
  // differ from row 0's
  int32_t first[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int4 q = __ldg(g4 + 32 * m + lane);
    first[m][0] = merge<kLit>(q.x);
    first[m][1] = merge<kLit>(q.y);
    first[m][2] = merge<kLit>(q.z);
    first[m][3] = merge<kLit>(q.w);
  }
  uint32_t nonu = 0;
  for (int hi = 0; hi < kNX; hi += kU) {
    int4 q[kU][kM];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        q[u][m] = __ldg(g4 + ((hi + u) << (R - 2)) + 32 * m + lane);
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const uint32_t d =
            static_cast<uint32_t>(merge<kLit>(q[u][m].x) != first[m][0])
            | static_cast<uint32_t>(merge<kLit>(q[u][m].y) != first[m][1]) << 1
            | static_cast<uint32_t>(merge<kLit>(q[u][m].z) != first[m][2]) << 2
            | static_cast<uint32_t>(merge<kLit>(q[u][m].w) != first[m][3]) << 3;
        nonu |= d << (4 * m);
      }
  }
  // slots by ascending prefix: a warp scan of each row group's counts
  int running = 0;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const uint32_t nib = (nonu >> (4 * m)) & 15u;
    const int cnt = __popc(nib);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    const int base = running + incl - cnt;
    int32_t v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = first[m][c];
      if ((nib >> c) & 1u) {
        const int slot = base + __popc(nib & ((1u << c) - 1u));
        v[c] = kSubtable | slot;
        if (slot < cap) list[slot] = 128 * m + 4 * lane + c;
      }
    }
    reinterpret_cast<int4*>(root)[32 * m + lane] =
        make_int4(v[0], v[1], v[2], v[3]);
    running += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }
  __syncwarp();
  // each listed prefix's extensions, four prefixes' loads in flight
  const int n = min(running, cap);
  for (int j = 0; j < n; j += 4) {
    int32_t x[4][kK];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = j + jj < n ? list[j + jj] : 0;
#pragma unroll
      for (int k = 0; k < kK; ++k)
        x[jj][k] = __ldg(g + ((lane + 32 * k) << R) + r);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int k = 0; k < kK; ++k)
        if (j + jj < n)
          sub[(j + jj) * kNX + lane + 32 * k] = merge<kLit>(x[jj][k]);
  }
  __syncwarp();
  return running;
}

// The merged entry for the 15-bit peek idx, from its root entry v: v
// itself, its subtable's, or past the subtable area the original table
// g's.  Split from the root load so that independent work can be placed
// between the two.
template <int R, bool kLit>
__device__ __forceinline__ int32_t resolve(int32_t v, const int32_t* sub,
                                           int cap,
                                           const int32_t* __restrict__ g,
                                           uint32_t idx) {
  if (v >= kSubtable) {
    const int slot = v - kSubtable;
    v = slot < cap ? sub[(slot << (kTableBits - R)) | (idx >> R)]
                   : merge<kLit>(__ldg(g + idx));
  }
  return v;
}

// Both tables of one stream into t; the ring's words serve as the slot
// list.  Returns n (litlen) in .x and n (distance) in .y.
__device__ int2 build_tables(const int32_t* __restrict__ lt,
                             const int32_t* __restrict__ dt, Tables& t,
                             int lane) {
  int32_t* list = reinterpret_cast<int32_t*>(t.ring);
  int2 n;
  n.x = build_table<kLitRoot, true>(lt, t.lit_root, t.lit_sub, kLitCap,
                                    list, lane);
  n.y = build_table<kDistRoot, false>(dt, t.dist_root, t.dist_sub, kDistCap,
                                      list, lane);
  return n;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_symbols_kernel(const uint32_t* __restrict__ words, int n_words,
                      const int32_t* __restrict__ start_bit,
                      const int32_t* __restrict__ lit_t,
                      const int32_t* __restrict__ dist_t,
                      const int32_t* __restrict__ table_idx,
                      int max_tokens, int64_t steps,
                      int32_t* __restrict__ a_out, int32_t* __restrict__ b_out,
                      int32_t* __restrict__ n_tokens,
                      int32_t* __restrict__ end_bit,
                      uint8_t* __restrict__ err) {
  __shared__ __align__(16) Tables tb;
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* row = words + static_cast<int64_t>(s) * n_words;
  const int64_t tab = static_cast<int64_t>(table_idx ? table_idx[s] : s)
                      << kTableBits;
  const int32_t* lt = lit_t + tab;
  const int32_t* dt = dist_t + tab;
  const int last = n_words - 1;
  // the row's first words, in flight while the tables build: the two
  // under the start bit and the ring's first kAhead segments from word
  // w0 + 2 on
  const int pos0 = start_bit[s];
  const int w0 = pos0 >> 5;
  int wn = w0 + 2;                          // the word in `nextw`
  int fetched = wn / kSegWords;             // the next segment to fetch
  const uint32_t lo = __ldg(row + min(w0, last));
  const uint32_t hi = __ldg(row + min(w0 + 1, last));
  uint32_t seg[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    seg[k] = __ldg(row + min((fetched + k) * kSegWords + lane, last));
  build_tables(lt, dt, tb, lane);
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    tb.ring[((fetched + k) & (kSegs - 1)) * kSegWords + lane] = seg[k];
  fetched += kAhead;
  __syncwarp();
  // bits [pos, pos + nb) of the row in bb, LSB first: pos = 32 wn - nb;
  // at the start of each step nb >= 15, the litlen peek
  uint64_t bb = ((static_cast<uint64_t>(hi) << 32) | lo) >> (pos0 & 31);
  int nb = 64 - (pos0 & 31);
  uint32_t nextw = tb.ring[wn & (kRingWords - 1)];
  // take nextw when nb <= 32 (then nb >= 33), by selects: no branch
  const auto refill = [&]() {
    const bool need = nb <= 32;
    bb |= static_cast<uint64_t>(need ? nextw : 0u) << (nb & 63);
    nb += need ? 32 : 0;
    wn += need ? 1 : 0;
    nextw = tb.ring[wn & (kRingWords - 1)];
  };
  int32_t* a_row = a_out + static_cast<int64_t>(s) * max_tokens;
  int32_t* b_row = b_out + static_cast<int64_t>(s) * max_tokens;
  int32_t v = 0, dv = 1;                    // the last step's entries
  int64_t t = 0;                            // tokens written so far
  bool stop = false;
  // the next step's peek and root entry: each step loads the next one's
  // before its own bookkeeping (exit test, token staging)
  uint32_t idx = static_cast<uint32_t>(bb) & 0x7FFFu;
  int32_t root = tb.lit_root[idx & ((1u << kLitRoot) - 1u)];
  while (t < steps) {
    // a batch of up to kBatch steps; token j of it stays on lane j
    const int n = static_cast<int>(min(int64_t{kBatch}, steps - t));
    int32_t ka = 0, kb = 0;
    int j = 0;
    for (; j < n; ++j) {
      // only bits above the peek change: this runs while the load flies
      refill();
      v = resolve<kLitRoot, true>(root, tb.lit_sub, kLitCap, lt, idx);
      const int width = v & 15;
      bb >>= width;
      nb -= width;
      int a = v >> 4, b = 0;
      dv = 1;
      if (v > kMaxLiteral) {                // a length: merged entry
        const int lx = (v >> 4) & 7;
        a = ((v >> 7) & 511)
            + static_cast<int>(static_cast<uint32_t>(bb) & ((1u << lx) - 1u));
        bb >>= lx;
        nb -= lx;
        refill();
        const uint32_t didx = static_cast<uint32_t>(bb) & 0x7FFFu;
        dv = resolve<kDistRoot, false>(
            tb.dist_root[didx & ((1u << kDistRoot) - 1u)], tb.dist_sub,
            kDistCap, dt, didx);
        const int dw = dv & 15;
        const int dx = (dv >> 4) & 15;
        bb >>= dw;
        nb -= dw;
        b = (dv >> 8)
            + static_cast<int>(static_cast<uint32_t>(bb) & ((1u << dx) - 1u));
        bb >>= dx;
        nb -= dx;
        refill();                           // nb >= 15 for the next peek
      }
      idx = static_cast<uint32_t>(bb) & 0x7FFFu;
      root = tb.lit_root[idx & ((1u << kLitRoot) - 1u)];
      // a bad code (either width 0) or the EOB ends the stream
      if ((width == 0) | ((dv & 15) == 0) | ((v >> 4) == 256)) {
        stop = true;
        break;
      }
      ka = lane == j ? a : ka;
      kb = lane == j ? b : kb;
    }
    if (lane < j && t + lane < max_tokens) {
      a_row[t + lane] = ka;
      b_row[t + lane] = kb;
    }
    t += j;
    if (stop) break;
    // ring upkeep: fetch through segment (wn / 32) + kAhead - 1, and wait
    // for the last batch's fetch, which covers the next batch's words
    const int want = wn / kSegWords + kAhead;
    for (; fetched < want; ++fetched)
      cp_async4(&tb.ring[(fetched & (kSegs - 1)) * kSegWords + lane],
                row + min(fetched * kSegWords + lane, last));
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (lane == 0) {
    const bool bad = stop && ((v & 15) == 0 || (dv & 15) == 0);
    n_tokens[s] = static_cast<int32_t>(t);
    end_bit[s] = static_cast<int32_t>(int64_t{wn} * 32 - nb);
    err[s] = bad || !stop;
  }
}

// The layout of each table pair as the decode builds it, for the tests:
// out row p = [litlen root, litlen subtables, distance root, distance
// subtables, n litlen, n distance] (kTableWords + 2 words); subtable
// slots past n are 0.
__global__ void __launch_bounds__(kThreads)
compact_tables_kernel(const int32_t* __restrict__ lit_t,
                      const int32_t* __restrict__ dist_t,
                      int32_t* __restrict__ out) {
  __shared__ __align__(16) Tables tb;
  int32_t* words = reinterpret_cast<int32_t*>(&tb);
  const int lane = threadIdx.x;
  const int64_t tab = static_cast<int64_t>(blockIdx.x) << kTableBits;
  for (int i = lane; i < kTableWords; i += 32) words[i] = 0;
  __syncwarp();
  const int2 n = build_tables(lit_t + tab, dist_t + tab, tb, lane);
  int32_t* o = out + static_cast<int64_t>(blockIdx.x) * (kTableWords + 2);
  for (int i = lane; i < kTableWords; i += 32) o[i] = words[i];
  if (lane == 0) {
    o[kTableWords] = n.x;
    o[kTableWords + 1] = n.y;
  }
}

// The carveout preference is per device: set once on each to the most
// shared memory, so that kMinBlocks blocks fit.
cudaError_t prepare() {
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(decode_symbols_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launch the decode of n_streams rows of n_words words each.  lit_t and
// dist_t (16-byte aligned) hold one 2^15-entry table per stream, or per
// table_idx[s] when table_idx is not null.  a_out / b_out (n_streams,
// max_tokens) must be zeroed by the caller.
extern "C" int lf_decode_symbols(const void* words, int n_words,
                                 const void* start_bit, const void* lit_t,
                                 const void* dist_t, const void* table_idx,
                                 int n_streams, int max_tokens, int64_t steps,
                                 void* a_out, void* b_out, void* n_tokens,
                                 void* end_bit, void* err, void* stream) {
  if (n_streams <= 0) return 0;
  if (n_words < 1 || max_tokens < 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(lit_t) || !aligned16(dist_t))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_symbols_kernel<<<n_streams, kThreads, kDynamicSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(start_bit),
      static_cast<const int32_t*>(lit_t), static_cast<const int32_t*>(dist_t),
      static_cast<const int32_t*>(table_idx), max_tokens, steps,
      static_cast<int32_t*>(a_out), static_cast<int32_t*>(b_out),
      static_cast<int32_t*>(n_tokens), static_cast<int32_t*>(end_bit),
      static_cast<uint8_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

// The compact layout of n_tables table pairs (16-byte aligned) into out
// (n_tables, row_words) int32: see compact_tables_kernel.  A row_words
// other than the kernel's own row is refused (cudaErrorInvalidValue).
extern "C" int lf_decode_compact_tables(const void* lit_t, const void* dist_t,
                                        int n_tables, int row_words, void* out,
                                        void* stream) {
  if (row_words != kTableWords + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tables <= 0) return 0;
  if (!aligned16(lit_t) || !aligned16(dist_t))
    return static_cast<int>(cudaErrorMisalignedAddress);
  compact_tables_kernel<<<n_tables, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lit_t), static_cast<const int32_t*>(dist_t),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One thread follows `hops` links of the chain next[] (L2-only loads), so
// the time over hops is the latency of a dependent L2 load: chip_smoke.py
// takes the first design's latency bound from it, on a chain that fits the
// L2.
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

// The same chase in shared memory: next[] (kChaseWords entries, a cycle)
// is staged by the block, then one thread follows `hops` links, so the
// time over hops is the latency of a dependent shared load, the step the
// decode's lookups are bound by.
constexpr int kChaseWords = 4096;

__global__ void smem_chase_kernel(const int32_t* __restrict__ next,
                                  int64_t hops, int32_t* __restrict__ sink) {
  __shared__ int32_t ring[kChaseWords];
  for (int i = threadIdx.x; i < kChaseWords; i += blockDim.x)
    ring[i] = next[i] & (kChaseWords - 1);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t p = 0;
  for (int64_t i = 0; i < hops; ++i) p = ring[p];
  *sink = p;
}

extern "C" int lf_smem_chase(const void* next, int64_t hops, void* sink,
                             void* stream) {
  smem_chase_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), hops, static_cast<int32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel as compiled and launched: out[0..5] = registers,
// static shared, spill (local) bytes and the most threads a block (the
// launch bounds: one warp), as the runtime reports them; the dynamic
// shared bytes each launch asks for; the resident blocks (streams) an SM
// at that launch, from the occupancy API.
extern "C" int lf_decode_symbols_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, decode_symbols_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = fa.maxThreadsPerBlock;
  o[4] = kDynamicSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[5], decode_symbols_kernel, kThreads, kDynamicSmem));
}
