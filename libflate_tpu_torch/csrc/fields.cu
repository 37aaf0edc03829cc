// Token statistics and entropy-coding fields for Hopper (sm_90a).
//
// lf_token_hist replaces libflate_tpu/ops/pallas_hist.py `_hist_kernel`
// (via `shared_histograms_pallas`): the batch-global litlen and distance
// symbol counts of the padded token slots, the reference's bins for any
// int32 a and b.  A valid slot packs w = lo | hi << 9: lo is its literal,
// or for a match (b > 0) the length symbol by the reference's unclamped
// int32 arithmetic (length_symbol_arith), hi the match's distance symbol
// + 1 (dist_symbol_arith).  It counts bin w & 511 when that is below 288
// and bin 287 + (w >> 9) when w >> 9 lies in [1, 32], as the reference's
// row-group sweep does.  In DEFLATE's ranges that is bin a for a literal,
// bins 257..285 and 288 + distance symbol for a match.  Bins 286, 287,
// 318 and 319 are dropped by the glue, which adds one END_OF_BLOCK per
// member and the dummy distance code; invalid slots do not count.  The
// TPU kernel keeps one bin column per member lane and sweeps
// compare-selects over 40 row groups; nothing of that carries over.
//
// What bounds it: bytes.  It must read every valid byte, and a and b
// only where a slot is valid: at the encode's shape (128 x 49152 slots,
// about a third valid, in runs) that is ~23 MB, 0.007 ms at 3.35 TB/s
// (chip_smoke.py counts the 32-byte sectors of a and b that hold a valid
// slot); reading every slot would be 57 MB.  Its design, one launch:
//
// * 16-byte loads: a thread reads the four valid bytes of a group of four
//   slots as one word and, unless all four are invalid, their a and b as
//   int4.  Tensors whose data pointers are not so aligned take a scalar
//   grid-stride loop, as does the tail of n mod 4 slots.
// * One sub-histogram per warp in shared memory (16 x 320 bins), so a
//   shared atomic waits only on lanes of its own warp (Zipf text puts
//   most literals in a few bins).
// * No memset: the wrapper keeps a 321-word state per stream, zero when
//   no launch runs: 320 accumulator bins and a ticket.  Each block adds
//   its nonzero bins to the accumulator with global atomics, fences, and
//   takes a ticket with atomicInc(ticket, blocks - 1), which wraps to 0
//   at the last block; the block that draws blocks - 1 moves the
//   accumulator into `bins` with atomicExch(acc, 0), leaving the state
//   zero again.  Integer sums do not depend on order, so the bins are
//   exact.
//
// lf_token_fields replaces libflate_tpu/ops/pallas_fields.py
// `token_fields_pallas` / `_fields_compute`: per token slot the first
// field (literal or length code, bit-reversed, plus the length's extra
// bits) and the second (distance code plus extra bits) as (value, width)
// pairs, with the code tables shared by the batch (stride 0) or given per
// member, and a slot valid iff slot < n_tokens[member] (when given) and
// a >= 0; an invalid slot gets widths 0.  The TPU kernel looks every
// table up with lane shuffles over 128-entry row groups and finds the
// distance code from a float exponent; nothing of that carries over.
//
// What bounds it: bytes.  It reads a and b and writes four int32 a slot
// (24 bytes: 151 MB, 0.045 ms at 3.35 TB/s for the encode's 128 x 49152
// slots); the tables are ~6 KB a member.  Its design:
//
// * Merged entries: a block turns its member's raw tables into one
//   32-bit f1 entry per literal (0..255) and per match length (0..258),
//   value rev[sym] | extra << w[sym] in bits 0..19 and width w[sym] +
//   nextra in bits 20..31, and one f2 entry per distance symbol, rev in
//   bits 0..15 and width above.  Exact for DEFLATE's ranges (widths <=
//   15, rev < 2^15, length extra < 2^5), which ops/fields.field_tables
//   checks before it uploads a table.  A slot then takes one shared
//   lookup for each field; the distance symbol, its base and extra-bit
//   count come from the highest set bit of d - 1.
// * A persistent grid sized to the resident blocks; each block takes a
//   contiguous range of 4096-slot tiles in member-major order, so it
//   rebuilds its entries only where its range crosses into another
//   member (a stride-0 table: once a launch).
// * 16-byte accesses: a thread loads four groups of four slots of a and
//   b as int4 before it computes any, and before the block builds its
//   entries, and stores each output as int4, streaming (the outputs are
//   twice the L2).  Unaligned tensors or rows of M % 4 != 0 slots take a
//   scalar loop over the same tiles.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 320;
constexpr int kDistBase = 288;
constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;     // sub-histograms a block
constexpr int kFieldThreads = 256;
constexpr int kMaxMatch = 258;
constexpr int kMaxDistance = 32768;

// the tables operand, one int32 array:
//   lit_rev (288) | lit_w (288) | dist_rev (30) | dist_w (30) |
//   len_code (259) | len_nextra (259) | len_extra (259) |
//   dist_base (30) | dist_nextra (30)
constexpr int kLitRev = 0, kLitW = 288, kDistRev = 576, kDistW = 606;
constexpr int kLenCode = 636, kLenNextra = kLenCode + kMaxMatch + 1;
constexpr int kLenExtra = kLenNextra + kMaxMatch + 1;
constexpr int kDistBaseT = kLenExtra + kMaxMatch + 1;
constexpr int kDistNextra = kDistBaseT + 30;
constexpr int kTables = kDistNextra + 30;

// RFC-1951 length (3..258) -> litlen symbol 257..285; any other int32
// length gets the reference's length_symbol_arith value: length - 3
// wraps, at most 5 extra bits, no clamp
__device__ __forceinline__ int length_symbol(int length) {
  const int l = static_cast<int>(static_cast<uint32_t>(length) - 3u);
  if (length == kMaxMatch) return 285;
  if (l < 8) return 257 + l;
  const int e = min((31 - __clz(l)) - 2, 5);  // extra bits, 1..5
  return 257 + 4 * e + 4 + ((l >> e) & 3);
}

// distance (1..32768) -> distance symbol 0..29; a larger distance gets
// dist_symbol_arith's value (at most 13 extra bits)
__device__ __forceinline__ int dist_symbol(int dist) {
  const int d = dist - 1;
  if (d < 4) return d;
  const int e = min((31 - __clz(d)) - 1, 13);  // extra bits, 1..13
  return 2 * e + 2 + ((d >> e) & 1);
}

__device__ __forceinline__ void count_slot(int* h, int av, int bv,
                                           bool ok) {
  if (!ok) return;
  const int lo = bv > 0 ? length_symbol(av) : av;
  const int hi = bv > 0 ? dist_symbol(bv) + 1 : 0;
  const int lb = lo & 511;
  const int db = (lo >> 9) | hi;
  if (lb < kDistBase) atomicAdd(&h[lb], 1);
  if (db >= 1 && db <= kBins - kDistBase)
    atomicAdd(&h[kDistBase - 1 + db], 1);
}

__device__ __forceinline__ void count_four(int* h, const int4& a,
                                           const int4& b, uint32_t v) {
  count_slot(h, a.x, b.x, v & 0xff);
  count_slot(h, a.y, b.y, (v >> 8) & 0xff);
  count_slot(h, a.z, b.z, (v >> 16) & 0xff);
  count_slot(h, a.w, b.w, v >> 24);
}

__global__ void __launch_bounds__(kHistThreads)
token_hist_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b,
                  const uint8_t* __restrict__ valid, int64_t n_slots,
                  bool vec, int32_t* __restrict__ bins,
                  int32_t* __restrict__ state) {
  __shared__ int sub[kHistWarps][kBins];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kHistWarps * kBins; i += kHistThreads)
    (&sub[0][0])[i] = 0;
  __syncthreads();
  int* h = sub[threadIdx.x >> 5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kHistThreads
                      + threadIdx.x;
  int64_t i = tid;                          // first scalar slot
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    const uint32_t* v4 = reinterpret_cast<const uint32_t*>(valid);
    const int64_t n4 = n_slots >> 2;
    for (int64_t g = tid; g < n4; g += stride) {
      // a group of four invalid slots needs neither a nor b
      const uint32_t vv = __ldg(v4 + g);
      if (vv) count_four(h, __ldg(a4 + g), __ldg(b4 + g), vv);
    }
    i = 4 * n4 + tid;
  }
  for (; i < n_slots; i += stride)
    if (valid[i]) count_slot(h, a[i], b[i], true);
  __syncthreads();

  int32_t* acc = state;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(state + kBins);
  for (int k = threadIdx.x; k < kBins; k += kHistThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) s += sub[w][k];
    if (s) atomicAdd(&acc[k], s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int k = threadIdx.x; k < kBins; k += kHistThreads)
      bins[k] = atomicExch(&acc[k], 0);
  }
}

// f1 entries: literal 0..255, then match length 0..258; f2: distance
constexpr int kF1Len = 256;
constexpr int kF1 = kF1Len + kMaxMatch + 1;
constexpr int kF2 = 30;

__device__ __forceinline__ int table_sym(int s) {
  return min(max(s, 0), kDistBase - 1);
}

// the merged entries of one member's tables (the caller syncs)
__device__ void build_entries(const int32_t* __restrict__ t, uint32_t* f1,
                              uint32_t* f2) {
  for (int i = threadIdx.x; i < kF1 + kF2; i += blockDim.x) {
    if (i < kF1Len) {
      f1[i] = static_cast<uint32_t>(__ldg(t + kLitRev + i))
              | static_cast<uint32_t>(__ldg(t + kLitW + i)) << 20;
    } else if (i < kF1) {
      const int len = i - kF1Len;
      const int sym = table_sym(__ldg(t + kLenCode + len));
      const uint32_t w = __ldg(t + kLitW + sym);
      f1[i] = (static_cast<uint32_t>(__ldg(t + kLitRev + sym))
               | static_cast<uint32_t>(__ldg(t + kLenExtra + len)) << w)
              | (w + __ldg(t + kLenNextra + len)) << 20;
    } else {
      const int ds = i - kF1;
      f2[ds] = static_cast<uint32_t>(__ldg(t + kDistRev + ds))
               | static_cast<uint32_t>(__ldg(t + kDistW + ds)) << 16;
    }
  }
}

struct Fields {
  int v1, w1, v2, w2;
};

// one slot from the merged entries; `live`: slot < n_tokens
__device__ __forceinline__ Fields field_slot(int av, int bv, bool live,
                                             const uint32_t* f1,
                                             const uint32_t* f2) {
  const bool valid = live && av >= 0;
  const bool is_match = valid && bv > 0;
  const uint32_t e1 =
      f1[is_match ? kF1Len + min(av, kMaxMatch) : (valid ? min(av, 255) : 0)];
  const int dm = min(max(bv, 1), kMaxDistance) - 1;
  const int ds = dist_symbol(dm + 1);
  const int nx = ds < 4 ? 0 : (ds >> 1) - 1;      // the code's extra bits
  const uint32_t e2 = f2[ds];
  const int dw = static_cast<int>(e2 >> 16);
  Fields f;
  f.v1 = valid ? static_cast<int>(e1 & 0xfffff) : 0;
  f.w1 = valid ? static_cast<int>(e1 >> 20) : 0;
  f.v2 = is_match ? static_cast<int>(e2 & 0xffff)
                        | ((dm & ((1 << nx) - 1)) << dw) : 0;
  f.w2 = is_match ? dw + nx : 0;
  return f;
}

constexpr int kFieldGroups = 4;                    // int4 groups a thread
constexpr int kFieldTile = kFieldThreads * 4 * kFieldGroups;   // slots

// a, b, f*: n_members rows of m slots; tables: n_members rows of
// kTables words, table_stride apart (0: one shared row); n_tokens: one
// count a member, or null (every slot below m counts).  vec: a, b and the
// outputs 16-byte aligned and m % 4 == 0.
__global__ void __launch_bounds__(kFieldThreads)
token_fields_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b,
                    const int32_t* __restrict__ tables, int table_stride,
                    const int32_t* __restrict__ n_tokens, int64_t m,
                    int64_t tiles_per_member, int64_t n_tiles, bool vec,
                    int32_t* __restrict__ f1v, int32_t* __restrict__ f1w,
                    int32_t* __restrict__ f2v, int32_t* __restrict__ f2w) {
  __shared__ uint32_t f1[kF1];
  __shared__ uint32_t f2[kF2];
  const int64_t t_end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  int64_t member = -1;
  for (int64_t t = n_tiles * blockIdx.x / gridDim.x; t < t_end; ++t) {
    const int64_t mb = t / tiles_per_member;
    const int64_t lo = (t - mb * tiles_per_member) * kFieldTile;
    const int64_t hi = min(lo + kFieldTile, m);
    const int64_t row = mb * m;
    // the tile's loads fly while the block builds its entries
    int4 av[kFieldGroups], bv[kFieldGroups];
    if (vec) {
#pragma unroll
      for (int k = 0; k < kFieldGroups; ++k) {
        const int64_t s = lo + 4 * (threadIdx.x + k * kFieldThreads);
        if (s < hi) {
          av[k] = __ldg(reinterpret_cast<const int4*>(a + row + s));
          bv[k] = __ldg(reinterpret_cast<const int4*>(b + row + s));
        }
      }
    }
    if (member < 0 || (mb != member && table_stride != 0)) {
      if (member >= 0) __syncthreads();     // the old entries are read
      build_entries(tables + mb * table_stride, f1, f2);
      __syncthreads();
    }
    member = mb;
    const int64_t live_end =
        n_tokens == nullptr ? hi : min(hi, static_cast<int64_t>(
                                               max(__ldg(n_tokens + mb), 0)));
    if (vec) {
#pragma unroll
      for (int k = 0; k < kFieldGroups; ++k) {
        const int64_t s = lo + 4 * (threadIdx.x + k * kFieldThreads);
        if (s >= hi) continue;
        const Fields x = field_slot(av[k].x, bv[k].x, s < live_end, f1, f2);
        const Fields y = field_slot(av[k].y, bv[k].y, s + 1 < live_end, f1,
                                    f2);
        const Fields z = field_slot(av[k].z, bv[k].z, s + 2 < live_end, f1,
                                    f2);
        const Fields w = field_slot(av[k].w, bv[k].w, s + 3 < live_end, f1,
                                    f2);
        __stcs(reinterpret_cast<int4*>(f1v + row + s),
               make_int4(x.v1, y.v1, z.v1, w.v1));
        __stcs(reinterpret_cast<int4*>(f1w + row + s),
               make_int4(x.w1, y.w1, z.w1, w.w1));
        __stcs(reinterpret_cast<int4*>(f2v + row + s),
               make_int4(x.v2, y.v2, z.v2, w.v2));
        __stcs(reinterpret_cast<int4*>(f2w + row + s),
               make_int4(x.w2, y.w2, z.w2, w.w2));
      }
    } else {
      for (int64_t s = lo + threadIdx.x; s < hi; s += kFieldThreads) {
        const Fields f = field_slot(__ldg(a + row + s), __ldg(b + row + s),
                                    s < live_end, f1, f2);
        f1v[row + s] = f.v1;
        f1w[row + s] = f.w1;
        f2v[row + s] = f.v2;
        f2w[row + s] = f.w2;
      }
    }
  }
}

}  // namespace

// state: kBins + 1 int32, zero before the launch and zero after it (one
// launch at a time on it: the wrapper keeps one per stream).
extern "C" int lf_token_hist(const void* a, const void* b, const void* valid,
                             int64_t n_slots, void* bins, void* state,
                             void* stream) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, token_hist_kernel, kHistThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_blocks = sms * per_sm;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(a)
                     | reinterpret_cast<uintptr_t>(b)) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  const int64_t per_block = int64_t{kHistThreads} * (vec ? 4 : 1);
  int64_t blocks = (n_slots + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > max_blocks ? max_blocks : blocks);
  token_hist_kernel<<<static_cast<int>(blocks), kHistThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const uint8_t*>(valid), n_slots < 0 ? 0 : n_slots, vec,
      static_cast<int32_t*>(bins), static_cast<int32_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

// The histogram kernel as compiled: out[0..6] = registers, static shared
// bytes, spill bytes, dynamic shared bytes (0), resident blocks per SM,
// threads per block, sub-histograms per block.
extern "C" int lf_hist_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, token_hist_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = 0;
  o[5] = kHistThreads;
  o[6] = kHistWarps;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], token_hist_kernel, kHistThreads, 0));
}

// a, b, the outputs: n_members x m int32; tables: n_members rows of
// kTables int32 table_stride apart (0: one row for all); n_tokens: null
// or n_members int32.
extern "C" int lf_token_fields(const void* a, const void* b,
                               const void* tables, int table_stride,
                               const void* n_tokens, int n_members,
                               int64_t m, void* f1v, void* f1w, void* f2v,
                               void* f2w, void* stream) {
  if (n_members <= 0 || m <= 0) return 0;
  if (table_stride != 0 && table_stride != kTables)
    return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, token_fields_kernel, kFieldThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_blocks = sms * per_sm;
  }
  const bool vec = m % 4 == 0
                   && ((reinterpret_cast<uintptr_t>(a)
                        | reinterpret_cast<uintptr_t>(b)
                        | reinterpret_cast<uintptr_t>(f1v)
                        | reinterpret_cast<uintptr_t>(f1w)
                        | reinterpret_cast<uintptr_t>(f2v)
                        | reinterpret_cast<uintptr_t>(f2w)) & 15) == 0;
  const int64_t tiles_per_member = (m + kFieldTile - 1) / kFieldTile;
  const int64_t n_tiles = tiles_per_member * n_members;
  const int64_t blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  token_fields_kernel<<<static_cast<int>(blocks), kFieldThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(tables), table_stride,
      static_cast<const int32_t*>(n_tokens), m, tiles_per_member, n_tiles,
      vec, static_cast<int32_t*>(f1v), static_cast<int32_t*>(f1w),
      static_cast<int32_t*>(f2v), static_cast<int32_t*>(f2w));
  return static_cast<int>(cudaGetLastError());
}

// The fields kernel as compiled: out[0..6] = registers, static shared
// bytes, spill bytes, dynamic shared bytes (0), resident blocks per SM,
// threads per block, slots a tile.
extern "C" int lf_fields_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, token_fields_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = 0;
  o[5] = kFieldThreads;
  o[6] = kFieldTile;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], token_fields_kernel, kFieldThreads, 0));
}
