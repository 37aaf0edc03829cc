// Output-position rank + LZ77 mod-collapse for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_rank.py `_rank_kernel`
// with emit="src" (`_rank_one`, wrapper `rank_emit_src`).  For every output
// position p of a member it finds the token the reference reads: the
// covering token, the last valid one whose start is <= p (invalid slots
// read out_cap + 2), wherever no start repeats; a tile where one does, or
// where no token covers its first position, is left to a second kernel,
// rank_ref_kernel, which runs the reference's bounded search (ref_row
// below: at most 128 starts a 128-position row, a 2048-slot window a
// 1024-position vreg, slot 127 where no token covers p).  It emits
//   src[p] = p                        for a literal (a fixpoint), and
//   src[p] = (p - s) mod d + s - d    for a match of distance d starting
//                                     at s (floor mod: the pre-token
//                                     source, so a pointer chase crosses
//                                     a token at every step), and
//   lit[p] = the literal byte, or 0.
// Positions at or past n_out[b] get src = p and lit = 0; live sources are
// clipped to [0, out_cap - 1].
//
// What bounds it: bytes.  It must write 8 bytes per output position (src
// and lit: 512 MiB for a 64 MiB shard) and read each valid token once
// (the slots past a member's valid prefix are not needed); at 3.35 TB/s
// the writes alone take ~0.16 ms.  A binary search per position
// (~14 dependent probes for 16,640 token slots) would make it
// latency-bound instead.
//
// Design: one block per tile of kTile positions of one member.  A tile
// wholly at or past n_out writes its padding and reads no token.  Else
// two warps find, by 32-way searches (3 rounds of one load a lane for
// T = 16,640 slots), c0 = #{starts <= P0} and c1 = #{starts <= L - 1},
// L the end of the tile's live part (a third counts the starts before
// P0, below); these are the only out-of-order reads of the token table.
// The probes read the token words too, so P0's covering token, slot
// max(c0 - 1, 0), comes out of the search with no further round trip.
// Slots [c0, c1) are the valid tokens that start inside (P0, L - 1].
// The block reads them coalesced, kScatter slots a
// thread with every load issued first; the LAST token at each start (its
// successor starts later, or is slot c1) writes its packed word to
// tok[start - P0] and sets the start's bit in a bitmask, both in shared
// memory.  Slot q = 0 holds P0's covering token with its own start.
// Token indices grow with starts, so a position's covering token is the
// one at the last set bit at or below it: one warp turns the 128 mask
// words into "last set bit before word w" (a max scan).  A thread then
// writes runs of 4 positions: the first finds its token with one clz and
// takes one floor mod, the others step it.  No atomics are needed for the
// tokens (one writer per start) and only a shared atomicOr per start for
// the bits.  Stores are 16-byte vectors, a warp writing 512 contiguous
// bytes per instruction; scalar where out_cap % 4 != 0.  So a block waits
// on four dependent loads (three search rounds, one scatter batch) before
// it stores, and 8 blocks a SM overlap those waits with their stores.
//
// Why the token count per tile cannot break it: the block loops over
// [c0, c1) whatever its length (a member that overflows out_cap clips
// thousands of starts to out_cap - 1; corrupt zero-length matches repeat
// a start), and shared memory is sized by positions, not tokens.  Only a
// repeated start can put more than 128 starts in a row, so the scatter
// flags one (a slot whose successor has the same start), a third warp's
// search counts the starts before P0 so a repeat at P0 shows too, and
// the block writes its tile's flag (one int32 a tile) and leaves the tile
// to rank_ref_kernel, launched right after it: a block per 32 tiles, which
// exits unless one is flagged, else runs ref_row a warp a row (one search
// for each row's count, the row's 128 window slots staged in shared
// memory, then per position the reference's 8 block probes, 4-step
// binary search and two global loads).  Decoded streams hold no
// zero-length token, so on the main path the second kernel only reads
// the flags; its registers stay out of the first kernel's 32.  An input
// outside the wrapper's contract (unsorted starts) can give a wrong
// answer but never an out-of-bounds access: every shared index is
// checked.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;                    // positions per block
constexpr int kThreads = 256;
constexpr int kWords = kTile / 32;             // start-bitmask words
constexpr int kWordsPerLane = kWords / 32;
constexpr int kScatter = 4;                    // token slots a thread loads at once
constexpr int kRun = 4;                        // positions a thread writes at once
constexpr int kRuns = kTile / (kRun * kThreads);
static_assert(kWords % 32 == 0 && kTile % (kRun * kThreads) == 0
              && 32 % kRun == 0 && kRun % 4 == 0, "tile shape");

constexpr int kRow = 128;                      // the reference's row
constexpr int kRows = kTile / kRow;
constexpr int kWin = 2048;                     // its window of token slots

struct Tile {
  int32_t tok[kTile];     // packed token starting at P0 + q; q = 0: P0's
  uint32_t mask[kWords];  // bit q: slot q holds a token
  int32_t carry[kWords];  // last set bit before word w
  int32_t cnt[3];         // c0, c1, #{starts < P0}
  int32_t s0;             // start of P0's covering token (sentinel kept)
  int32_t repeats;        // a start is shared, or no token covers P0
};

__device__ __forceinline__ int floor_mod(int x, int d) {
  const int r = x % d;
  return r < 0 ? r + d : r;
}

// #{i < n : start_i <= x}, an invalid slot's start read as `sentinel`.
// Valid slots form a prefix with non-decreasing starts, so the predicate
// is true on a prefix: searchsorted(right=True).  All 32 lanes call it;
// each round probes 32 evenly spaced slots of [lo, hi) and reads their
// token words too, so the slot before the answer, max(c - 1, 0), comes
// back in *last without another round trip: it is the last true probe of
// the last round that had one, or slot 0, which round one probes.
struct Slot {
  int start;   // sentinel kept for an invalid slot
  int tok;
};

__device__ int count_le(const int32_t* st, const uint8_t* valid,
                        const int32_t* tk, int n, int x, int sentinel,
                        int lane, Slot* last) {
  int lo = 0, hi = n;
  bool first = true;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    int s = sentinel, t = 0;
    if (i < hi) {
      const int v = st[i];
      const bool ok = valid[i] != 0;
      t = tk[i];
      s = ok ? v : sentinel;
    }
    const bool le = i < hi && s <= x;
    const int k = __popc(__ballot_sync(0xffffffffu, le));
    const int from = k > 0 ? k - 1 : 0;
    const int ps = __shfl_sync(0xffffffffu, s, from);
    const int pt = __shfl_sync(0xffffffffu, t, from);
    if (k > 0 || first) *last = Slot{ps, pt};
    first = false;
    if (k == 0) {
      hi = lo;
    } else {
      const int l = lo + (k - 1) * step;
      lo = l + 1;
      hi = min(hi, l + step);
    }
  }
  return lo;
}

// The reference's search for one row r of kRow positions, run by one
// warp (_rank_one): the row takes c = #{starts < 128 r} and its vreg's
// window of kWin slots from base = 1024 * ((max(c_8v - 1, 0)) / 1024),
// stages the kRow slots from c on (slots past the window repeat its last
// row), counts the whole 16-slot blocks <= p and binary-searches the
// block, so a row counts at most kRow starts; the id c + fine - 1 is read
// from the window row of lane 0's id or the row after it, clipped to the
// window.  Where no row holds more than kRow starts and a token covers
// every position, that is the covering token; a tile where a start
// repeats or P0 has no covering token takes this path.
__device__ __forceinline__ int ref_local_id(const int32_t* s, int c_rel,
                                            int q) {
  int fh = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) fh += s[16 * m + 15] <= q;
  int off = 0;
#pragma unroll
  for (int step = 8; step >= 1; step >>= 1)
    if (s[min(16 * fh + off + step - 1, kRow - 1)] <= q) off += step;
  return c_rel - 1 + (fh == 8 ? kRow : 16 * fh + off);
}

struct Ref {
  int32_t s[kThreads / 32][kRow];  // a warp's row of staged starts
  int32_t c[kRows];                // #{starts < 128 r} a row of the tile
  uint32_t dirty;                  // the block's flagged tiles
};

__device__ __forceinline__ void ref_row(Ref& sm, int j, int r0,
                                        const int32_t* st,
                                        const uint8_t* va,
                                        const int32_t* tk, int n_tok,
                                        int sentinel, int p1, int live_end,
                                        int out_cap, int32_t* src,
                                        int32_t* lit, int lane) {
  int32_t* s = sm.s[threadIdx.x >> 5];
  const int c = sm.c[j];
  const int base = (max(sm.c[j & ~7] - 1, 0) >> 10) << 10;
  const int c_rel = c - base;
  for (int k = lane; k < kRow; k += 32) {
    const int f = c_rel + k;
    const int i = base + min(f >> 7, kWin / kRow - 1) * kRow + (f & 127);
    s[k] = i < n_tok && va[i] ? st[i] : sentinel;
  }
  __syncwarp();
  const int p_row = (r0 + j) * kRow;
  const int qa = ref_local_id(s, c_rel, p_row) >> 7;
  for (int k = lane; k < kRow; k += 32) {
    const int p = p_row + k;
    if (p >= p1) break;
    int sv = p, lv = 0;
    if (p < live_end) {
      const int li = ref_local_id(s, c_rel, p);
      const int row = min(max((li >> 7) == qa ? qa : qa + 1, 0),
                          kWin / kRow - 1);
      const int i = base + row * kRow + (li & 127);
      const int os = i < n_tok && va[i] ? st[i] : sentinel;
      const int op = i < n_tok ? tk[i] : 0;
      const int d = (op >> 9) & 0xFFFF;
      if (d == 0) {
        lv = op & 255;
      } else {
        const int rel = static_cast<int>(static_cast<uint32_t>(p)
                                         - static_cast<uint32_t>(os));
        const int v = static_cast<int>(
            static_cast<uint32_t>(floor_mod(rel, d))
            + static_cast<uint32_t>(os) - static_cast<uint32_t>(d));
        sv = min(max(v, 0), out_cap - 1);
      }
    }
    src[p] = sv;
    lit[p] = lv;
  }
  __syncwarp();
}

// 8 blocks a SM (32 registers): the waits of one block's searches and
// scatter batch hide behind the others' stores
__global__ void __launch_bounds__(kThreads, 8)
rank_emit_src_kernel(const int32_t* __restrict__ starts,
                     const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ pk,
                     const int32_t* __restrict__ n_out,
                     int32_t* __restrict__ src, int32_t* __restrict__ lit,
                     int32_t* __restrict__ flags, int n_tok, int out_cap,
                     int tiles, bool vec) {
  __shared__ Tile sm;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * kTile;
  const int p1 = min(p0 + kTile, out_cap);
  const int live_end = min(max(n_out[b], p0), p1);   // live: [p0, live_end)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t trow = static_cast<int64_t>(b) * n_tok;
  const int32_t* st = starts + trow;
  const int32_t* tk = pk + trow;
  const int sentinel = out_cap + 2;

  if (live_end <= p0 && threadIdx.x == 0) flags[blockIdx.x] = 0;
  if (live_end > p0) {                      // uniform over the block
    for (int w = threadIdx.x; w < kWords; w += kThreads) sm.mask[w] = 0u;
    if (threadIdx.x == 0) sm.repeats = 0;
    if (warp < 3) {
      Slot t0;
      const int x = warp == 0 ? p0 : (warp == 1 ? live_end - 1 : p0 - 1);
      const int c = count_le(st, valid + trow, tk, n_tok, x, sentinel, lane,
                             &t0);
      if (lane == 0) sm.cnt[warp] = c;
      if (warp == 0 && lane == 0) {         // thread 0 also zeroed mask[0]
        sm.s0 = t0.start;
        sm.tok[0] = t0.tok;
        sm.mask[0] = 1u;
      }
    }
    __syncthreads();
    const int c0 = sm.cnt[0], c1 = sm.cnt[1];
    // no token covers P0, or tokens share the start P0
    if (threadIdx.x == 0 && (c0 == 0 || c0 - sm.cnt[2] > 1))
      sm.repeats = 1;
    // kScatter slots a thread per batch, all loads issued before any use
    for (int base = c0 + threadIdx.x; base < c1;
         base += kThreads * kScatter) {
      int s[kScatter], t[kScatter];
      bool own[kScatter];
#pragma unroll
      for (int u = 0; u < kScatter; ++u) {
        const int i = base + u * kThreads;
        s[u] = t[u] = 0;
        own[u] = i < c1;
        if (own[u]) {
          s[u] = st[i];
          t[u] = tk[i];
          // a later token at the same start owns it, and flags the tile
          if (i + 1 < c1) {
            own[u] = st[i + 1] != s[u];
            if (!own[u]) sm.repeats = 1;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kScatter; ++u) {
        const int q = s[u] - p0;
        if (own[u] && q > 0 && q < kTile) {
          sm.tok[q] = t[u];
          atomicOr(&sm.mask[q >> 5], 1u << (q & 31));
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) flags[blockIdx.x] = sm.repeats;
    if (sm.repeats) return;                 // uniform: rank_ref_kernel's
    if (warp == 0) {
      int lb[kWordsPerLane];
      int tot = -1;
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j) {
        const int w = lane * kWordsPerLane + j;
        const uint32_t m = sm.mask[w];
        lb[j] = m ? (w << 5) + 31 - __clz(m) : -1;
        tot = max(tot, lb[j]);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, tot, d);
        if (lane >= d) tot = max(tot, o);
      }
      int run = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) run = -1;
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j) {
        sm.carry[lane * kWordsPerLane + j] = run;
        run = max(run, lb[j]);
      }
    }
    __syncthreads();
  }

  // Each thread writes runs of kRun consecutive positions (one mask word
  // holds a run).  The run's first position finds its token by clz and
  // takes one floor mod; a later position either starts a token (rel = 0)
  // or steps the previous one's (p - s) mod d by one.
  const int64_t orow = static_cast<int64_t>(b) * out_cap;
  const int s0 = sm.s0;
#pragma unroll
  for (int g = 0; g < kRuns; ++g) {
    const int q0 = kRun * (threadIdx.x + g * kThreads);
    const int p = p0 + q0;
    if (p >= p1) break;
    int sv[kRun], lv[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      sv[j] = p + j;
      lv[j] = 0;
    }
    if (p < live_end) {
      const uint32_t m = sm.mask[q0 >> 5];
      const uint32_t below = m & (0xffffffffu >> (31 - (q0 & 31)));
      const int last = below ? (q0 & ~31) + 31 - __clz(below)
                             : sm.carry[q0 >> 5];
      int tok = sm.tok[last];
      int s = last ? p0 + last : s0;
      int d = (tok >> 9) & 0xFFFF;
      // int32 wrap-around as in the plain version
      int rel = static_cast<int>(static_cast<uint32_t>(p)
                                 - static_cast<uint32_t>(s));
      int r = d ? floor_mod(rel, d) : 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (p + j >= live_end) break;
        if (j > 0) {
          if ((m >> ((q0 + j) & 31)) & 1u) {
            tok = sm.tok[q0 + j];
            d = (tok >> 9) & 0xFFFF;
            s = p + j;
            rel = 0;
            r = 0;
          } else {
            rel = static_cast<int>(static_cast<uint32_t>(rel) + 1u);
            if (d) r = rel == INT_MIN ? floor_mod(rel, d)
                                      : (r + 1 == d ? 0 : r + 1);
          }
        }
        if (d == 0) {
          lv[j] = tok & 255;
        } else {
          const int v = static_cast<int>(static_cast<uint32_t>(r)
                                         + static_cast<uint32_t>(s)
                                         - static_cast<uint32_t>(d));
          sv[j] = min(max(v, 0), out_cap - 1);
        }
      }
    }
    if (vec && p + kRun <= p1) {
#pragma unroll
      for (int j = 0; j < kRun; j += 4) {
        *reinterpret_cast<int4*>(src + orow + p + j) =
            make_int4(sv[j], sv[j + 1], sv[j + 2], sv[j + 3]);
        *reinterpret_cast<int4*>(lit + orow + p + j) =
            make_int4(lv[j], lv[j + 1], lv[j + 2], lv[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (p + j < p1) {
          src[orow + p + j] = sv[j];
          lit[orow + p + j] = lv[j];
        }
      }
    }
  }
}

// The tiles rank_emit_src_kernel flagged, by the reference's search: a
// block per 32 tiles, which exits when none of them is flagged (no tile
// of a decoded stream is), else runs ref_row for each flagged tile's
// rows, a warp a row, after one search a row for its count.
__global__ void __launch_bounds__(kThreads)
rank_ref_kernel(const int32_t* __restrict__ starts,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ pk,
                const int32_t* __restrict__ n_out,
                int32_t* __restrict__ src, int32_t* __restrict__ lit,
                const int32_t* __restrict__ flags, int n_tok, int out_cap,
                int tiles, int total) {
  __shared__ Ref sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const int t = blockIdx.x * 32 + lane;
    const uint32_t d = __ballot_sync(0xffffffffu, t < total && flags[t]);
    if (lane == 0) sm.dirty = d;
  }
  __syncthreads();
  for (uint32_t d = sm.dirty; d; d &= d - 1) {
    const int t = blockIdx.x * 32 + __ffs(d) - 1;
    const int b = t / tiles;
    const int p0 = (t - b * tiles) * kTile;
    const int p1 = min(p0 + kTile, out_cap);
    const int live_end = min(max(n_out[b], p0), p1);
    const int64_t trow = static_cast<int64_t>(b) * n_tok;
    const int r0 = p0 / kRow;
    const int nr = (p1 - p0 + kRow - 1) / kRow;
    for (int j = warp; j < nr; j += kThreads / 32) {
      Slot unused;
      const int c = count_le(starts + trow, valid + trow, pk + trow, n_tok,
                             (r0 + j) * kRow - 1, out_cap + 2, lane,
                             &unused);
      if (lane == 0) sm.c[j] = c;
    }
    __syncthreads();
    const int64_t orow = static_cast<int64_t>(b) * out_cap;
    for (int j = warp; j < nr; j += kThreads / 32)
      ref_row(sm, j, r0, starts + trow, valid + trow, pk + trow, n_tok,
              out_cap + 2, p1, live_end, out_cap, src + orow, lit + orow,
              lane);
    __syncthreads();
  }
}

}  // namespace

// flags: one int32 a block (n_members x tiles), written by the first
// kernel and read by the second.
extern "C" int lf_rank_emit_src(const void* starts, const void* valid,
                                const void* pk, const void* n_out, void* src,
                                void* lit, void* flags, int n_members,
                                int n_tok, int out_cap, void* stream) {
  if (n_members <= 0 || out_cap <= 0) return 0;
  if (n_tok <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (out_cap + kTile - 1) / kTile;
  if (static_cast<int64_t>(n_members) * tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = n_members * tiles;
  const bool vec = out_cap % 4 == 0
      && ((reinterpret_cast<uintptr_t>(src)
           | reinterpret_cast<uintptr_t>(lit)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rank_emit_src_kernel<<<total, kThreads, 0, s>>>(
      static_cast<const int32_t*>(starts),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pk),
      static_cast<const int32_t*>(n_out), static_cast<int32_t*>(src),
      static_cast<int32_t*>(lit), static_cast<int32_t*>(flags), n_tok,
      out_cap, tiles, vec);
  rank_ref_kernel<<<(total + 31) / 32, kThreads, 0, s>>>(
      static_cast<const int32_t*>(starts),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pk),
      static_cast<const int32_t*>(n_out), static_cast<int32_t*>(src),
      static_cast<int32_t*>(lit), static_cast<const int32_t*>(flags), n_tok,
      out_cap, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

// The kernels as compiled: out[0..6] = the first kernel's registers,
// static shared bytes, spill bytes, dynamic shared bytes (0), resident
// blocks per SM, positions per block (kTile), threads per block;
// out[7..9] = rank_ref_kernel's registers, static shared and spill bytes.
extern "C" int lf_rank_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, rank_emit_src_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = 0;
  o[5] = kTile;
  o[6] = kThreads;
  err = cudaFuncGetAttributes(&fa, rank_ref_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[7] = fa.numRegs;
  o[8] = static_cast<int>(fa.sharedSizeBytes);
  o[9] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], rank_emit_src_kernel, kThreads, 0));
}
