// Speculative shared-table DEFLATE decode for Hopper (sm_90a).
//
// Replaces the TPU kernels of libflate_tpu/ops/pallas_decode.py
// (`_decode_kernel`, `_chunk_exit_kernel`, `_walk_emit_kernel`) and the
// XLA scan of libflate_tpu/ops/deflate_decode.py `chain_entries`.  The
// members of a group share one code table, so a symbol is decoded at every
// bit position of every member; following nxt from a member's first symbol
// visits its true token boundaries.  Layout is member-major: words (B, W),
// tok / nxt / exits (B, P) with P = 32W - 128, entries (B, P/512), emit
// (B, P/512 * 136), all int32.
//
// lf_spec_decode: bound by bytes: it writes 8 bytes a position (182 MB
// for a group of 128 members at P = 178176, 0.055 ms at 3.35 TB/s).  A
// persistent grid (the resident 1024-thread blocks, two a SM) strides
// over 512-position chunks, eight a block step, so a block builds its
// tables once a launch.  The tables are merged in the block's prologue
// from the operands: a 4-byte entry a litlen root slot (the literal, or
// the length's base; width; the bits before the distance code; the
// length's extra bits; the length, end-of-block and bad flags) and one a
// distance root slot (base, extra bits, width, the `de == 0` flag),
// computed with the plain version's clamps (17 KB of shared memory), so a
// position does two dependent shared lookups.  A thread decodes 4
// consecutive positions of one member from a 64-bit window cut by funnel
// shifts out of three words (a chunk is 512 positions, so the 4 lie in
// one row), and stores tok and nxt as one 16-byte store each.  The stores
// are plain write-back ones: streaming stores (st.global.cs) made this
// kernel faster alone but the chunk exits after it slower by as much,
// because L2 keeps part of nxt for them.
//
// lf_spec_chunk_exits: bound by bytes: 4 read and 4 written a position.
// A warp per chunk, as the greedy parse's chunk_exits (parse.cu): lane i
// holds position 32g + i of each of the 16 groups of 32, loaded
// coalesced straight into registers.  A lane whose nxt lies later in its
// own group points at that lane; any other lane is final (nxt at or
// before it, past the group or out of the chunk) and points at itself.
// Five rounds of pointer doubling by shuffle give every lane the final
// lane its orbit reaches in the group.  Then the groups, last to first,
// take that lane's nxt x: the exit is x when x lies before the group's
// end (a terminal or a backward jump) or at or past the chunk's end, else
// the exit of x, a later group's, read from the warp's 2 KB of results in
// shared memory.  Exits go out as 128-byte stores.  This is the plain
// version's backward sweep for any nxt, backward and long jumps
// included; the TPU kernel's in-tile doubling and 7-group select compute
// the same on DEFLATE's jumps (at most 38 bits under the 12/8-bit roots,
// below its MAX_JUMP).
//
// lf_spec_chain_entries: one thread per member threads the orbit through
// the chunks: entry[t] = pos; pos = clip(exit[pos], 0, P-1) while pos lies
// in chunk t.  A chain of n_chunks dependent loads: latency bound.
//
// lf_spec_walk_emit: per (member, chunk), follow the orbit from the
// chunk's entry for at most 128 steps, writing the tokens met to
// consecutive rows, -1 once the walk has left the chunk, and moving to
// 0x7FFFFFF0 after a terminal (nxt == cur) so that it leaves.  Row 128 is
// -1 when the walk is still inside the chunk after 128 steps (overflow),
// else 0; rows 129-135 are 0.  A walk reads only positions of its own
// chunk, and the chunks of consecutive (member, chunk) ids are contiguous
// in tok, nxt and the emit.  So persistent 128-thread blocks take stages
// of 4 consecutive chunks: each stage's tok and nxt (16 KiB) come into
// shared memory with coalesced 16-byte cp.async, one stage ahead of the
// walk (two buffers); a lane of each warp walks one chunk there and stops
// once the walk has left it; the block then writes the stage's 4 x 136
// emit rows as 16-byte stores.  Bound by bytes: a walk visits about one
// position in eleven, but on text two thirds of the 32-byte sectors of tok
// and nxt hold one (chip_smoke.py counts them), so staging whole chunks,
// 8 bytes a position plus the emit (206 MB for a group of 128 members at
// P = 178176), moves 1.4 times the sectors the walks need.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;
constexpr int kMaxEmit = 128;
constexpr int kEmitRows = kMaxEmit + 8;
constexpr int32_t kGone = 0x7FFFFFF0;
constexpr int kEob = 1 << 25;
constexpr int kBad = 1 << 26;
constexpr int kLitRoot = 4096;
constexpr int kDistRoot = 256;
constexpr int kLenCodes = 29;
constexpr int kDistCodes = 30;
constexpr int kRows = 2 * kLenCodes + 2 * kDistCodes;   // 118

constexpr int kDecThreads = 1024;
constexpr int kDecQuads = kChunk / 4;      // threads a chunk: 4 positions each
constexpr int kDecChunks = kDecThreads / kDecQuads;  // chunks a block step
constexpr int kDecMinBlocks = 2;           // resident blocks a SM asked for
// merged litlen entry: bits 0-8 the literal (the symbol clamped to 0-511)
// or the length's base, 9-12 width, 13-17 the bits before the distance
// code, 18-20 the length's extra bits, 21 a length; kEob and kBad in place
constexpr uint32_t kIsLen = 1u << 21;
// merged distance entry: bits 0-15 base, 16-19 extra bits, 20-23 width,
// 24 no code starts (a length with it is bad)
constexpr uint32_t kDistNone = 1u << 24;

constexpr int kExitWarps = 8;              // chunks per exits block
constexpr int kGroups = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kWalkThreads = 128;
constexpr int kWalkChunks = kWalkThreads / 32;  // a stage: a walker a warp
constexpr int kWalkStages = 2;                   // stage buffers
static_assert(4 * kWalkThreads == kChunk, "a 16-byte copy a thread");

__device__ __forceinline__ uint32_t lit_entry(int e, const int32_t* rows) {
  const int width = e & 15, sym = e >> 4;
  const bool is_len = sym > 256;
  const int li = min(max(sym - 257, 0), kLenCodes - 1);
  const int lnx = rows[kLenCodes + li];
  const int a = is_len ? rows[li] : min(max(sym, 0), 511);
  return static_cast<uint32_t>(a | width << 9 |
                               (width + (is_len ? lnx : 0)) << 13 |
                               lnx << 18) |
         (is_len ? kIsLen : 0u) | (sym == 256 ? kEob : 0) |
         (e == 0 ? kBad : 0);
}

__device__ __forceinline__ uint32_t dist_entry(int de, const int32_t* rows) {
  const int dsym = min(max(de >> 4, 0), kDistCodes - 1);
  return static_cast<uint32_t>(rows[2 * kLenCodes + dsym] |
                               rows[2 * kLenCodes + kDistCodes + dsym] << 16 |
                               (de & 15) << 20) |
         (de == 0 ? kDistNone : 0u);
}

// One symbol at bit position p; lo and hi are the 64 bits from p on.
__device__ __forceinline__ void decode_at(uint32_t lo, uint32_t hi, int p,
                                          const uint32_t* s_lit,
                                          const uint32_t* s_dist, int& tok,
                                          int& nxt) {
  const uint32_t l = s_lit[lo & (kLitRoot - 1)];
  const uint32_t width = (l >> 9) & 15, k2 = (l >> 13) & 31;
  const uint32_t lnx = (l >> 18) & 7;
  const uint32_t d = s_dist[(lo >> k2) & (kDistRoot - 1)];
  const uint32_t dnx = (d >> 16) & 15, k3 = k2 + ((d >> 20) & 15);
  const uint64_t win = static_cast<uint64_t>(hi) << 32 | lo;
  const uint32_t dist = (d & 0xffff) +
      (static_cast<uint32_t>(win >> k3) & ((1u << dnx) - 1));
  const uint32_t length = (l & 511) + ((lo >> width) & ((1u << lnx) - 1));
  if (l & kIsLen) {
    const bool dbad = d & kDistNone;
    tok = static_cast<int>(min(length, 511u) | min(dist, 65535u) << 9) |
          (dbad ? kBad : 0);
    nxt = dbad ? p : p + static_cast<int>(k3 + dnx);
  } else {
    tok = static_cast<int>(l & (511u | kEob | kBad));
    nxt = l & (kEob | kBad) ? p : p + static_cast<int>(width);
  }
}

__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks)
spec_decode_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ lit_t,
                   const int32_t* __restrict__ dist_t,
                   const int32_t* __restrict__ rows,
                   int32_t* __restrict__ tok, int32_t* __restrict__ nxt,
                   int n_members, int n_words, int n_pos) {
  __shared__ uint32_t s_lit[kLitRoot];
  __shared__ uint32_t s_dist[kDistRoot];
  __shared__ int32_t s_rows[kRows];
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < kRows) s_rows[tid] = rows[tid];
  __syncthreads();
  for (int i = tid; i < kLitRoot; i += kDecThreads)
    s_lit[i] = lit_entry(__ldg(lit_t + i), s_rows);
  for (int i = tid; i < kDistRoot; i += kDecThreads)
    s_dist[i] = dist_entry(__ldg(dist_t + i), s_rows);
  __syncthreads();

  // chunk (b, c) of this thread's quarter; the block steps by the grid
  const int nc = n_pos / kChunk;
  const int stride = static_cast<int>(gridDim.x) * kDecChunks;
  const int t0 = static_cast<int>(blockIdx.x) * kDecChunks + tid / kDecQuads;
  const int db = stride / nc, dc = stride % nc;
  const int q = (tid % kDecQuads) * 4;
  int b = t0 / nc, c = t0 % nc;
  while (b < n_members) {
    // 96 bits from word p/32: p/32 + 2 < W, since p < 32W - 128
    const int p = c * kChunk + q;
    const uint32_t* w = words + static_cast<int64_t>(b) * n_words + (p >> 5);
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
    int tk[4], nx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sh = (p & 31) + j;
      decode_at(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                p + j, s_lit, s_dist, tk[j], nx[j]);
    }
    const int64_t o = static_cast<int64_t>(b) * n_pos + p;
    *reinterpret_cast<int4*>(tok + o) = make_int4(tk[0], tk[1], tk[2], tk[3]);
    *reinterpret_cast<int4*>(nxt + o) = make_int4(nx[0], nx[1], nx[2], nx[3]);
    c += dc;
    b += db;
    if (c >= nc) {
      c -= nc;
      ++b;
    }
  }
}

__global__ void __launch_bounds__(kExitWarps * 32)
spec_chunk_exits_kernel(const int32_t* __restrict__ nxt,
                        int32_t* __restrict__ exits, int64_t total, int nc) {
  __shared__ int32_t s_ex[kExitWarps][kChunk];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * kExitWarps + warp;
  if (id >= total) return;
  const int base = static_cast<int>(id % nc) * kChunk, end = base + kChunk;
  const int32_t* src = nxt + id * kChunk + lane;
  int32_t* dst = exits + id * kChunk + lane;
  int v[kGroups], ptr[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) v[g] = __ldg(src + 32 * g);
  // a lane whose successor lies later in its own group points at it;
  // every other lane is final and points at itself
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int lo = base + 32 * g;
    ptr[g] = v[g] > lo + lane && v[g] < lo + 32 ? v[g] - lo : lane;
  }
  // an orbit stays in its group for at most 31 steps
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      ptr[g] = __shfl_sync(kFull, ptr[g], ptr[g]);
  }
  int32_t* ex = s_ex[warp];
#pragma unroll
  for (int g = kGroups - 1; g >= 0; --g) {
    // the final lane's successor: before the group's end (its own exit),
    // at or past the chunk's end, or in a later group (that exit is final)
    int x = __shfl_sync(kFull, v[g], ptr[g]);
    if (x >= base + 32 * g + 32 && x < end) x = ex[x - base];
    ex[32 * g + lane] = x;
    dst[32 * g] = x;
    __syncwarp();
  }
}

__global__ void spec_chain_entries_kernel(const int32_t* __restrict__ exits,
                                          const int32_t* __restrict__ starts,
                                          int32_t* __restrict__ entries,
                                          int n_members, int n_pos) {
  const int b = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= n_members) return;
  const int nc = n_pos / kChunk;
  const int32_t* g = exits + static_cast<int64_t>(b) * n_pos;
  int32_t* o = entries + static_cast<int64_t>(b) * nc;
  int pos = starts[b];
  for (int t = 0; t < nc; ++t) {
    o[t] = pos;
    if (pos >= t * kChunk && pos < (t + 1) * kChunk)
      pos = min(max(g[pos], 0), n_pos - 1);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_addr(dst)), "l"(src));
}

__global__ void __launch_bounds__(kWalkThreads)
spec_walk_emit_kernel(const int32_t* __restrict__ nxt,
                      const int32_t* __restrict__ tok,
                      const int32_t* __restrict__ entries,
                      int32_t* __restrict__ out, int64_t total, int nc) {
  __shared__ __align__(16) int32_t s_tok[kWalkStages][kWalkChunks][kChunk];
  __shared__ __align__(16) int32_t s_nxt[kWalkStages][kWalkChunks][kChunk];
  __shared__ __align__(16) int32_t s_emit[kWalkChunks][kEmitRows];
  __shared__ int32_t s_ent[kWalkStages][kWalkChunks];
  __shared__ int32_t s_steps[kWalkChunks];
  __shared__ int32_t s_flag[kWalkChunks];
  const int tid = static_cast<int>(threadIdx.x);
  const int64_t n_stages = (total + kWalkChunks - 1) / kWalkChunks;

  // Every thread commits one group a stage (possibly empty), so waiting
  // for all but the newest group waits for the stage about to be walked.
  auto issue = [&](int64_t s, int buf) {
    if (s < n_stages) {
      for (int j = 0; j < kWalkChunks; ++j) {
        const int64_t id = s * kWalkChunks + j;
        if (id >= total) break;
        const int64_t p = id * kChunk + tid * 4;
        cp_async16(&s_tok[buf][j][tid * 4], tok + p);
        cp_async16(&s_nxt[buf][j][tid * 4], nxt + p);
        if (tid == 0) cp_async4(&s_ent[buf][j], entries + id);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int64_t stride = gridDim.x;
  int64_t s = blockIdx.x;
  issue(s, 0);
  issue(s + stride, 1);
  const int warp = tid >> 5;
  for (int k = 0; s < n_stages; ++k, s += stride) {
    const int buf = k & 1;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int64_t id0 = s * kWalkChunks;
    if ((tid & 31) == 0 && id0 + warp < total) {
      const unsigned base =
          static_cast<unsigned>((id0 + warp) % nc) * kChunk;
      const int32_t* st = s_tok[buf][warp];
      const int32_t* sn = s_nxt[buf][warp];
      int32_t* em = s_emit[warp];
      unsigned cur = static_cast<unsigned>(s_ent[buf][warp]);
      int i = 0;
      while (i < kMaxEmit && cur - base < kChunk) {
        const unsigned l = cur - base;
        em[i++] = st[l];
        const unsigned nv = static_cast<unsigned>(sn[l]);
        cur = nv == cur ? static_cast<unsigned>(kGone) : nv;
      }
      s_steps[warp] = i;
      s_flag[warp] = cur - base < kChunk ? -1 : 0;
    }
    __syncthreads();
    issue(s + 2 * stride, buf);
    const int n_here =
        total - id0 < kWalkChunks ? static_cast<int>(total - id0)
                                  : kWalkChunks;
    for (int v = tid; v < n_here * (kEmitRows / 4); v += kWalkThreads) {
      const int j = v / (kEmitRows / 4), i = (v % (kEmitRows / 4)) * 4;
      const int steps = s_steps[j], flag = s_flag[j];
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = i + u;
        r[u] = row < steps ? s_emit[j][row]
               : row < kMaxEmit ? -1 : row == kMaxEmit ? flag : 0;
      }
      *reinterpret_cast<int4*>(out + (id0 + j) * kEmitRows + i) =
          make_int4(r[0], r[1], r[2], r[3]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Resident blocks of `kernel` on the current device (a SM's times the
// SMs), cached per device in `cached`, for a persistent grid.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int* cached,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (*blocks <= 0) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

// registers, static shared, spill bytes and resident blocks a SM of
// `kernel` into o[0..3]
template <typename Kernel>
int kernel_attrs(Kernel kernel, int threads, int* o) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[3], kernel, threads, 0));
}

}  // namespace

extern "C" int lf_spec_decode(const void* words, const void* lit_t,
                              const void* dist_t, const void* rows,
                              void* tok, void* nxt, int n_members,
                              int n_words, void* stream) {
  if (n_members <= 0) return 0;
  const int64_t n_pos = 32 * static_cast<int64_t>(n_words) - 128;
  if (n_pos <= 0 || n_pos % kChunk || n_pos > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_members * (n_pos / kChunk);
  if (total > INT32_MAX - kDecChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tok) % 16 ||
      reinterpret_cast<uintptr_t>(nxt) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int cached[64];
  int resident = 0;
  const cudaError_t err =
      resident_blocks(spec_decode_kernel, kDecThreads, cached, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t steps = (total + kDecChunks - 1) / kDecChunks;
  const int grid = steps < resident ? static_cast<int>(steps) : resident;
  spec_decode_kernel<<<grid, kDecThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(lit_t),
      static_cast<const int32_t*>(dist_t), static_cast<const int32_t*>(rows),
      static_cast<int32_t*>(tok), static_cast<int32_t*>(nxt), n_members,
      n_words, static_cast<int>(n_pos));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_spec_chunk_exits(const void* nxt, void* exits,
                                   int n_members, int n_pos, void* stream) {
  if (n_members <= 0 || n_pos == 0) return 0;
  if (n_pos % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_members) * (n_pos / kChunk);
  const int64_t grid = (total + kExitWarps - 1) / kExitWarps;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  spec_chunk_exits_kernel<<<static_cast<unsigned>(grid), kExitWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<int32_t*>(exits), total,
      n_pos / kChunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_spec_chain_entries(const void* exits, const void* starts,
                                     void* entries, int n_members, int n_pos,
                                     void* stream) {
  if (n_members <= 0 || n_pos == 0) return 0;
  if (n_pos % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  spec_chain_entries_kernel<<<(n_members + threads - 1) / threads, threads,
                              0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(exits), static_cast<const int32_t*>(starts),
      static_cast<int32_t*>(entries), n_members, n_pos);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_spec_walk_emit(const void* nxt, const void* tok,
                                 const void* entries, void* out,
                                 int n_members, int n_pos, void* stream) {
  if (n_members <= 0 || n_pos == 0) return 0;
  if (n_pos % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_members) * (n_pos / kChunk);
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!al16(nxt) || !al16(tok) || !al16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int cached[64];
  int resident = 0;
  const cudaError_t err =
      resident_blocks(spec_walk_emit_kernel, kWalkThreads, cached, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_stages = (total + kWalkChunks - 1) / kWalkChunks;
  const int grid =
      n_stages < resident ? static_cast<int>(n_stages) : resident;
  spec_walk_emit_kernel<<<grid, kWalkThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(tok),
      static_cast<const int32_t*>(entries), static_cast<int32_t*>(out),
      total, n_pos / kChunk);
  return static_cast<int>(cudaGetLastError());
}

// registers, static shared, spill bytes, resident blocks a SM, threads a
// block, chunks a stage, stage buffers
extern "C" int lf_spec_walk_info(void* out) {
  int* o = static_cast<int*>(out);
  o[4] = kWalkThreads;
  o[5] = kWalkChunks;
  o[6] = kWalkStages;
  return kernel_attrs(spec_walk_emit_kernel, kWalkThreads, o);
}

// registers, static shared, spill bytes, resident blocks a SM, threads a
// block, positions a thread, chunks a block step
extern "C" int lf_spec_decode_info(void* out) {
  int* o = static_cast<int*>(out);
  o[4] = kDecThreads;
  o[5] = 4;
  o[6] = kDecChunks;
  return kernel_attrs(spec_decode_kernel, kDecThreads, o);
}

// registers, static shared, spill bytes, resident blocks a SM, threads a
// block, chunks a block (a warp each)
extern "C" int lf_spec_exits_info(void* out) {
  int* o = static_cast<int*>(out);
  o[4] = kExitWarps * 32;
  o[5] = kExitWarps;
  return kernel_attrs(spec_chunk_exits_kernel, kExitWarps * 32, o);
}
