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
// lf_spec_decode: one thread per (member, position), 2048 positions per
// block.  The 4096-entry litlen root, the 256-entry distance root and the
// length/distance rows sit in shared memory (17.9 KB); each thread reads a
// 64-bit window from the member's words (two aligned loads and a funnel
// shift) and runs `_decode_kernel`'s arithmetic, clips and flag rules
// included.  Bound by bytes: it writes 8 bytes a position (182 MB for a
// group of 128 members at P = 178176, 0.055 ms at 3.35 TB/s); neighbouring
// threads read the same words, so the reads hit L1.
//
// lf_spec_chunk_exits: a block stages 16 chunks of one member in shared
// memory (rows padded to 513 words against bank conflicts) with coalesced
// loads; one thread per chunk sweeps it backward in place: out[l] = v if
// v = nxt[l] is at or past the chunk's end or v <= l, else out[v].  The
// TPU kernel's in-tile pointer doubling and 7-group select compute exactly
// this, because a symbol spans at most 38 bits under the 12/8-bit roots
// (below its MAX_JUMP of 48).  Bound by bytes: 4 read and 4 written a
// position.
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

constexpr int kDecThreads = 256;
constexpr int kDecPositions = 2048;        // positions per decode block

constexpr int kExitThreads = 128;
constexpr int kExitChunks = 16;            // chunks per exits block
constexpr int kExitStride = kChunk + 1;    // padded shared row

constexpr int kWalkThreads = 128;
constexpr int kWalkChunks = kWalkThreads / 32;  // a stage: a walker a warp
constexpr int kWalkStages = 2;                   // stage buffers
static_assert(4 * kWalkThreads == kChunk, "a 16-byte copy a thread");

__global__ void __launch_bounds__(kDecThreads)
spec_decode_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ lit_t,
                   const int32_t* __restrict__ dist_t,
                   const int32_t* __restrict__ rows,
                   int32_t* __restrict__ tok, int32_t* __restrict__ nxt,
                   int n_words, int n_pos) {
  __shared__ int32_t s_lit[kLitRoot];
  __shared__ int32_t s_dist[kDistRoot];
  __shared__ int32_t s_rows[kRows];
  for (int i = threadIdx.x; i < kLitRoot; i += kDecThreads) s_lit[i] = lit_t[i];
  for (int i = threadIdx.x; i < kDistRoot; i += kDecThreads)
    s_dist[i] = dist_t[i];
  for (int i = threadIdx.x; i < kRows; i += kDecThreads) s_rows[i] = rows[i];
  __syncthreads();
  const int32_t* len_base = s_rows;
  const int32_t* len_extra = s_rows + kLenCodes;
  const int32_t* dist_base = s_rows + 2 * kLenCodes;
  const int32_t* dist_extra = s_rows + 2 * kLenCodes + kDistCodes;

  const int b = blockIdx.y;
  const uint32_t* w = words + static_cast<int64_t>(b) * n_words;
  const int64_t row = static_cast<int64_t>(b) * n_pos;
  const int p0 = static_cast<int>(blockIdx.x) * kDecPositions;
  const int p_end = min(n_pos, p0 + kDecPositions);
  for (int p = p0 + static_cast<int>(threadIdx.x); p < p_end;
       p += kDecThreads) {
    // 64-bit window at bit p; p < 32W - 128, so word p/32 + 2 exists
    const int wi = p >> 5;
    const int r = p & 31;
    uint64_t win = ((static_cast<uint64_t>(w[wi + 1]) << 32) | w[wi]) >> r;
    if (r) win |= static_cast<uint64_t>(w[wi + 2]) << (64 - r);

    const int e = s_lit[win & (kLitRoot - 1)];
    const int width = e & 15;
    const int sym = e >> 4;
    const bool bad = e == 0;
    const bool is_len = sym > 256;
    const bool is_eob = sym == 256;
    const int li = min(max(sym - 257, 0), kLenCodes - 1);
    const int lnx = len_extra[li];
    const int length = len_base[li] +
        static_cast<int>((win >> width) & ((1u << lnx) - 1));
    const int k2 = width + (is_len ? lnx : 0);
    const int de = s_dist[(win >> k2) & (kDistRoot - 1)];
    const int dsym = min(max(de >> 4, 0), kDistCodes - 1);
    const bool dbad = is_len && de == 0;
    const int dnx = dist_extra[dsym];
    const int k3 = k2 + (de & 15);
    const int dist = dist_base[dsym] +
        static_cast<int>((win >> k3) & ((1u << dnx) - 1));

    const int a = is_len ? length : sym;
    const int bb = is_len ? dist : 0;
    tok[row + p] = min(max(a, 0), 511) | (min(max(bb, 0), 65535) << 9) |
                   (is_eob ? kEob : 0) | (bad || dbad ? kBad : 0);
    nxt[row + p] = is_eob || bad || dbad ? p : p + (is_len ? k3 + dnx : width);
  }
}

__global__ void __launch_bounds__(kExitThreads)
spec_chunk_exits_kernel(const int32_t* __restrict__ nxt,
                        int32_t* __restrict__ exits, int n_pos) {
  __shared__ int32_t s[kExitChunks * kExitStride];
  const int nc = n_pos / kChunk;
  const int c0 = static_cast<int>(blockIdx.x) * kExitChunks;
  const int t = static_cast<int>(threadIdx.x);
  const int n_here = min(kExitChunks, nc - c0) * kChunk;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * n_pos +
                      static_cast<int64_t>(c0) * kChunk;
  for (int i = t; i < n_here; i += kExitThreads)
    s[(i / kChunk) * kExitStride + i % kChunk] = nxt[off + i];
  __syncthreads();
  if (t * kChunk < n_here) {
    int32_t* sc = s + t * kExitStride;
    const int base = (c0 + t) * kChunk;
    for (int l = kChunk - 1; l >= 0; --l) {
      const int v = sc[l];
      // v in (base + l, chunk end): its exit is already final
      if (v > base + l && v < base + kChunk) sc[l] = sc[v - base];
    }
  }
  __syncthreads();
  for (int i = t; i < n_here; i += kExitThreads)
    exits[off + i] = s[(i / kChunk) * kExitStride + i % kChunk];
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

// Resident walk blocks a SM, per device, for the persistent grid.
cudaError_t walk_blocks(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spec_walk_emit_kernel, kWalkThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (*blocks <= 0) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int lf_spec_decode(const void* words, const void* lit_t,
                              const void* dist_t, const void* rows,
                              void* tok, void* nxt, int n_members,
                              int n_words, void* stream) {
  const int n_pos = 32 * n_words - 128;
  if (n_members <= 0) return 0;
  if (n_pos <= 0 || n_members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_pos + kDecPositions - 1) / kDecPositions, n_members);
  spec_decode_kernel<<<grid, kDecThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(lit_t),
      static_cast<const int32_t*>(dist_t), static_cast<const int32_t*>(rows),
      static_cast<int32_t*>(tok), static_cast<int32_t*>(nxt), n_words, n_pos);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_spec_chunk_exits(const void* nxt, void* exits,
                                   int n_members, int n_pos, void* stream) {
  if (n_members <= 0 || n_pos == 0) return 0;
  if (n_pos % kChunk || n_members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = n_pos / kChunk;
  const dim3 grid((nc + kExitChunks - 1) / kExitChunks, n_members);
  spec_chunk_exits_kernel<<<grid, kExitThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<int32_t*>(exits), n_pos);
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
  int resident = 0;
  const cudaError_t err = walk_blocks(&resident);
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
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, spec_walk_emit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[4] = kWalkThreads;
  o[5] = kWalkChunks;
  o[6] = kWalkStages;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[3], spec_walk_emit_kernel, kWalkThreads, 0));
}
