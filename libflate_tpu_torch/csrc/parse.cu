// Greedy LZ77 parse for Hopper (sm_90a): chunk exits and the walk-emit.
//
// Replaces the TPU kernels of libflate_tpu/ops/pallas_parse.py:
// `_exit_kernel` (:57, via `parse_chunk_exits`) and `_walk_kernel` (:143,
// via `parse_walk_emit`), with the serial `parse_entries` scan folded into
// the walk launch.  A member's positions are cut into 512-position
// chunks; jump[p] = min(p + max(1, len[p]), n) advances by at most 258
// (MAX_MATCH), so the parse orbit enters every chunk exactly once, within
// its first 258 positions.
//
// What bounds them on this card: bytes.  chunk_exits reads jump and
// writes exits once (64 MiB for 128 x 64 KiB, ~0.020 ms at 3.35 TB/s);
// walk_emit must read jump and tok, one exit per chunk on the entry
// chain, and write the slots and flags (~92 MB at cap 384, ~0.028 ms).
// This walk stages more exits than that, every chunk's first 258
// (~17 MB for 128 x 64 KiB), so threading the entries costs
// shared-memory latency, not a device-memory round trip a chunk.  Both
// were latency-bound before: one thread walked a chunk with a dependent
// device-memory load per step, lanes 2 KB apart, and the walk's entries
// were threaded by one thread over 128 device-memory round trips.
//
// Both kernels now work on groups of 32 positions held one per lane,
// loaded coalesced straight into registers, and resolve a group's
// orbits by pointer doubling with warp shuffles: a jump stays in its
// group for at most 31 steps, so 5 rounds finish it.  The rounds take
// no vote, so the 16 groups of a chunk double side by side.
//
// lf_chunk_exits: one warp per chunk.  First every group's doubling
// gives each lane the first position past its group on its orbit; then
// the groups, from the last to the first, turn that into the exit:
// exit[p] = x >= end ? x : exit[x], reading the exits of later groups
// from shared memory.  Exits go out as 128-byte stores.
//
// lf_walk_emit: one block of 16 warps per member.  The exits of each
// chunk's first 258 positions (where an entry lies) are staged in shared
// memory, up to 128 chunks at a time, 16 loads in flight a thread, and
// thread 0 threads the entries there (entry[0] = 0, entry[c+1] =
// exit[entry[c]]; an entry outside that window reads device memory, as
// the plain version would).  Each warp's first chunk is loaded before
// that.  Then each warp takes chunks in turn: for every group it doubles
// (next position, 32-bit mask of the group positions visited) for all
// lanes at once, so the walk itself moves one shuffle pair per group;
// the visited lanes take consecutive slots (a popcount of the mask below
// them).  The tokens go to a shared-memory row of 512 slots and out as
// coalesced stores, -1 after the last, and overflow is flagged when a
// token >= 0 falls past slot `cap` (the reference's rule).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;
constexpr int kHead = 258;                 // MAX_MATCH: entries lie here
constexpr int kGroups = kChunk / 32;
constexpr int kExitWarps = 8;              // chunks per exits block
constexpr int kWalkWarps = 16;             // warps per walk block (member)
constexpr int kEntryTile = 128;            // chunks whose heads are staged
constexpr int kHeadLoads = 16;             // head loads in flight a thread
constexpr int kMaxChunks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kExitWarps * 32)
chunk_exits_kernel(const int32_t* __restrict__ jump,
                   int32_t* __restrict__ exits, int n_members, int n) {
  __shared__ int32_t ex_s[kExitWarps][kChunk];
  const int nc = n / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * kExitWarps + warp;
  if (id >= static_cast<int64_t>(n_members) * nc) return;
  const int64_t row = (id / nc) * n;
  const int base = static_cast<int>(id % nc) * kChunk, end = base + kChunk;
  const int32_t* jr = jump + row + base + lane;
  int v[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) v[g] = __ldg(jr + 32 * g);
  // x < top: a pointer to a later lane of the group; double it
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int lo = base + 32 * g, top = lo + 32;
    int x = v[g];
#pragma unroll
    for (int r = 0; r < 5; ++r)
      x = __shfl_sync(kFull, x, x < top ? x - lo : lane);
    v[g] = x;
  }
  int32_t* ex = ex_s[warp];
#pragma unroll
  for (int g = kGroups - 1; g >= 0; --g) {
    int x = v[g];
    if (x < end) x = ex[x - base];
    ex[32 * g + lane] = x;
    exits[row + base + 32 * g + lane] = x;
    __syncwarp();
  }
}

struct WalkSmem {
  int* entry;       // nc
  int32_t* slots;   // kWalkWarps x kChunk
  int32_t* head;    // kEntryTile x kHead
};

int walk_smem_bytes(int nc) {
  const int tile = nc - 1 < kEntryTile ? (nc > 1 ? nc - 1 : 1) : kEntryTile;
  const int warps = nc < kWalkWarps ? nc : kWalkWarps;
  return 4 * (((nc + 3) / 4) * 4 + warps * kChunk + tile * kHead);
}

__device__ inline WalkSmem walk_smem(int32_t* s, int nc) {
  const int warps = nc < kWalkWarps ? nc : kWalkWarps;
  WalkSmem w;
  w.entry = s;
  w.slots = s + ((nc + 3) / 4) * 4;
  w.head = w.slots + warps * kChunk;
  return w;
}

__global__ void __launch_bounds__(kWalkWarps * 32, 1)
walk_emit_kernel(const int32_t* __restrict__ jump,
                 const int32_t* __restrict__ tok,
                 const int32_t* __restrict__ exits,
                 int32_t* __restrict__ out, int32_t* __restrict__ ovf,
                 int n, int cap) {
  extern __shared__ __align__(16) int32_t smem[];
  const int nc = n / kChunk;
  const WalkSmem s = walk_smem(smem, nc);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;

  // this warp's first chunk, loaded while the entries are threaded
  int v[kGroups], t[kGroups];
  int c = warp;
  {
    const int64_t at = row + c * kChunk + lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      v[g] = __ldg(jump + at + 32 * g);
      t[g] = __ldg(tok + at + 32 * g);
    }
  }

  // entries: stage exits of each chunk's first kHead positions, tile by
  // tile, and thread the chain from thread 0
  int e = 0;
  for (int c0 = 0; c0 < nc - 1; c0 += kEntryTile) {
    const int tile = min(kEntryTile, nc - 1 - c0);
    const int total = tile * kHead;
    for (int i0 = threadIdx.x; i0 < total; i0 += kHeadLoads * blockDim.x) {
      int r[kHeadLoads];
#pragma unroll
      for (int u = 0; u < kHeadLoads; ++u) {
        const int i = i0 + u * blockDim.x, cc = i / kHead;
        r[u] = i < total ? __ldg(exits + row + (c0 + cc) * kChunk +
                                 (i - cc * kHead))
                         : 0;
      }
#pragma unroll
      for (int u = 0; u < kHeadLoads; ++u)
        if (i0 + u * blockDim.x < total) s.head[i0 + u * blockDim.x] = r[u];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int cc = 0; cc < tile; ++cc) {
        const int off = e - (c0 + cc) * kChunk;
        s.entry[c0 + cc] = e;
        e = off >= 0 && off < kHead
                ? s.head[cc * kHead + off]
                : __ldg(exits + row + min(max(e, 0), n - 1));
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) s.entry[nc - 1] = e;
  __syncthreads();

  int32_t* slots = s.slots + warp * kChunk;
  for (; c < nc; c += warps) {
    const int base = c * kChunk;
    // every group's orbits at once: x = the first position past the
    // group on lane's orbit, m = the group positions on it before that
    unsigned m[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int lo = base + 32 * g, top = lo + 32;
      unsigned mm = 1u << lane;
      int x = v[g];
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int src = x < top ? x - lo : lane;
        mm |= __shfl_sync(kFull, mm, src);
        x = __shfl_sync(kFull, x, src);
      }
      v[g] = x;
      m[g] = mm;
    }
    // the walk: one shuffle pair per group the orbit enters
    int cur = s.entry[c], k = 0;
    bool flag = false;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int lo = base + 32 * g;
      if (cur < lo || cur >= lo + 32) continue;      // warp-uniform
      const unsigned ms = __shfl_sync(kFull, m[g], cur - lo);
      cur = __shfl_sync(kFull, v[g], cur - lo);
      if (ms >> lane & 1u) {
        const int at = k + __popc(ms & ((1u << lane) - 1u));
        if (at < cap) slots[at] = t[g];
        else if (t[g] >= 0) flag = true;
      }
      k += __popc(ms);
    }
    __syncwarp();
    int32_t* o = out + (static_cast<int64_t>(blockIdx.x) * nc + c) * cap;
    for (int i = lane; i < cap; i += 32) o[i] = i < k ? slots[i] : -1;
    flag = __any_sync(kFull, flag);
    if (lane == 0) ovf[static_cast<int64_t>(blockIdx.x) * nc + c] = flag;
    __syncwarp();
    if (c + warps < nc) {
      const int64_t at = row + (c + warps) * kChunk + lane;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        v[g] = __ldg(jump + at + 32 * g);
        t[g] = __ldg(tok + at + 32 * g);
      }
    }
  }
}

int walk_threads(int nc) { return 32 * (nc < kWalkWarps ? nc : kWalkWarps); }

// raises the walk kernel's dynamic shared memory limit to `bytes` on the
// current device (the attribute is per device, so it is set every launch)
cudaError_t allow_walk_smem(int bytes) {
  return cudaFuncSetAttribute(
      walk_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int lf_chunk_exits(const void* jump, void* exits, int n_members,
                              int n, void* stream) {
  if (n_members <= 0) return 0;
  if (n <= 0 || n % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = static_cast<int64_t>(n_members) * (n / kChunk);
  chunk_exits_kernel<<<static_cast<unsigned>((chunks + kExitWarps - 1) /
                                             kExitWarps),
                       kExitWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(jump), static_cast<int32_t*>(exits),
      n_members, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_walk_emit(const void* jump, const void* tok,
                            const void* exits, void* out, void* ovf,
                            int n_members, int n, int cap, void* stream) {
  if (n_members <= 0) return 0;
  if (n <= 0 || n % kChunk || n / kChunk > kMaxChunks || cap <= 0 ||
      cap > kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = n / kChunk;
  const int smem = walk_smem_bytes(nc);
  cudaError_t err = allow_walk_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_emit_kernel<<<n_members, walk_threads(nc), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(jump), static_cast<const int32_t*>(tok),
      static_cast<const int32_t*>(exits), static_cast<int32_t*>(out),
      static_cast<int32_t*>(ovf), n, cap);
  return static_cast<int>(cudaGetLastError());
}

// The two kernels as compiled, for n positions a member: out[0..4] the
// exits kernel's registers, static shared bytes, spill bytes, dynamic
// shared bytes (0) and resident blocks per SM; out[5..9] the same for
// the walk kernel.
extern "C" int lf_parse_info(int n, void* out) {
  if (n <= 0 || n % kChunk || n / kChunk > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  const int nc = n / kChunk;
  const int smem = walk_smem_bytes(nc);
  cudaError_t err = allow_walk_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, chunk_exits_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], chunk_exits_kernel, kExitWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&fa, walk_emit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[5] = fa.numRegs;
  o[6] = static_cast<int>(fa.sharedSizeBytes);
  o[7] = static_cast<int>(fa.localSizeBytes);
  o[8] = smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[9], walk_emit_kernel, walk_threads(nc), smem));
}
