// LZ77 pointer chase to plaintext bytes for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_expand.py
// `_resolve_kernel` / `_resolve_loop` in its default "uband" mode (wrappers
// `resolve_packed`, `resolve_bytes`).  After the rank kernel's
// mod-collapse, src[p] < p for every match byte and src[p] == p for
// literals and padding, so following src from any position ends at a
// literal root, whose byte is lit[root].
//
// What bounds it: bytes (src and lit read once, 8 bytes a position, one
// byte written), but a member's tiles depend on each other in order: a
// chase may end in any earlier tile.  So each block walks one member
// tile by tile and has to keep its own loads in flight; with them in
// flight, the chase's instructions take most of what is left.
//
// Design:
// - a ring of kStages tile stages (src and lit, 8 KB a stage) in shared
//   memory, filled by cp.async kStages - 1 tiles ahead, so three tiles'
//   loads are in flight while a tile is chased (16-byte copies when the
//   rows are 16-byte aligned, else 4-byte ones);
// - each thread chases its two positions of the tile in the stage until a
//   literal root or a source before the tile.  The chases are short (a
//   few steps for text) but a warp waits for its longest, so the loop is
//   warp-uniform and branch-free: both chases step together with
//   predicated loads, a finished one re-reading its own slot;
// - the member's recent output stays in a byte ring of kRingTiles tiles
//   in shared memory (33,792 bytes before the tile, more than a DEFLATE
//   pointer reaches after the mod-collapse: 32,768 + 257), so no valid
//   chase leaves the SM; a source farther back (corrupt input) reads
//   `out` in global memory, written tiles ago, at L2 (ld.global.cg);
// - the tile's bytes go from the ring to `out` as 16-byte stores (byte
//   stores when the row length is not a multiple of 16);
// - 512-thread blocks and 66 KiB of shared memory, so three members run
//   on an SM at once; a launch of 128 members (one stripped-decode group)
//   has one block a SM and waits on each tile's chase and two barriers.
//
// A pointer that is not a match (src[p] > p or < 0: corrupt input the
// rank kernel never emits) ends the chase with byte 0.  Worst case: a
// chase takes one step per token that starts inside the tile, e.g. ~340
// for a run of 3-byte matches each copying the one before.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2 * kThreads;         // positions a tile, two a thread
constexpr int kStages = 4;
constexpr int kReach = 32768 + 257;         // a valid pointer's reach
constexpr int kRingTiles = (kReach + kTile - 1) / kTile + 1;
constexpr int kRing = kRingTiles * kTile;   // bytes of recent output
constexpr int kStageInts = kTile;           // int32 of src (or lit) a stage
constexpr int kSmem = kStages * kTile * 8 + kRing;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A byte this block stored to global memory at least one barrier ago.
__device__ __forceinline__ uint8_t ld_cg_u8(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.global.cg.u8 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return static_cast<uint8_t>(v);
}

__global__ void __launch_bounds__(kThreads, 3)
resolve_bytes_kernel(const int32_t* __restrict__ src,
                     const int32_t* __restrict__ lit,
                     uint8_t* __restrict__ out, int n, int vec_in,
                     int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* st_src = reinterpret_cast<int32_t*>(smem);
  int32_t* st_lit = st_src + kStages * kStageInts;
  uint8_t* ring = smem + kStages * kTile * 8;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const int32_t* sr = src + row;
  const int32_t* lr = lit + row;
  uint8_t* o = out + row;
  const int tid = threadIdx.x;
  const int ntiles = (n + kTile - 1) / kTile;

  // Every thread commits one group a tile (possibly empty), so waiting
  // for all but the newest kStages - 1 groups waits for tile t.
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int t0 = t * kTile;
      const int slot = (t % kStages) * kStageInts;
      if (vec_in) {             // a 16-byte chunk of src or of lit each
        const int c = (tid % (kThreads / 2)) * 4;
        if (t0 + c < n) {
          if (tid < kThreads / 2) cp_async16(st_src + slot + c, sr + t0 + c);
          else cp_async16(st_lit + slot + c, lr + t0 + c);
        }
      } else {
        for (int k = tid; k < kTile && t0 + k < n; k += kThreads) {
          cp_async4(st_src + slot + k, sr + t0 + k);
          cp_async4(st_lit + slot + k, lr + t0 + k);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    issue(t + kStages - 1);   // into the stage tile t - 1 left (barrier below)
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int t0 = t * kTile;
    const int32_t* ts = st_src + (t % kStages) * kStageInts;
    const int32_t* tl = st_lit + (t % kStages) * kStageInts;
    const int rb = (t % kRingTiles) * kTile;       // t0's ring slot
    uint8_t* rt = ring + rb;
    const int lo = t0 + kTile - kRing;  // oldest position still in the ring
    const int p0 = t0 + tid, p1 = p0 + kThreads;
    // both chases at once, the warp in step (no divergent branch; a
    // finished chase reads its own slot again): follow src while it points
    // back inside the tile (t0 <= s < q as one unsigned compare of tile
    // offsets)
    const unsigned u0 = t0;
    unsigned q0 = tid, q1 = tid + kThreads;
    unsigned s0 = p0 < n ? static_cast<unsigned>(ts[q0]) - u0 : q0;
    unsigned s1 = p1 < n ? static_cast<unsigned>(ts[q1]) - u0 : q1;
    bool a0 = s0 < q0, a1 = s1 < q1;
    while (__any_sync(0xffffffffu, a0 || a1)) {
      const unsigned n0 = static_cast<unsigned>(ts[a0 ? s0 : q0]) - u0;
      const unsigned n1 = static_cast<unsigned>(ts[a1 ? s1 : q1]) - u0;
      q0 = a0 ? s0 : q0;
      s0 = a0 ? n0 : s0;
      q1 = a1 ? s1 : q1;
      s1 = a1 ? n1 : s1;
      a0 = a0 && s0 < q0;
      a1 = a1 && s1 < q1;
    }
    // a literal root (s == q), a source before the tile, or a pointer
    // that is not a match (forward or negative: byte 0)
    const auto byte_of = [&](unsigned s, unsigned q) -> uint8_t {
      if (s == q) return static_cast<uint8_t>(tl[q]);
      const int a = static_cast<int>(s + u0);        // the source position
      if (a < 0 || a >= t0) return 0;
      if (a < lo) return ld_cg_u8(o + a);
      const int i = rb + (a - t0);                   // a's ring slot
      return ring[i < 0 ? i + kRing : i];
    };
    const uint8_t v0 = byte_of(s0, q0), v1 = byte_of(s1, q1);
    if (p0 < n) {
      rt[tid] = v0;
      if (!vec_out) o[p0] = v0;
    }
    if (p1 < n) {
      rt[tid + kThreads] = v1;
      if (!vec_out) o[p1] = v1;
    }
    __syncthreads();
    if (vec_out && tid < kTile / 16 && tid * 16 < n - t0)
      *reinterpret_cast<uint4*>(o + t0 + tid * 16) =
          *reinterpret_cast<const uint4*>(rt + tid * 16);
  }
  cp_async_wait<0>();
}

// The shared-memory attribute is per device: set once on each.
cudaError_t set_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(resolve_bytes_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" int lf_resolve_bytes(const void* src, const void* lit, void* out,
                                int n_members, int n, void* stream) {
  if (n_members <= 0 || n <= 0) return 0;
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_in = n % 4 == 0 && al16(src) && al16(lit);
  const int vec_out = n % 16 == 0 && al16(out);
  resolve_bytes_kernel<<<n_members, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(lit),
      static_cast<uint8_t*>(out), n, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// registers, static shared, spill bytes, dynamic shared, resident blocks
// a SM, positions a tile, threads a block, stages, ring bytes
extern "C" int lf_resolve_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, resolve_bytes_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = kSmem;
  o[5] = kTile;
  o[6] = kThreads;
  o[7] = kStages;
  o[8] = kRing;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], resolve_bytes_kernel, kThreads, kSmem));
}
