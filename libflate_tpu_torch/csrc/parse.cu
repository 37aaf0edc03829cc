// Greedy LZ77 parse for Hopper (sm_90a): chunk exits and the walk-emit.
//
// Replaces the TPU kernels of libflate_tpu/ops/pallas_parse.py:
// `_exit_kernel` (via `parse_chunk_exits`) and `_walk_kernel` (via
// `parse_walk_emit`), with the serial `parse_entries` scan folded into
// the walk launch.  A member's positions are cut into 512-position
// chunks; jump[p] = min(p + max(1, len[p]), n) advances by at most 258,
// so the parse orbit enters every chunk exactly once.
//
// lf_chunk_exits: one thread per (member, chunk) runs the chunk
// backward: exit[p] = jump[p] >= end ? jump[p] : exit[jump[p]].  Jumps
// strictly increase, so every successor is final before p reads it.  The
// TPU kernel's in-tile pointer doubling and 33-tile look-ahead exist to
// keep each step a vreg shuffle; a thread's serial loop needs neither.
//
// lf_walk_emit: one block per member.  Thread 0 threads the chunk entries
// (entry[0] = 0, entry[c+1] = exit[entry[c]]) into shared memory; then
// thread c walks chunk c's orbit from its entry, writing the packed token
// of each visited position (-1 past the member's valid bytes) to the
// next of its `cap` output slots, -1 in the rest, and flags overflow
// when a token (>= 0) falls past slot `cap` (the reference's rule).
//
// What bounds it: latency, not bytes.  Each step is a dependent load
// (jump[p] then exit[jump[p]] / tok[p]); a chunk walks at most 512 steps.
// The bytes are read jump + tok once, write exits once, write the
// (B, n*cap/512) tokens once: ~100 MB for 128 x 64 KiB, ~0.03 ms at
// 3.35 TB/s; chip_smoke.py reports the measured time beside that bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;
constexpr int kExitThreads = 128;
constexpr int kMaxChunks = 1024;

__global__ void __launch_bounds__(kExitThreads)
chunk_exits_kernel(const int32_t* __restrict__ jump, int32_t* exits,
                   int n_members, int n) {
  const int nc = n / kChunk;
  const int id = blockIdx.x * kExitThreads + threadIdx.x;
  if (id >= n_members * nc) return;
  const int b = id / nc, c = id % nc;
  const int64_t row = static_cast<int64_t>(b) * n;
  const int base = c * kChunk, end = base + kChunk;
  for (int p = end - 1; p >= base; --p) {
    const int j = jump[row + p];
    exits[row + p] = j >= end ? j : exits[row + j];
  }
}

__global__ void walk_emit_kernel(const int32_t* __restrict__ jump,
                                 const int32_t* __restrict__ tok,
                                 const int32_t* __restrict__ exits,
                                 int32_t* __restrict__ out,
                                 int32_t* __restrict__ ovf, int n, int cap) {
  __shared__ int entry[kMaxChunks];
  const int nc = n / kChunk;
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * n;
  if (threadIdx.x == 0) {
    int e = 0;
    for (int c = 0; c < nc; ++c) {
      entry[c] = e;
      if (c + 1 < nc) e = exits[row + min(max(e, 0), n - 1)];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int end = (c + 1) * kChunk;
    int32_t* o = out + (static_cast<int64_t>(b) * nc + c) * cap;
    int cur = entry[c], k = 0, flag = 0;
    while (cur >= c * kChunk && cur < end) {
      const int t = tok[row + cur];
      if (k < cap) o[k] = t;
      else if (t >= 0) flag = 1;
      ++k;
      cur = jump[row + cur];
    }
    for (; k < cap; ++k) o[k] = -1;
    ovf[static_cast<int64_t>(b) * nc + c] = flag;
  }
}

}  // namespace

extern "C" int lf_chunk_exits(const void* jump, void* exits, int n_members,
                              int n, void* stream) {
  if (n_members <= 0) return 0;
  if (n % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const int total = n_members * (n / kChunk);
  chunk_exits_kernel<<<(total + kExitThreads - 1) / kExitThreads,
                       kExitThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(jump), static_cast<int32_t*>(exits),
      n_members, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lf_walk_emit(const void* jump, const void* tok,
                            const void* exits, void* out, void* ovf,
                            int n_members, int n, int cap, void* stream) {
  if (n_members <= 0) return 0;
  if (n % kChunk || n / kChunk > kMaxChunks || cap <= 0 || cap > kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = n / kChunk;
  const int threads = ((nc + 31) / 32) * 32;
  walk_emit_kernel<<<n_members, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(jump), static_cast<const int32_t*>(tok),
      static_cast<const int32_t*>(exits), static_cast<int32_t*>(out),
      static_cast<int32_t*>(ovf), n, cap);
  return static_cast<int>(cudaGetLastError());
}
