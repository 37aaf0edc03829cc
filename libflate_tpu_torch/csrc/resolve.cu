// LZ77 pointer chase to plaintext bytes for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_expand.py
// `_resolve_kernel` / `_resolve_loop` in its default "uband" mode (wrappers
// `resolve_packed`, `resolve_bytes`).  After the rank kernel's
// mod-collapse, src[p] < p for every match byte and src[p] == p for
// literals and padding, so following src from any position ends at a
// literal root, whose byte is lit[root].
//
// What bounds it: one byte written per position, but each position's
// chase is a chain of dependent reads.  Design: one block per member walks
// the member in tiles of 1024 positions, in order.  A tile's src and lit
// are loaded once into shared memory (coalesced); each thread then chases
// its position inside the tile in shared memory until it reaches a literal
// root (byte lit[root]) or a source before the tile, whose byte the block
// already wrote to `out` in an earlier tile (L2-hot, visible after the
// __syncthreads() that ends every tile).  So no chase leaves the tile, and
// `out` in global memory serves any member length.  Worst case: a chase
// takes at most one step per token that starts inside the tile, fewer
// than 1024, e.g. ~340 for a run of 3-byte matches each copying the one
// before; typical text takes a handful.  The TPU kernel's in-register
// pointer doubling, sibling selects, far-row sweeps and sublane byte
// packing exist for Mosaic's vregs and are not carried over: the bytes are
// written directly, one per position.
//
// A pointer that is not a match (src[p] > p or < 0: corrupt input the
// rank kernel never emits) ends the chase with byte 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;

__global__ void __launch_bounds__(kTile)
resolve_bytes_kernel(const int32_t* __restrict__ src,
                     const int32_t* __restrict__ lit,
                     uint8_t* __restrict__ out, int n) {
  __shared__ int32_t s_src[kTile];
  __shared__ uint8_t s_lit[kTile];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const int32_t* sr = src + row;
  const int32_t* lr = lit + row;
  uint8_t* o = out + row;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int p = t0 + static_cast<int>(threadIdx.x);
    if (p < n) {
      s_src[threadIdx.x] = sr[p];
      s_lit[threadIdx.x] = static_cast<uint8_t>(lr[p]);
    }
    __syncthreads();
    if (p < n) {
      int q = p;
      int s = s_src[threadIdx.x];
      while (s < q && s >= t0) {        // strictly backwards, inside the tile
        q = s;
        s = s_src[q - t0];
      }
      uint8_t v = 0;
      if (s == q) v = s_lit[q - t0];            // literal root
      else if (s >= 0 && s < t0) v = o[s];      // resolved in an earlier tile
      o[p] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lf_resolve_bytes(const void* src, const void* lit, void* out,
                                int n_members, int n, void* stream) {
  if (n_members <= 0 || n <= 0) return 0;
  resolve_bytes_kernel<<<n_members, kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(lit),
      static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
