// Bit pack of the encode's field streams for Hopper (sm_90a).
//
// Replaces two TPU kernels in one pass: libflate_tpu/ops/pallas_pack.py
// `_pack_kernel` (via `pack_slots`: each 256-field slot-chunk packed into
// its own word column at alignment start & 31) and
// libflate_tpu/ops/pallas_stitch.py `_stitch_kernel` (via
// `stitch_cols_pallas`: the columns OR-ed into member word rows at word
// start >> 5).  The TPU needed the column buffer because a vreg cannot
// scatter; a CUDA thread can write where it likes, so each thread packs
// one chunk into a 64-bit window starting at bit start & 31 and OR-s
// every finished 32-bit word straight into the member row at
// (start >> 5) + q.  Only a chunk's first and last words can be shared
// with a neighbour, and atomicOr makes those exact whatever the order;
// no (B, 386, 154) column buffer exists.
//
// Input: values and widths (B, F) int32 with F a multiple of 256 (zero
// width = no bits), starts (B, F/256) int32 absolute bit offset of each
// chunk; output (B, w_out) int32 rows, zeroed by the caller.  Widths are
// at most 32 (the encoder's invariant is <= 28; the caller checks it).
//
// What bounds it: bytes.  It reads 8 bytes per field and writes the
// packed stream once: for 128 x 98,560 fields ~100 MB, ~0.03 ms at
// 3.35 TB/s.  One thread per chunk walks its 256 fields serially; a
// warp's loads are 1 KiB apart (uncoalesced), the known slow part.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFieldsPerChunk = 256;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pack_stitch_kernel(const int32_t* __restrict__ values,
                   const int32_t* __restrict__ widths,
                   const int32_t* __restrict__ starts,
                   uint32_t* __restrict__ out, int n_members, int n_ch,
                   int w_out) {
  const int id = blockIdx.x * kThreads + threadIdx.x;
  if (id >= n_members * n_ch) return;
  const int b = id / n_ch;
  const int64_t f0 = static_cast<int64_t>(id) * kFieldsPerChunk;
  uint32_t* row = out + static_cast<int64_t>(b) * w_out;
  const int start = starts[id];
  int word = start >> 5;
  int k = start & 31;
  uint64_t acc = 0;
  for (int f = 0; f < kFieldsPerChunk; ++f) {
    const int w = min(widths[f0 + f], 32);
    if (w <= 0) continue;
    const uint64_t v = static_cast<uint32_t>(values[f0 + f])
                       & ((1ull << w) - 1ull);
    acc |= v << k;
    k += w;
    if (k >= 32) {
      if (word < w_out) atomicOr(row + word, static_cast<uint32_t>(acc));
      acc >>= 32;
      k -= 32;
      ++word;
    }
  }
  if (k > 0 && word < w_out) atomicOr(row + word, static_cast<uint32_t>(acc));
}

}  // namespace

extern "C" int lf_pack_stitch(const void* values, const void* widths,
                              const void* starts, void* out, int n_members,
                              int n_ch, int w_out, void* stream) {
  const int total = n_members * n_ch;
  if (total <= 0) return 0;
  pack_stitch_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(widths),
      static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out),
      n_members, n_ch, w_out);
  return static_cast<int>(cudaGetLastError());
}
