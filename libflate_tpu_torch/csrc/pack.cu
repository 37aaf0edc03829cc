// Bit pack of the encode's field streams for Hopper (sm_90a).
//
// Replaces two TPU kernels in one pass: libflate_tpu/ops/pallas_pack.py
// `_pack_kernel` (via `pack_slots`: each 256-field slot-chunk packed into
// its own word column at alignment start & 31) and
// libflate_tpu/ops/pallas_stitch.py `_stitch_kernel` (via
// `stitch_cols_pallas`: the columns OR-ed into member word rows at word
// start >> 5).  The TPU needed the column buffer because a vreg cannot
// scatter; here each chunk's words go straight to the member row at
// (start >> 5) + q and no (B, n_ch, d_out) column buffer exists.
//
// Input: values and widths (B, F) int32 with F a multiple of 256, starts
// (B, F/256) int32 absolute bit offset of each chunk (>= 0; the chunks'
// bit ranges do not overlap, as chunk_starts gives them); output (B, w_out)
// int32 rows, zeroed by the caller.  Widths are clamped to [0, 32] (a
// negative width is 0); each value is masked to its width in 64 bits, so
// width 32 keeps all of it.  Words at or past w_out are dropped.
//
// What bounds it: bytes.  It must read every width, the values of the
// fields whose width is nonzero, the chunk starts, and write the packed
// stream once.  At the main path's shape most widths are zero: the token
// slots of each parse chunk are a prefix of live slots and then a hole,
// so whole 32-byte sectors of values carry no bit (chip_smoke.py counts
// the sectors that do, and prints the bound).  A thread that walked a
// chunk serially would load 1 KiB away from its neighbour lanes, each step
// waiting on the last.
//
// Design: one warp per chunk.  Lane l loads fields [4l, 4l + 4) and
// [128 + 4l, 128 + 4l + 4) of values and widths with 16-byte loads, so
// every load instruction of the warp reads 512 contiguous bytes.  The
// compiler issues the width loads first and the value loads after the
// exit of an empty chunk (sm_90a SASS), so a chunk of zero widths reads
// no value.  (Skipping also the values of a lane whose four widths are
// zero measured no faster on an H100: 40 registers against 32, 6 blocks
// a SM against 8.)  Two 5-step shuffle scans of the lanes' width sums
// give each lane the bit offset of its fields after start & 31.  Each lane
// packs its 4 + 4 fields through a 64-bit window and ORs the finished
// words into the warp's buffer in shared memory (at most 31 + 256 * 32
// bits: 257 words); only a lane's first and last words can be shared with
// its neighbours, and shared atomicOr keeps them exact.  After __syncwarp
// the warp writes the chunk's words to the row with coalesced plain
// stores.
//
// Why the words shared at chunk edges cannot break it: a word whose 32 bits
// all lie inside the chunk's range [start, start + bits) belongs to this
// chunk alone and gets a plain store.  Only the first word (when start & 31
// != 0) and the last (when the range ends inside a word) can hold a
// neighbour's bits; those two go to the row with global atomicOr, which is
// exact in any order of the chunks.  A chunk of zero bits writes nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFieldsPerChunk = 256;
constexpr int kWarps = 8;                   // chunks per block
constexpr int kBufWords = 264;              // >= 258 words a chunk can touch
static_assert(kFieldsPerChunk == 2 * 32 * 4, "two int4 halves a lane");

__device__ __forceinline__ int clamp_width(int w) {
  return min(max(w, 0), 32);
}

__device__ __forceinline__ int lane_bits(const int4& w) {
  return clamp_width(w.x) + clamp_width(w.y) + clamp_width(w.z)
         + clamp_width(w.w);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += o;
  }
  return x;
}

// OR four fields starting at relative bit r into the warp's buffer.
__device__ __forceinline__ void put4(uint32_t* buf, int r, const int4& v,
                                     const int4& w) {
  const int vs[4] = {v.x, v.y, v.z, v.w};
  const int ws[4] = {w.x, w.y, w.z, w.w};
  int word = r >> 5;
  int k = r & 31;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int wj = clamp_width(ws[j]);
    if (wj == 0) continue;
    const uint64_t x = static_cast<uint32_t>(vs[j]) & ((1ull << wj) - 1ull);
    acc |= x << k;
    k += wj;
    if (k >= 32) {
      atomicOr(buf + word, static_cast<uint32_t>(acc));
      acc >>= 32;
      k -= 32;
      ++word;
    }
  }
  if (k > 0 && acc != 0) atomicOr(buf + word, static_cast<uint32_t>(acc));
}

__global__ void __launch_bounds__(kWarps * 32)
pack_stitch_kernel(const int32_t* __restrict__ values,
                   const int32_t* __restrict__ widths,
                   const int32_t* __restrict__ starts,
                   uint32_t* __restrict__ out, int64_t n_chunks, int n_ch,
                   int w_out) {
  __shared__ uint32_t buf_all[kWarps][kBufWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (id >= n_chunks) return;               // whole warps leave; no barrier
  uint32_t* buf = buf_all[warp];
  for (int i = lane; i < kBufWords; i += 32) buf[i] = 0u;

  const int64_t f0 = id * kFieldsPerChunk;
  const int4* v4 = reinterpret_cast<const int4*>(values + f0);
  const int4* w4 = reinterpret_cast<const int4*>(widths + f0);
  // read once: streaming loads that do not keep the lines in cache
  const int4 va = __ldcs(v4 + lane), vb = __ldcs(v4 + lane + 32);
  const int4 wa = __ldcs(w4 + lane), wb = __ldcs(w4 + lane + 32);
  const int start = starts[id];

  const int sa = lane_bits(wa), sb = lane_bits(wb);
  const int ia = warp_inclusive_sum(sa, lane);
  const int ib = warp_inclusive_sum(sb, lane);
  const int tot_a = __shfl_sync(0xffffffffu, ia, 31);
  const int bits = tot_a + __shfl_sync(0xffffffffu, ib, 31);
  if (bits == 0) return;                    // uniform: the chunk is empty
  const int k0 = start & 31;
  __syncwarp();                             // buffer zeroed
  put4(buf, k0 + ia - sa, va, wa);
  put4(buf, k0 + tot_a + ib - sb, vb, wb);
  __syncwarp();

  const int n_words = (k0 + bits + 31) >> 5;
  const bool shared_first = k0 != 0;
  const bool shared_last = ((k0 + bits) & 31) != 0;
  const int64_t w0 = start >> 5;
  uint32_t* row = out + (id / n_ch) * static_cast<int64_t>(w_out);
  for (int i = lane; i < n_words; i += 32) {
    const int64_t g = w0 + i;
    if (g >= w_out) break;
    if (g < 0) continue;
    const uint32_t x = buf[i];
    if ((i == 0 && shared_first) || (i == n_words - 1 && shared_last)) {
      if (x != 0u) atomicOr(row + g, x);
    } else {
      row[g] = x;
    }
  }
}

}  // namespace

extern "C" int lf_pack_stitch(const void* values, const void* widths,
                              const void* starts, void* out, int n_members,
                              int n_ch, int w_out, void* stream) {
  const int64_t total = static_cast<int64_t>(n_members) * n_ch;
  if (total <= 0 || w_out <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(values)
        | reinterpret_cast<uintptr_t>(widths)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  pack_stitch_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(widths),
      static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out),
      total, n_ch, w_out);
  return static_cast<int>(cudaGetLastError());
}

// The kernel as compiled: out[0..6] = registers, static shared bytes,
// spill bytes, dynamic shared bytes (0), resident blocks per SM, chunks
// per block (kWarps), threads per block.
extern "C" int lf_pack_info(void* out) {
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, pack_stitch_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = 0;
  o[5] = kWarps;
  o[6] = kWarps * 32;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], pack_stitch_kernel, kWarps * 32, 0));
}
