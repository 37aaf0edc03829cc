// Token statistics and entropy-coding fields for Hopper (sm_90a).
//
// lf_token_hist replaces libflate_tpu/ops/pallas_hist.py `_hist_kernel`
// (via `shared_histograms_pallas`): the batch-global litlen and distance
// symbol counts of the padded token slots.  Bins: 0..285 litlen (286, 287
// take literals 286 / 287 and are dropped by the glue), 288 + dist
// symbol; the glue adds one END_OF_BLOCK per member and the dummy
// distance code.  A valid slot with b > 0 is a match: length clamped to
// [3, 258], distance to at most 32768; any other valid slot counts its
// literal if 0 <= a < 288; invalid slots do not count.  The TPU kernel
// keeps one bin column per member lane and sweeps compare-selects over 40
// row groups; nothing of that carries over.
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
// pairs.  One thread per slot (grid-stride); the shared code tables and
// the length and distance LUTs are copied to shared memory once per
// block, and the distance code comes from the position of the highest
// set bit (the TPU kernel's float exponent trick, done with __clz).
// A slot with a < 0 is a hole: both widths 0.  It reads a and b and
// writes four int32 per slot (24 bytes per slot: 0.05 ms), one coalesced
// pass.
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

// RFC-1951 length (3..258) -> litlen symbol 257..285
__device__ __forceinline__ int length_symbol(int length) {
  const int l = length - 3;
  if (length == kMaxMatch) return 285;
  if (l < 8) return 257 + l;
  const int e = (31 - __clz(l)) - 2;        // extra bits, 1..5
  return 257 + 4 * e + 4 + ((l >> e) & 3);
}

// distance (1..32768) -> distance symbol 0..29
__device__ __forceinline__ int dist_symbol(int dist) {
  const int d = dist - 1;
  if (d < 4) return d;
  const int e = (31 - __clz(d)) - 1;        // extra bits, 1..13
  return 2 * e + 2 + ((d >> e) & 1);
}

__device__ __forceinline__ void count_slot(int* h, int av, int bv,
                                           bool ok) {
  if (!ok) return;
  if (bv > 0) {
    atomicAdd(&h[length_symbol(min(max(av, 3), kMaxMatch))], 1);
    atomicAdd(&h[kDistBase + dist_symbol(min(bv, kMaxDistance))], 1);
  } else if (av >= 0 && av < kDistBase) {
    atomicAdd(&h[av], 1);
  }
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

__global__ void __launch_bounds__(kFieldThreads)
token_fields_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b,
                    const int32_t* __restrict__ tables, int64_t n_slots,
                    int32_t* __restrict__ f1v, int32_t* __restrict__ f1w,
                    int32_t* __restrict__ f2v, int32_t* __restrict__ f2w) {
  __shared__ int32_t t[kTables];
  for (int i = threadIdx.x; i < kTables; i += blockDim.x) t[i] = tables[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n_slots; i += stride) {
    const int av = a[i], bv = b[i];
    const bool valid = av >= 0;
    const bool is_match = valid && bv > 0;
    int v1 = 0, w1 = 0, v2 = 0, w2 = 0;
    if (valid) {
      const int a_len = min(av, kMaxMatch);
      const int sym = is_match ? t[kLenCode + a_len] : min(av, 255);
      const int lw = t[kLitW + sym];
      const int nx = is_match ? t[kLenNextra + a_len] : 0;
      const int xv = is_match ? t[kLenExtra + a_len] : 0;
      v1 = t[kLitRev + sym] | (xv << lw);
      w1 = lw + nx;
    }
    if (is_match) {
      const int d = min(bv, kMaxDistance);
      const int ds = dist_symbol(d);
      const int dw = t[kDistW + ds];
      v2 = t[kDistRev + ds] | ((d - t[kDistBaseT + ds]) << dw);
      w2 = dw + t[kDistNextra + ds];
    }
    f1v[i] = v1;
    f1w[i] = w1;
    f2v[i] = v2;
    f2w[i] = w2;
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

extern "C" int lf_token_fields(const void* a, const void* b,
                               const void* tables, int64_t n_slots, void* f1v,
                               void* f1w, void* f2v, void* f2w,
                               void* stream) {
  if (n_slots <= 0) return 0;
  int64_t blocks = (n_slots + kFieldThreads - 1) / kFieldThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  token_fields_kernel<<<static_cast<int>(blocks), kFieldThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(tables), n_slots,
      static_cast<int32_t*>(f1v), static_cast<int32_t*>(f1w),
      static_cast<int32_t*>(f2v), static_cast<int32_t*>(f2w));
  return static_cast<int>(cudaGetLastError());
}
