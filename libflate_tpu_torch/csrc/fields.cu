// Token statistics and entropy-coding fields for Hopper (sm_90a).
//
// lf_token_hist replaces libflate_tpu/ops/pallas_hist.py `_hist_kernel`
// (via `shared_histograms_pallas`): the batch-global litlen and distance
// symbol counts of the padded token slots.  The TPU kernel keeps one bin
// column per member lane and sweeps compare-selects over 40 row groups;
// here each block counts into 320 shared-memory bins with shared atomics
// and adds them into one global table with integer atomics.  Integer sums
// do not depend on order, so the result is exact.  Bins: 0..285 litlen,
// 288 + dist symbol; the glue adds one END_OF_BLOCK per member and the
// dummy distance code.
//
// lf_token_fields replaces libflate_tpu/ops/pallas_fields.py
// `token_fields_pallas` / `_fields_compute`: per token slot the first
// field (literal or length code, bit-reversed, plus the length's extra
// bits) and the second (distance code plus extra bits) as (value, width)
// pairs.  One thread per slot (grid-stride); the shared code tables and
// the length and distance LUTs are copied to shared memory once per
// block, and the distance code comes from the position of the highest
// set bit (the TPU kernel's float exponent trick, done with __clz).
// A slot with a < 0 is a hole: both widths 0.
//
// What bounds them: bytes.  The histogram reads a, b and valid once (9
// bytes per slot: 57 MB for 128 x 49152 slots, 0.017 ms at 3.35 TB/s);
// the fields read a and b and write four int32 per slot (24 bytes per
// slot: 0.05 ms).  Both are one coalesced pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 320;
constexpr int kDistBase = 288;
constexpr int kHistThreads = 256;
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

__global__ void __launch_bounds__(kHistThreads)
token_hist_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b,
                  const uint8_t* __restrict__ valid, int64_t n_slots,
                  int32_t* __restrict__ bins) {
  __shared__ int local[kBins];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) local[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n_slots; i += stride) {
    if (!valid[i]) continue;
    const int av = a[i], bv = b[i];
    if (bv > 0) {
      atomicAdd(&local[length_symbol(min(max(av, 3), kMaxMatch))], 1);
      atomicAdd(&local[kDistBase + dist_symbol(min(bv, kMaxDistance))], 1);
    } else if (av >= 0 && av < kDistBase) {
      atomicAdd(&local[av], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x)
    if (local[i]) atomicAdd(&bins[i], local[i]);
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

extern "C" int lf_token_hist(const void* a, const void* b, const void* valid,
                             int64_t n_slots, void* bins, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(bins, 0, kBins * sizeof(int32_t), s);
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (n_slots + kHistThreads - 1) / kHistThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  token_hist_kernel<<<static_cast<int>(blocks), kHistThreads, 0, s>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const uint8_t*>(valid), n_slots,
      static_cast<int32_t*>(bins));
  return static_cast<int>(cudaGetLastError());
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
