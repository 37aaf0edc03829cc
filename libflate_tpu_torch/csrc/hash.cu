// Single-slot hash-table LZ77 candidates for Hopper (sm_90a).
//
// lf_hash_candidates replaces libflate_tpu/ops/pallas_lz77.py
// `_hash_kernel` (via `hash_candidates`).  Each position p carries a
// packed id h = bucket | fp << 12 (12-bit bucket, 14-bit fingerprint);
// its candidate is the earlier position that the member's 4096-slot table
// holds for its bucket.  The table is a sequential recurrence over the
// member, so one block (one warp) owns one member, keeps the table (16
// KiB) in shared memory and walks the positions in order, 8 per step, as
// the TPU kernel does.  The step's rules change which candidates exist,
// so they are kept exactly:
//
// - lookup reads the table as it stood before the step; a slot holds
//   pos | fp << 17, and a fingerprint mismatch gives -1;
// - position j's candidate becomes base + i for the latest i < j of the
//   same step with an equal h;
// - insert: among the step's positions with the same low 3 bucket bits,
//   only the three newest are written, oldest first (the newest wins),
//   and older ones are dropped even when their buckets differ.  So a
//   position writes iff fewer than 3 later positions of the step share
//   its low bits and none shares its bucket: the writes go to distinct
//   slots and need no order.
//
// A warp loads 32 ids at once (four steps) and runs the steps one after
// another, lanes 8s..8s+7 owning step s; the step's ids reach the other
// lanes by shuffles.  The TPU grid's 2048-position chunks and their
// padding change nothing for positions < n.
//
// What bounds it: latency.  Every step waits on the previous step's table
// writes; 128 members run on 128 SMs, 8192 dependent steps each at 64
// KiB.  The bytes are h once and out once (8 bytes a position: 67 MB for
// 128 x 65536, 0.020 ms at 3.35 TB/s); chip_smoke.py reports the
// measured time beside that bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 4096;
constexpr int kBucketBits = 12;
constexpr int kStep = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
hash_kernel(const int32_t* __restrict__ h, int32_t* __restrict__ out,
            int n) {
  __shared__ int32_t tbl[kBuckets];
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  for (int k = lane; k < kBuckets; k += 32) tbl[k] = -1;
  __syncwarp();
  const int j = lane & (kStep - 1);
  const int step = lane / kStep;
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int p = p0 + lane;
    const int hv = p < n ? h[row + p] : 0;
    const int bucket = hv & (kBuckets - 1);
    const int fp = hv >> kBucketBits;
    int res = -1;
    for (int s = 0; s < 32 / kStep; ++s) {
      const int base = p0 + s * kStep;
      const int slot = tbl[bucket];
      int cand = slot >= 0 && (slot >> 17) == fp ? (slot & 0x1FFFF) : -1;
      int newer_low = 0;
      bool newer_bucket = false;
      for (int i = 0; i < kStep; ++i) {
        const int hi = __shfl_sync(kFull, hv, s * kStep + i);
        if (i < j && hi == hv) cand = base + i;
        if (i > j) {
          newer_low += (hi & 7) == (hv & 7);
          newer_bucket |= (hi & (kBuckets - 1)) == bucket;
        }
      }
      const bool mine = step == s;
      if (mine) res = cand;
      __syncwarp();
      if (mine && newer_low < 3 && !newer_bucket)
        tbl[bucket] = (base + j) | (fp << 17);
      __syncwarp();
    }
    if (p < n) out[row + p] = res;
  }
}

}  // namespace

extern "C" int lf_hash_candidates(const void* h, void* out, int n_members,
                                  int n, void* stream) {
  if (n_members <= 0 || n <= 0) return 0;
  if (n % kStep || n > (1 << 17))
    return static_cast<int>(cudaErrorInvalidValue);
  hash_kernel<<<n_members, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(h), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
