// Single-slot hash-table LZ77 candidates for Hopper (sm_90a).
//
// lf_hash_candidates replaces libflate_tpu/ops/pallas_lz77.py
// `_hash_kernel` (via `hash_candidates`).  Each position p carries a
// packed id h = bucket | fp << 12 (12-bit bucket, 14-bit fingerprint);
// the member's 4096-slot table is walked 8 positions a step:
//
// - lookup reads the table as it stood before the step (in the plain
//   version a slot holds pos | fp << 17); a fingerprint mismatch gives -1;
// - position j's candidate becomes base + i for the latest i < j of the
//   same step with an equal h;
// - insert: among the step's positions with the same low 3 bucket bits,
//   only the three newest are written, oldest first (the newest wins),
//   and older ones are dropped even when their buckets differ.  So a
//   position writes iff fewer than 3 later positions of the step share
//   its low bits and none shares its bucket.
//
// The walk need not be sequential.  Whether a position writes is decided
// by its step's 8 ids alone, never by the table, so at the start of step
// t the slot of bucket b holds the latest writer q < 8t with bucket(q) =
// b.  A position's candidate is that writer if its fingerprint equals the
// position's (else -1), unless the step override applies.
//
// What bounds it: on paper bytes (h read once, out written once, 8 bytes
// a position: 67 MB for 128 x 65536, 0.020 ms at 3.35 TB/s).  The old
// one-warp-a-member walk was 8192 dependent table steps at ~233 ns; here
// the walk is cut into chunks and what is left is instructions: the step
// rules (28 id pairs a step) and the chunk walks' steps.
// Design: one block of kWarps warps a member; the member is cut into
// kWarps chunks of whole 256-position groups, one a warp, each with a
// table of its own in shared memory (kWarps x 16 KiB):
//
// 1. a lane a step, 8 ids in registers (staged through a buffer of the
//    warp's in shared memory, so that global loads and stores stay
//    coalesced; the next group's ids load while a group is worked):
//    each position's writer flag, step override and representative (the
//    step's last position with its bucket, the only one of them that may
//    write), kept as a code word in `out`; each writer's slot
//    atomicMax-ed into its chunk's table, so the table ends as the
//    chunk's last writer per bucket (a slot grows with its position);
// 2. a prefix max over the chunks' tables, bucket by bucket: each chunk's
//    table becomes its carry-in, the last writer before the chunk;
// 3. each warp walks its chunk from its carry-in 32 positions (four
//    steps) a round: step by step, a representative reads its bucket's
//    slot and, if it writes, writes it in the same thread (a step's
//    writes go to distinct buckets); one __syncwarp() a step orders the
//    steps; the step's other positions of that bucket take the read by a
//    shuffle.  Ids and codes come 8 rounds ahead into registers.
//
// __match_any_sync, which would resolve a round's four steps at once, is
// not used: on ids and buckets (many distinct values a warp) it cost more
// than the steps it saves.
//
// A slot is ((pos << 15) | fp) + 1 for 0 <= fp < 2^14 (every id
// `keys_hashes` makes), 0 when empty; other ids (any int32 is taken) put
// 2^14 in the fingerprint field and the fingerprint is read back from h.
// The only scratch is `out` itself (the codes, before the candidates).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 4096;
constexpr int kBucketBits = 12;
constexpr int kStep = 8;
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 32 * kStep;         // positions of a lane-a-step pass
constexpr int kAhead = 8;                  // rounds of ids in registers
constexpr int kMaxN = 1 << 17;
constexpr int kSmem = kWarps * (kBuckets + kGroup) * 4;
constexpr unsigned kFull = 0xffffffffu;

// positions a warp's chunk, whole groups
__host__ __device__ constexpr int chunk_len(int n) {
  return (n + kGroup * kWarps - 1) / (kGroup * kWarps) * kGroup;
}

__device__ __forceinline__ unsigned slot_of(int pos, int v) {
  const int fp = v >> kBucketBits;
  const unsigned code = fp >= 0 && fp < (1 << 14) ? fp : 1u << 14;
  return ((static_cast<unsigned>(pos) << 15) | code) + 1u;
}

// The candidate a slot gives a position with fingerprint fp.
__device__ __forceinline__ int cand_of(unsigned e, int fp,
                                       const int32_t* __restrict__ hr) {
  const unsigned f = e - 1u;
  const int q = static_cast<int>(f >> 15);
  const int code = static_cast<int>(f & 0x7FFF);
  if (e != 0 && code >= (1 << 14)) {              // fingerprint not in slot
    const int fq = __ldg(hr + q) >> kBucketBits;
    return fq >= 0 && fq == fp ? q : -1;
  }
  return e != 0 && code == fp ? q : -1;
}

__global__ void __launch_bounds__(kThreads, 1)
hash_kernel(const int32_t* __restrict__ h, int32_t* __restrict__ out,
            int n) {
  extern __shared__ __align__(16) unsigned tables[];   // [kWarps][kBuckets]
  const int len = chunk_len(n);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const int32_t* hr = h + row;
  int32_t* orow = out + row;
  for (int k = threadIdx.x; k < kWarps * kBuckets / 4; k += kThreads)
    reinterpret_cast<uint4*>(tables)[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = w * len;
  const int c1 = max(c0, min(c0 + len, n));
  unsigned* tbl = tables + w * kBuckets;

  // 1. a lane a step, through a 256-id buffer of the warp's (coalesced
  //    global loads and stores)
  int* buf = reinterpret_cast<int*>(tables + kWarps * kBuckets) + w * kGroup;
  int ahead[kStep];                                    // the next group's ids
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    const int p = c0 + 32 * k + lane;
    ahead[k] = p < c1 ? __ldg(hr + p) : 0;
  }
  for (int g0 = c0; g0 < c1; g0 += kGroup) {
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      buf[32 * k + lane] = ahead[k];
      const int p = g0 + kGroup + 32 * k + lane;
      ahead[k] = p < c1 ? __ldg(hr + p) : 0;
    }
    __syncwarp();
    const int q0 = g0 + kStep * lane;
    int x[kStep], code[kStep];
    const int4* b4 = reinterpret_cast<const int4*>(buf + kStep * lane);
    const int4 xa = b4[0], xb = b4[1];
    x[0] = xa.x; x[1] = xa.y; x[2] = xa.z; x[3] = xa.w;
    x[4] = xb.x; x[5] = xb.y; x[6] = xb.z; x[7] = xb.w;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      int newer_low = 0, ov = 0, rep = j;
      bool newer_bucket = false;
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const int d = x[i] ^ x[j];
        if (i > j) {
          newer_low += (d & 7) == 0;
          if ((d & (kBuckets - 1)) == 0) {
            newer_bucket = true;
            rep = i;                                   // the last of them
          }
        }
        if (i < j && d == 0) ov = i + 1;               // the latest i < j
      }
      const bool wr = newer_low < 3 && !newer_bucket && q0 < c1;
      if (wr) atomicMax(tbl + (x[j] & (kBuckets - 1)), slot_of(q0 + j, x[j]));
      code[j] = static_cast<int>(wr) | ov << 1 | rep << 4;
    }
    __syncwarp();
    int4* c4 = reinterpret_cast<int4*>(buf + kStep * lane);
    c4[0] = make_int4(code[0], code[1], code[2], code[3]);
    c4[1] = make_int4(code[4], code[5], code[6], code[7]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const int p = g0 + 32 * k + lane;
      if (p < c1) orow[p] = buf[32 * k + lane];
    }
    __syncwarp();
  }
  __syncthreads();

  // 2. carry-in tables
  for (int b = threadIdx.x; b < kBuckets; b += kThreads) {
    unsigned run = 0;
#pragma unroll
    for (int c = 0; c < kWarps; ++c) {
      const unsigned t = tables[c * kBuckets + b];
      tables[c * kBuckets + b] = run;
      run = max(run, t);
    }
  }
  __syncthreads();

  // 3. the walk
  const int rounds = (c1 - c0 + 31) / 32;   // the last may end mid-round
  const int s = lane >> 3, j = lane & (kStep - 1);
  int cv[kAhead], cc[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int p = c0 + 32 * k + lane;
    cv[k] = p < c1 ? __ldg(hr + p) : 0;
    cc[k] = p < c1 ? __ldcg(orow + p) : 0;
  }
  for (int i0 = 0; i0 < rounds; i0 += kAhead) {
    int nv[kAhead], nc[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {                 // kAhead rounds on
      const int p = c0 + 32 * (i0 + kAhead + k) + lane;
      nv[k] = p < c1 ? __ldg(hr + p) : 0;
      nc[k] = p < c1 ? __ldcg(orow + p) : 0;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (i0 + k >= rounds) break;                     // warp-uniform
      const int r0 = c0 + 32 * (i0 + k);
      const int p = r0 + lane;
      const int v = cv[k], code = cc[k];
      const int b = v & (kBuckets - 1);
      const int rep = (code >> 4) & 7;
      const unsigned slot = slot_of(p, v);
      unsigned e = 0;
#pragma unroll
      for (int t = 0; t < 32 / kStep; ++t) {          // predicated, no branch
        const bool me = (s == t) & (j == rep);
        if (me) e = tbl[b];
        if (me & (code & 1)) tbl[b] = slot;
        __syncwarp();
      }
      e = __shfl_sync(kFull, e, (lane & ~(kStep - 1)) | rep);
      const int ov = (code >> 1) & 7;
      if (p < c1)         // whole steps: n is a multiple of 8
        orow[p] = ov ? r0 + kStep * s + ov - 1
                     : cand_of(e, v >> kBucketBits, hr);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cv[k] = nv[k];
      cc[k] = nc[k];
    }
  }
}

// The shared-memory attribute is per device: set once on each.
cudaError_t set_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(
      hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" int lf_hash_candidates(const void* h, void* out, int n_members,
                                  int n, void* stream) {
  if (n_members <= 0 || n <= 0) return 0;
  if (n % kStep || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  hash_kernel<<<n_members, kThreads, kSmem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(h), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// At n positions a member: registers, static shared, spill bytes, dynamic
// shared, resident blocks a SM, warps a block, positions a warp's chunk.
extern "C" int lf_hash_info(int n, void* out) {
  if (n <= 0 || n % kStep || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, hash_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = kSmem;
  o[5] = kWarps;
  o[6] = chunk_len(n);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], hash_kernel, kThreads, kSmem));
}
