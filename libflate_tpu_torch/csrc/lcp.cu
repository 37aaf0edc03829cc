// Exact capped match lengths for Hopper (sm_90a).
//
// lf_match_lengths replaces libflate_tpu/ops/pallas_lcp.py `_lcp_kernel`
// (via `match_lengths_pallas`): for every position e of a member, the
// length of the common prefix of the bytes at e and at cand[e], grown 4
// bytes a round from `first_round` to `max_rounds` and capped at
// lim = clip(min(258, n_valid - e), 0); 0 where cand < 0.
//
// The sweep's bounds are part of the result and are kept exactly: a word
// whose 1024-position group lies outside the swept band reads 0.  The
// candidate band is [cs, cs + win_groups) with
// cs = clip(e/1024 - (win_groups - 2), 0, groups - win_groups); the
// position band is [min(e/1024, groups - 2), +2).  With m4 (the sort
// matcher's exact prefix, first_round = m_exact/4 rounds already done),
// a position extends only where m4 >= m_exact, lim > m_exact and
// cand >= 1024 * cs.
//
// The TPU kernel keeps the member's words in VMEM and sweeps row groups
// of lane shuffles.  Here a 256-thread block takes a slice of 4096
// positions of one member and keeps in shared memory exactly the bytes
// its positions can read: the union of their candidate bands (which
// holds their position bands) and the 16 bytes after it, zero past the
// row, staged with 16-byte cp.async (37,904 bytes at window 32768, 13,328
// at 8192).  A word is then one or two aligned shared reads and a funnel
// shift.  An active position's length is 4 bytes a round past its start
// and below lim <= 258, so its own word never leaves its position band;
// only the candidate's word is checked against the band.
//
// What bounds it: without m4 (hash candidates, chain levels) every
// position with a candidate is active from round 0 and most stop within
// a round or two (1.6-2.0 rounds a position on text), so a warp stepping
// its 32 positions in lockstep would issue max_rounds rounds for the few
// long matches.  Instead each warp (1) reads cand (and m4) as 16-byte
// vectors while the band is staged, writes the starting lengths into a
// shared tile and queues its active positions, then (2) runs the rounds
// over its queue, 32 items at a time, compacting the survivors in place
// with a ballot, so issue follows the rounds the data needs.  What is
// left is shared-memory traffic: a candidate's words lie anywhere in the
// band, so their reads meet bank conflicts.  The lengths leave the tile
// as 16-byte stores.  Bytes: cand, m4 and the lengths once, the member
// bytes once from device memory (the blocks of a member re-read their
// overlapping bands from L2): 13 bytes a position with m4, 9 without
// (109 / 75 MB for 128 x 65536).  chip_smoke.py reports the measured
// times beside those.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 4096;       // positions a block (12-bit queue index)
constexpr int kPerWarp = kSlice / kWarps;      // within one row group
constexpr int kQuads = kPerWarp / 128;         // int4 of positions a lane
constexpr int kGroup = 1024;       // positions per swept row group
constexpr int kMaxMatch = 258;
constexpr int kPad = 16;           // bytes staged past the last band
constexpr int kMaxN = 1 << 20;     // a queue item keeps cand in 20 bits

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ int band_start(int t, int win_groups,
                                          int groups) {
  return min(max(t - (win_groups - 2), 0), groups - win_groups);
}

// Little-endian bytes p..p+3, from the staged bytes that start at byte lo
// of the row (4-byte words; the stage's bytes past the row are 0).  An
// aligned p reads one word, which spares a shared-memory wavefront.
__device__ __forceinline__ uint32_t staged_word(const uint32_t* s, int p,
                                                int lo) {
  const int i = (p - lo) >> 2;
  const uint32_t w = s[i];
  return p & 3 ? __funnelshift_r(w, s[i + 1], (p & 3) * 8) : w;
}

// Shared bytes of a launch: the widest staged span, then the lengths tile
// and the queues (4 bytes a position each).
__host__ __device__ inline int smem_bytes(int n, int win_groups) {
  const int len = n < kSlice ? n : kSlice;
  const int groups = n / kGroup;
  const int span_groups = win_groups + len / kGroup - 1;
  return (span_groups < groups ? span_groups : groups) * kGroup + kPad +
         8 * len;
}

__global__ void __launch_bounds__(kThreads, 4)
lcp_kernel(const uint8_t* __restrict__ blocks,
           const int32_t* __restrict__ cand, const int32_t* __restrict__ m4,
           const int32_t* __restrict__ n_valid, int32_t* __restrict__ out,
           int n, int max_rounds, int win_groups, int first_round) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kSlice;
  const int len = min(kSlice, n - e0);
  const int groups = n / kGroup;
  const int t0 = e0 / kGroup;
  const int lo = band_start(t0, win_groups, groups) * kGroup;
  const int hi = (band_start(t0 + len / kGroup - 1, win_groups, groups) +
                  win_groups) * kGroup;
  const int span = hi - lo + kPad;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  int32_t* lens = reinterpret_cast<int32_t*>(smem + span);
  uint32_t* queue = reinterpret_cast<uint32_t*>(lens + len);
  const uint8_t* row = blocks + static_cast<int64_t>(b) * n;

  // stage the slice's bands; n and lo are multiples of 1024, so a 16-byte
  // piece lies wholly inside the row or wholly past it
  for (int k = threadIdx.x * 16; k < span; k += kThreads * 16) {
    if (lo + k < n) cp_async16(smem + k, row + lo + k);
    else *reinterpret_cast<uint4*>(smem + k) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // (1) the warp's kPerWarp positions, 4 consecutive a lane (they lie in
  // one row group, so their candidate band [blo, blo + blen) is the
  // warp's): the starting lengths into the tile and the active positions
  // into the warp's queue.  An item is the slice index (12 bits) and
  // min(cand, n - 1) (20 bits), which reads the same words as cand.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int w0 = warp * kPerWarp;
  const bool busy = w0 < len;                      // warp-uniform
  const int nv = n_valid[b];
  const int exact = 4 * first_round;
  const int blo = band_start((e0 + w0) / kGroup, win_groups, groups) *
                  kGroup;
  const unsigned blen = win_groups * kGroup;
  const int64_t off = static_cast<int64_t>(b) * n + e0;
  uint32_t* q = queue + w0;
  int qn = 0;
  if (busy) {
    int4 cq[kQuads], mq[kQuads];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int s0 = w0 + lane * 4 + u * 128;
      cq[u] = __ldg(reinterpret_cast<const int4*>(cand + off + s0));
      mq[u] = first_round
                  ? __ldg(reinterpret_cast<const int4*>(m4 + off + s0))
                  : cq[u];
    }
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int s0 = w0 + lane * 4 + u * 128;
      const int cv[4] = {cq[u].x, cq[u].y, cq[u].z, cq[u].w};
      const int mv[4] = {mq[u].x, mq[u].y, mq[u].z, mq[u].w};
      int ln[4];
      bool act[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cv[j];
        const int lim = max(min(kMaxMatch, nv - (e0 + s0 + j)), 0);
        if (first_round == 0) {
          ln[j] = 0;
          act[j] = c >= 0 && lim > 0;
        } else {
          ln[j] = c >= 0 ? min(mv[j], lim) : 0;
          act[j] = c >= 0 && mv[j] >= exact && lim > exact && c >= blo;
        }
      }
      *reinterpret_cast<int4*>(lens + s0) = make_int4(ln[0], ln[1], ln[2],
                                                      ln[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned m = __ballot_sync(0xffffffffu, act[j]);
        if (act[j])
          q[qn + __popc(m & below)] =
              static_cast<uint32_t>(s0 + j) |
              static_cast<uint32_t>(min(cv[j], n - 1)) << 12;
        qn += __popc(m);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!busy) return;

  // (2) the rounds over the queue, 32 items at a time; survivors are
  // written back in place (a chunk's writes land at or below its reads).
  // Without m4 an active item's length is 4r at round r, so only a
  // finished item writes its length; with m4 the tile holds it.
  int r = first_round;
  for (; r < max_rounds && qn > 0; ++r) {
    const int d = 4 * r;
    int wn = 0;
    for (int i0 = 0; i0 < qn; i0 += 32) {
      const int i = i0 + lane;
      uint32_t it = 0;
      bool keep = false;
      if (i < qn) {
        it = q[i];
        const int s = static_cast<int>(it & 0xFFFu);
        const int e = e0 + s;
        const int lim = min(kMaxMatch, nv - e);            // > 0: active
        const int tc = min(static_cast<int>(it >> 12) + d, n - 1);
        const bool in_band = static_cast<unsigned>(tc - blo) < blen;
        const uint32_t wc = staged_word(words, in_band ? tc : blo, lo);
        const uint32_t x = (in_band ? wc : 0u) ^
                           staged_word(words, min(e + d, n - 1), lo);
        const int k = x == 0 ? 4 : (__ffs(x) - 1) >> 3;
        const int ln = min((first_round == 0 ? d : lens[s]) + k, lim);
        keep = x == 0 && ln < lim;
        if (first_round != 0 || !keep) lens[s] = ln;
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) q[wn + __popc(m & below)] = it;
      wn += __popc(m);
    }
    qn = wn;
    __syncwarp();
  }
  if (first_round == 0)                  // still matching after the rounds
    for (int i = lane; i < qn; i += 32) lens[q[i] & 0xFFFu] = 4 * r;
  __syncwarp();
  int32_t* o = out + off;
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int k = w0 + lane * 4 + u * 128;
    *reinterpret_cast<int4*>(o + k) =
        *reinterpret_cast<const int4*>(lens + k);
  }
}

// The dynamic shared-memory limit is per device: raised once on each to
// the device's opt-in maximum, which is returned.
cudaError_t set_smem(int* max_smem) {
  static int limit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && limit[dev]) {
    *max_smem = limit[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      lcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  if (err == cudaSuccess && dev < 64) limit[dev] = *max_smem;
  return err;
}

}  // namespace

extern "C" int lf_match_lengths(const void* blocks, const void* cand,
                                const void* m4, const void* n_valid,
                                void* out, int n_members, int n,
                                int max_rounds, int win_groups,
                                int first_round, void* stream) {
  if (n_members <= 0) return 0;
  const int groups = n / kGroup;
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n <= 0 || n % kGroup || n > kMaxN || n_members > 65535
      || win_groups < 1 || win_groups > groups || first_round < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!al16(blocks) || !al16(cand) || !al16(m4) || !al16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int max_smem = 0;
  const cudaError_t err = set_smem(&max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(n, win_groups);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kSlice - 1) / kSlice, n_members);
  lcp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(m4), static_cast<const int32_t*>(n_valid),
      static_cast<int32_t*>(out), n, max_rounds, win_groups, first_round);
  return static_cast<int>(cudaGetLastError());
}

// At n positions and win_groups swept groups: registers, static shared,
// spill bytes, dynamic shared, resident blocks a SM, threads a block,
// positions a block.
extern "C" int lf_lcp_info(int n, int win_groups, void* out) {
  int* o = static_cast<int*>(out);
  if (n <= 0 || n % kGroup || n > kMaxN || win_groups < 1
      || win_groups > n / kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, lcp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = set_smem(&max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = smem_bytes(n, win_groups);
  o[5] = kThreads;
  o[6] = kSlice;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], lcp_kernel, kThreads, o[3]));
}
