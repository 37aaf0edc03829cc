// Exact capped match lengths for Hopper (sm_90a).
//
// lf_match_lengths replaces libflate_tpu/ops/pallas_lcp.py `_lcp_kernel`
// (via `match_lengths_pallas`): for every position e of a member, the
// length of the common prefix of the bytes at e and at cand[e], grown 4
// bytes a round and capped at lim = clip(min(258, n_valid - e), 0).
//
// The TPU kernel keeps the member's words in VMEM and, lacking a gather,
// reads them with a row-group sweep of lane shuffles through 8 select
// accumulators.  Here one thread owns one position and reads its two
// words straight from the member row (two aligned 32-bit loads and a
// funnel shift per word, through L1/L2); a thread stops at its first
// mismatch, where the TPU tile runs while any lane is active.
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
// What bounds it: bytes.  It reads the member bytes, cand and m4 once
// and writes the lengths once (13 bytes a position with m4: 109 MB for
// 128 x 65536, 0.033 ms at 3.35 TB/s); the word reads of later rounds
// hit L1/L2.  chip_smoke.py reports the measured time beside that bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 1024;       // positions per swept row group
constexpr int kMaxMatch = 258;

// Little-endian bytes p..p+3 of a member row of n bytes (n % 4 == 0,
// row 4-byte aligned); bytes past n read 0.
__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int p,
                                            int n) {
  const int a = p & ~3;
  const uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(row + a));
  const uint32_t hi =
      a + 4 < n ? __ldg(reinterpret_cast<const uint32_t*>(row + a + 4))
                : 0u;
  return __funnelshift_r(lo, hi, (p & 3) * 8);
}

__global__ void __launch_bounds__(kThreads)
lcp_kernel(const uint8_t* __restrict__ blocks,
           const int32_t* __restrict__ cand, const int32_t* __restrict__ m4,
           const int32_t* __restrict__ n_valid, int32_t* __restrict__ out,
           int n, int max_rounds, int win_groups, int first_round) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int64_t off = static_cast<int64_t>(b) * n + e;
  const uint8_t* row = blocks + static_cast<int64_t>(b) * n;
  const int c = cand[off];
  const int groups = n / kGroup;
  const int pos_groups = min(2, groups);
  const int t = e / kGroup;
  const int lim = max(min(kMaxMatch, n_valid[b] - e), 0);
  const int cs = min(max(t - (win_groups - 2), 0), groups - win_groups);
  const int ps = min(t, groups - pos_groups);
  int ln;
  bool act;
  if (first_round == 0) {
    ln = 0;
    act = c >= 0 && lim > 0;
  } else {
    const int exact = 4 * first_round;
    const int m = m4[off];
    ln = min(c >= 0 ? m : 0, lim);
    act = c >= 0 && m >= exact && lim > exact && c >= cs * kGroup;
  }
  for (int r = first_round; act && r < max_rounds; ++r) {
    const int d = 4 * r;
    const int tc = min(max(c + d, 0), n - 1);
    const int tp = min(e + d, n - 1);
    const int gc = tc / kGroup, gp = tp / kGroup;
    const uint32_t wc =
        gc >= cs && gc < cs + win_groups ? word_at(row, tc, n) : 0u;
    const uint32_t wp =
        gp >= ps && gp < ps + pos_groups ? word_at(row, tp, n) : 0u;
    const uint32_t x = wc ^ wp;
    ln = min(ln + (x == 0 ? 4 : (__ffs(x) - 1) >> 3), lim);
    act = x == 0 && ln < lim;
  }
  out[off] = c >= 0 ? ln : 0;
}

}  // namespace

extern "C" int lf_match_lengths(const void* blocks, const void* cand,
                                const void* m4, const void* n_valid,
                                void* out, int n_members, int n,
                                int max_rounds, int win_groups,
                                int first_round, void* stream) {
  if (n_members <= 0) return 0;
  const int groups = n / kGroup;
  if (n <= 0 || n % kGroup || n_members > 65535 || win_groups < 1
      || win_groups > groups || first_round < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, n_members);
  lcp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(m4), static_cast<const int32_t*>(n_valid),
      static_cast<int32_t*>(out), n, max_rounds, win_groups, first_round);
  return static_cast<int>(cudaGetLastError());
}
