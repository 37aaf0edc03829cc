// Output-position rank + LZ77 mod-collapse for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_rank.py `_rank_kernel`
// with emit="src" (`_rank_one`, wrapper `rank_emit_src`).  For every output
// position p of a member it finds the covering token, the last one whose
// start is <= p, and emits
//   src[p] = p                        for a literal (a fixpoint), and
//   src[p] = (p - s) % d + s - d      for a match of distance d starting
//                                     at s (the pre-token source, so a
//                                     pointer chase crosses a token at
//                                     every step), and
//   lit[p] = the literal byte, or 0.
// Positions at or past n_out[b] get src = p and lit = 0; live sources are
// clipped to [0, out_cap - 1].
//
// What bounds it: it writes 8 bytes per output position (src + lit), 512
// MB for a 64 MiB shard, and reads the token tables through a binary
// search.  One thread per position; the threads of a block cover 256
// consecutive positions, so they walk nearly the same search path and the
// ~log2(T) probes are L1 broadcasts; the two stores are coalesced.  The
// TPU kernel's coarse per-bucket counts (an MXU one-hot einsum) and its
// 2048-token windows exist to avoid gathers on the TPU and are not needed
// here.  `rel % d` is exact integer arithmetic.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rank_emit_src_kernel(const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ pk,
                                     const int32_t* __restrict__ n_out,
                                     int32_t* __restrict__ src,
                                     int32_t* __restrict__ lit, int n_tok,
                                     int out_cap, int blocks_per_member) {
  const int b = blockIdx.x / blocks_per_member;
  const int p = (blockIdx.x % blocks_per_member) * kThreads + threadIdx.x;
  if (p >= out_cap) return;
  const int64_t o = static_cast<int64_t>(b) * out_cap + p;
  if (p >= n_out[b]) {
    src[o] = p;
    lit[o] = 0;
    return;
  }
  const int32_t* st = starts + static_cast<int64_t>(b) * n_tok;
  int lo = 0, hi = n_tok;               // first token whose start is > p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (st[mid] <= p) lo = mid + 1; else hi = mid;
  }
  const int id = max(lo - 1, 0);
  const int s = st[id];
  const int tok = pk[static_cast<int64_t>(b) * n_tok + id];
  const int d = (tok >> 9) & 0xFFFF;
  int sv, lv;
  if (d == 0) {
    sv = p;
    lv = tok & 255;
  } else {
    const int rel = p - s;              // >= 0: the token covers p
    sv = rel % d + s - d;
    lv = 0;
  }
  src[o] = min(max(sv, 0), out_cap - 1);
  lit[o] = lv;
}

}  // namespace

extern "C" int lf_rank_emit_src(const void* starts, const void* pk,
                                const void* n_out, void* src, void* lit,
                                int n_members, int n_tok, int out_cap,
                                void* stream) {
  if (n_members <= 0 || out_cap <= 0) return 0;
  const int per = (out_cap + kThreads - 1) / kThreads;
  rank_emit_src_kernel<<<n_members * per, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(pk),
      static_cast<const int32_t*>(n_out), static_cast<int32_t*>(src),
      static_cast<int32_t*>(lit), n_tok, out_cap, per);
  return static_cast<int>(cudaGetLastError());
}
