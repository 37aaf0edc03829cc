// LZ77 candidate search by content sort for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of libflate_tpu/ops/pallas_sort.py that the
// sort matcher (libflate_tpu/ops/sort_match.py `sort_candidates`) runs:
// `_sort_kernel` + `_scan_emit` via `sort_scan_candidates` (the bitonic
// sort of (prefix key, position, three carried words) and the back-scan
// over the 8 sorted predecessors), and `_sort_kernel` via `sort_pairs`
// (the unsort of (key2, m) back to text order).
//
// lf_sort_keys: a stable sort of each member's int32 keys in signed
// order, returning the sorted keys and their positions.  Stability gives
// the reference's position tie-break.  An LSD radix sort, 8 passes of 4
// bits, between two global buffers; each member is cut into tiles of
// 2048 keys (1024 for 1024-key members), one block of 256 threads per
// tile, so a 128 x 65536 batch runs 4096 blocks per pass.  A pass is two
// launches: tile_hist counts each tile's digits; tile_scatter loads its
// tile coalesced into shared memory, ranks it stably (each thread counts
// a contiguous run, a digit-major scan orders equal digits by thread),
// reorders it in shared memory and writes each digit's run to its place
// in the member: the digit's member-wide start plus the counts of the
// earlier tiles, read from the tile histograms.  The carried words of the
// reference's sort do not ride along: the back-scan recomputes them from
// the member's bytes.
//
// lf_scan_emit: one thread per sorted slot scores its 8 predecessors in
// sorted order exactly as `_scan_emit` does (exact shared prefix up to 16
// bytes from the key and the words at p+4, p+8, p+12, score
// (lcp << 17) + (window - dist), strict improvement, the no-candidate
// sentinel) and writes cand and m straight to text position pos.  The
// positions are a permutation, so that scatter is the unsort of
// `sort_pairs`: no second sort.
//
// What bounds it: 128 x 65536 keys are 32 MiB; the sort reads keys twice
// and positions once and writes both in each of 8 passes (~1.3 GB, ~0.4
// ms at 3.35 TB/s), every access coalesced; the scan reads keys,
// positions and bytes and writes cand and m (~0.14 GB).  The bound that
// chip_smoke.py reports counts one read of the inputs and one write of
// the outputs, as if the sort took one pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortTile = 2048;
constexpr int kPadTile = kSortTile + kSortTile / 32;
constexpr int kBins = 16;
constexpr int kPasses = 8;
constexpr int kScanThreads = 256;
constexpr int kScanK = 8;

// shared-memory index with one skip per 32 words: a thread's contiguous
// run then falls on distinct banks across the warp
__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

__device__ __forceinline__ int digit_of(int32_t k, int shift) {
  return ((static_cast<uint32_t>(k) ^ 0x80000000u) >> shift) & (kBins - 1);
}

__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortThreads / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kSortThreads / 32) wsum[lane] = w;
  }
  __syncthreads();
  return x - v + (warp > 0 ? wsum[warp - 1] : 0);
}

// blocks enumerate (member, tile) in order, so block i covers keys
// [i * tile, (i + 1) * tile) of the (B, n) array
__global__ void __launch_bounds__(kSortThreads)
tile_hist_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ hist,
                 int tile, int shift) {
  __shared__ int h[kBins];
  if (threadIdx.x < kBins) h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += kSortThreads)
    atomicAdd(&h[digit_of(keys[base + i], shift)], 1);
  __syncthreads();
  if (threadIdx.x < kBins)
    hist[static_cast<int64_t>(blockIdx.x) * kBins + threadIdx.x] =
        h[threadIdx.x];
}

template <int kPer>
__global__ void __launch_bounds__(kSortThreads)
tile_scatter_kernel(const int32_t* __restrict__ sk,
                    const int32_t* __restrict__ sp, int32_t* __restrict__ dk,
                    int32_t* __restrict__ dp,
                    const int32_t* __restrict__ hist, int n, int shift,
                    int first) {
  constexpr int tile = kPer * kSortThreads;
  __shared__ int32_t s_key[kPadTile];
  __shared__ int32_t s_pos[kPadTile];
  __shared__ int cnt[kBins * kSortThreads];
  __shared__ int wsum[kSortThreads / 32];
  __shared__ int dbase[kBins];
  const int tiles = n / tile;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = tid; i < tile; i += kSortThreads) {
    s_key[pad_idx(i)] = sk[base + i];
    s_pos[pad_idx(i)] = first ? t * tile + i : sp[base + i];
  }
#pragma unroll
  for (int d = 0; d < kBins; ++d) cnt[d * kSortThreads + tid] = 0;
  __syncthreads();
  int32_t rk[kPer], rp[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    rk[j] = s_key[pad_idx(tid * kPer + j)];
    rp[j] = s_pos[pad_idx(tid * kPer + j)];
    ++cnt[digit_of(rk[j], shift) * kSortThreads + tid];
  }
  __syncthreads();
  // digit-major exclusive scan; thread tid owns flat entries [16 tid, +16)
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kBins; ++j) sum += cnt[tid * kBins + j];
  int run = block_exclusive_scan(sum, wsum);
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    const int v = cnt[tid * kBins + j];
    cnt[tid * kBins + j] = run;
    run += v;
  }
  __syncthreads();
  if (tid < kBins) {
    // member-wide start of digit tid, plus the earlier tiles' counts,
    // minus its start inside this tile
    const int32_t* h = hist + static_cast<int64_t>(b) * tiles * kBins;
    int g = 0;
    for (int u = 0; u < tiles; ++u) {
      for (int e = 0; e < tid; ++e) g += h[u * kBins + e];
      if (u < t) g += h[u * kBins + tid];
    }
    dbase[tid] = g - cnt[tid * kSortThreads];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = cnt[digit_of(rk[j], shift) * kSortThreads + tid]++;
    s_key[pad_idx(r)] = rk[j];
    s_pos[pad_idx(r)] = rp[j];
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(b) * n;
  for (int i = tid; i < tile; i += kSortThreads) {
    const int32_t k = s_key[pad_idx(i)];
    const int64_t dst = row + dbase[digit_of(k, shift)] + i;
    dk[dst] = k;
    dp[dst] = s_pos[pad_idx(i)];
  }
}

// big-endian 32-bit word of the member's bytes at p, zero past n
__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int n,
                                            int p) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) v = (v << 8) | (p + j < n ? row[p + j] : 0u);
  return v;
}

// equal leading bytes of two big-endian words, given their xor
__device__ __forceinline__ int lead_bytes(uint32_t x) {
  return x == 0 ? 4 : __clz(x) >> 3;
}

__global__ void __launch_bounds__(kScanThreads)
scan_emit_kernel(const int32_t* __restrict__ skey,
                 const int32_t* __restrict__ spos,
                 const uint8_t* __restrict__ blocks,
                 int32_t* __restrict__ cand, int32_t* __restrict__ m_out,
                 int n_pad, int n, int window, int m_exact,
                 int blocks_per_member) {
  const int b = blockIdx.x / blocks_per_member;
  const int s = (blockIdx.x % blocks_per_member) * kScanThreads
                + threadIdx.x;
  if (s >= n_pad) return;
  const int32_t* sk = skey + static_cast<int64_t>(b) * n_pad;
  const int32_t* sp = spos + static_cast<int64_t>(b) * n_pad;
  const uint8_t* row = blocks + static_cast<int64_t>(b) * n;
  const int pos = sp[s];
  if (pos >= n) return;                     // padding slot
  const uint32_t key = static_cast<uint32_t>(sk[s]);
  uint32_t cw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) cw[i] = word_at(row, n, pos + 4 * (i + 1));
  int best_score = -1, best_cand = -1, best_l = 0;
#pragma unroll
  for (int k = 1; k <= kScanK; ++k) {
    if (s - k < 0) break;
    const int pp = sp[s - k];
    uint32_t x = key ^ static_cast<uint32_t>(sk[s - k]);
    int lcp = lead_bytes(x);
    for (int i = 0; i < 3 && x == 0; ++i) {
      x = cw[i] ^ word_at(row, n, pp + 4 * (i + 1));
      lcp = 4 * (i + 1) + lead_bytes(x);
    }
    const int dist = pos - pp;
    if (dist > 0 && dist <= window && lcp >= 3) {
      const int score = (lcp << 17) + (window - dist);
      if (score > best_score) {
        best_score = score;
        best_cand = pp;
        best_l = lcp;
      }
    }
  }
  const bool valid = best_cand >= 0;
  const bool ext = valid && best_l >= 4;
  const int dist_b = valid ? pos - best_cand - 1 : 0x7FFF;
  const bool none = !ext && dist_b == 0x7FFF;
  const int64_t o = static_cast<int64_t>(b) * n + pos;
  cand[o] = none ? -1 : pos - dist_b - 1;
  m_out[o] = none ? 0 : min(best_l, m_exact);
}

}  // namespace

extern "C" int lf_sort_keys(const void* key_in, void* key_a, void* pos_a,
                            void* key_b, void* pos_b, void* hist,
                            int n_members, int n, void* stream) {
  if (n_members <= 0) return 0;
  if (n % 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int tile = n % kSortTile == 0 ? kSortTile : 1024;
  const int blocks = n_members * (n / tile);
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 4 * pass;
    const int32_t* sk = static_cast<const int32_t*>(
        pass == 0 ? key_in : (pass & 1 ? key_a : key_b));
    const int32_t* sp = static_cast<const int32_t*>(pass & 1 ? pos_a
                                                             : pos_b);
    int32_t* dk = static_cast<int32_t*>(pass & 1 ? key_b : key_a);
    int32_t* dp = static_cast<int32_t*>(pass & 1 ? pos_b : pos_a);
    auto* h = static_cast<int32_t*>(hist);
    tile_hist_kernel<<<blocks, kSortThreads, 0, s>>>(sk, h, tile, shift);
    if (tile == kSortTile)
      tile_scatter_kernel<kSortTile / kSortThreads>
          <<<blocks, kSortThreads, 0, s>>>(sk, sp, dk, dp, h, n, shift,
                                           pass == 0);
    else
      tile_scatter_kernel<1024 / kSortThreads>
          <<<blocks, kSortThreads, 0, s>>>(sk, sp, dk, dp, h, n, shift,
                                           pass == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" int lf_scan_emit(const void* skey, const void* spos,
                            const void* blocks, void* cand, void* m,
                            int n_members, int n_pad, int n, int window,
                            int m_exact, void* stream) {
  if (n_members <= 0 || n_pad <= 0) return 0;
  const int per = (n_pad + kScanThreads - 1) / kScanThreads;
  scan_emit_kernel<<<n_members * per, kScanThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(skey), static_cast<const int32_t*>(spos),
      static_cast<const uint8_t*>(blocks), static_cast<int32_t*>(cand),
      static_cast<int32_t*>(m), n_pad, n, window, m_exact, per);
  return static_cast<int>(cudaGetLastError());
}
