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
// the reference's position tie-break.  What bounds it: one read of the
// keys and one write of keys and int32 positions, 96 MiB for 128 x 65536
// (0.03 ms at 3.35 TB/s); a sort that passes through device memory moves
// that again in every pass, and a tile-by-tile sort pays a launch and a
// pass over the tile histograms per pass.  So a member stays on chip for
// the whole sort: one thread-block cluster per member (cudaLaunchKernelEx
// with a cluster dimension), ceil(N / 8192) CTAs of 1024 threads, each
// owning up to 8192 entries, its keys (int32) and positions (uint16, so
// N <= 65536) ping-ponged in 96 KB of dynamic shared memory.  An LSD
// radix sort of 4 passes of 8-bit digits, one launch per batch:
//   - rank: warp w owns a contiguous run of the CTA's entries and walks
//     it 32 at a time; __match_any_sync groups the lanes of equal digit,
//     so one lane per distinct digit updates the warp's private 256-bin
//     histogram (no same-address atomics on the few digits text has) and
//     each entry's rank in its warp is the histogram before the step plus
//     its equal lanes below it;
//   - offsets: one thread per digit scans the warps' counts (exclusive, in
//     warp order) and stores the CTA's count into every CTA of the cluster
//     (distributed shared memory); after cluster.sync each CTA adds the
//     member's digit starts (one block scan) to the counts of the lower
//     CTAs;
//   - scatter: each entry goes straight to its slot in the owning CTA's
//     shared memory through cluster.map_shared_rank; cluster.sync.
// Ranks are exclusive in (warp, step, lane) order inside a CTA and CTAs
// are in entry order, so each pass is stable.  After the last pass each
// CTA writes its 8192 sorted entries to device memory, 16 bytes a thread.
//
// lf_scan_emit: one block of 512 threads per (member, tile of 4096 sorted
// slots) scores each slot's 8 predecessors in sorted order exactly as
// `_scan_emit` does (exact shared prefix up to 16 bytes from the key and
// the words at p+4, p+8, p+12, score (lcp << 17) + (window - dist), strict
// improvement, the no-candidate sentinel) and writes its result to text
// position pos.  The positions are a permutation, so that scatter is the
// unsort of `sort_pairs`: no second sort.  What bounds it: the bytes of
// the predecessors are read at random text positions, up to 108 per
// slot; from device memory each is a separate sector.  So the block
// stages the member's bytes (n + 16 zero bytes, 16-byte loads) and its
// tile's keys and positions with the 8-slot halo before it in shared
// memory (~96 KB: two blocks per SM), and builds each big-endian word
// from two aligned shared loads and __byte_perm.  Then the scattered
// 4-byte stores, which on the H100 cost more than the byte reads: a slot
// stores one word, (cand + 1) | m << 17, into m's memory, and
// split_kernel, coalesced (32 MiB in, 64 MiB out), unpacks it into cand
// and m in the same call.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortTile = 8192;                  // entries per CTA
constexpr int kSortSteps = kSortTile / kSortThreads;
constexpr int kMaxCtas = 8;                      // portable cluster size
constexpr int kRadix = 256;
constexpr int kScanThreads = 512;
constexpr int kScanTile = 4096;                  // sorted slots per block
constexpr int kScanK = 8;

__device__ __forceinline__ int digit_of(int32_t k, int shift) {
  return ((static_cast<uint32_t>(k) ^ 0x80000000u) >> shift) & (kRadix - 1);
}

// exclusive scan of one int per thread across the block (<= 32 warps)
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) wsum[lane] = w;
  }
  __syncthreads();
  return x - v + (warp > 0 ? wsum[warp - 1] : 0);
}

// one cluster of `ctas` CTAs per member; CTA r owns entries
// [r * 8192, min(n, (r + 1) * 8192)), a multiple of 1024 of them
__global__ void __launch_bounds__(kSortThreads, 1)
cluster_sort_kernel(const int32_t* __restrict__ key_in,
                    int32_t* __restrict__ key_out,
                    int32_t* __restrict__ pos_out, int n, int ctas) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int whist[kSortWarps * kRadix];
  __shared__ int counts[kMaxCtas * kRadix];
  __shared__ int dbase[kRadix];
  __shared__ int wsum[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = min(n, kSortTile);
  // buffer h of keys at s_key + h * tile, of positions at s_pos + h * tile
  int32_t* s_key = reinterpret_cast<int32_t*>(smem);
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(smem + 8 * tile);
  const int b = blockIdx.x / ctas;
  const int start = rank * kSortTile;
  const int count = min(kSortTile, n - start);
  const int steps = count / kSortThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wbase = warp * steps * 32;         // the warp's run of entries
  const unsigned below = (1u << lane) - 1;
  const int32_t* src = key_in + static_cast<int64_t>(b) * n + start;
  int* wh = whist + warp * kRadix;
  int32_t rk[kSortSteps];
  int rp[kSortSteps], rr[kSortSteps];
  cluster.sync();                 // every CTA runs: its shared memory is live
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    const int32_t* sk = s_key + ((pass + 1) & 1) * tile;
    const uint16_t* sp = s_pos + ((pass + 1) & 1) * tile;
    for (int i = lane; i < kRadix; i += 32) wh[i] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSortSteps; ++j) {
      if (j < steps) {                          // uniform over the CTA
        const int i = wbase + j * 32 + lane;
        rk[j] = pass == 0 ? src[i] : sk[i];
        rp[j] = pass == 0 ? start + i : sp[i];
        const int d = digit_of(rk[j], shift);
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int before = wh[d];
        rr[j] = before + __popc(peers & below);
        __syncwarp();
        if ((peers & below) == 0) wh[d] = before + __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    if (tid < kRadix) {
      int s = 0;
      for (int w = 0; w < kSortWarps; ++w) {
        const int v = whist[w * kRadix + tid];
        whist[w * kRadix + tid] = s;
        s += v;
      }
      for (int c = 0; c < ctas; ++c)
        cluster.map_shared_rank(counts, c)[rank * kRadix + tid] = s;
    }
    cluster.sync();
    int total = 0, lower = 0;
    if (tid < kRadix) {
      for (int c = 0; c < ctas; ++c) {
        const int v = counts[c * kRadix + tid];
        total += v;
        if (c < rank) lower += v;
      }
    }
    const int first = block_exclusive_scan(total, wsum);
    if (tid < kRadix) dbase[tid] = first + lower;
    __syncthreads();
    int32_t* dk = s_key + (pass & 1) * tile;
    uint16_t* dp = s_pos + (pass & 1) * tile;
#pragma unroll
    for (int j = 0; j < kSortSteps; ++j) {
      if (j < steps) {
        const int d = digit_of(rk[j], shift);
        const int g = dbase[d] + wh[d] + rr[j];   // slot in the member
        const int owner = g / kSortTile, at = g % kSortTile;
        cluster.map_shared_rank(dk, owner)[at] = rk[j];
        cluster.map_shared_rank(dp, owner)[at] = static_cast<uint16_t>(rp[j]);
      }
    }
    cluster.sync();
  }
  const int64_t o = static_cast<int64_t>(b) * n + start;
  const int4* k4 = reinterpret_cast<const int4*>(s_key + tile);
  const uint2* p4 = reinterpret_cast<const uint2*>(s_pos + tile);
  int4* ko = reinterpret_cast<int4*>(key_out + o);
  int4* po = reinterpret_cast<int4*>(pos_out + o);
  for (int i = tid; i < count / 4; i += kSortThreads) {
    ko[i] = k4[i];
    const uint2 p = p4[i];
    po[i] = make_int4(p.x & 0xFFFF, p.x >> 16, p.y & 0xFFFF, p.y >> 16);
  }
}

// big-endian 32-bit word of the staged bytes at p (two aligned loads)
__device__ __forceinline__ uint32_t word_be(const uint32_t* text, int p) {
  return __byte_perm(text[p >> 2], text[(p >> 2) + 1],
                     0x0123 + (p & 3) * 0x1111);
}

// big-endian word of the member's bytes at p, zero past n
__device__ __forceinline__ uint32_t word_at(const uint32_t* text, int n,
                                            int p) {
  return p < n ? word_be(text, p) : 0u;
}

// equal leading bytes of two big-endian words, given their xor
__device__ __forceinline__ int lead_bytes(uint32_t x) {
  return x == 0 ? 4 : __clz(x) >> 3;
}

// block = (member, tile of `tile` sorted slots); shared memory: the
// member's bytes (text_bytes, zero past n), then keys and positions of
// the slots [t0 - 8, t0 + tile), slot j at j
__global__ void __launch_bounds__(kScanThreads, 2)
scan_emit_kernel(const int32_t* __restrict__ skey,
                 const int32_t* __restrict__ spos,
                 const uint8_t* __restrict__ blocks,
                 int32_t* __restrict__ packed, int n_pad, int n, int window,
                 int m_exact, int tile, int tiles, int text_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t* text = reinterpret_cast<const uint32_t*>(smem);
  int32_t* s_key = reinterpret_cast<int32_t*>(smem + text_bytes);
  int32_t* s_pos = s_key + tile + kScanK;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * tile;
  const int tid = threadIdx.x;
  const uint8_t* row = blocks + static_cast<int64_t>(b) * n;
  if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (int i = tid; i < n / 16; i += kScanThreads)
      reinterpret_cast<uint4*>(smem)[i] =
          reinterpret_cast<const uint4*>(row)[i];
  } else {
    for (int i = tid; i < n; i += kScanThreads) smem[i] = row[i];
  }
  for (int i = n + tid; i < text_bytes; i += kScanThreads) smem[i] = 0;
  const int32_t* sk = skey + static_cast<int64_t>(b) * n_pad;
  const int32_t* sp = spos + static_cast<int64_t>(b) * n_pad;
  for (int j = tid; j < tile + kScanK; j += kScanThreads) {
    const int s = t0 - kScanK + j;
    if (s >= 0 && s < n_pad) {
      s_key[j] = sk[s];
      s_pos[j] = sp[s];
    }
  }
  __syncthreads();
  for (int j = kScanK + tid; j < kScanK + tile; j += kScanThreads) {
    const int s = t0 + j - kScanK;
    if (s >= n_pad) break;
    const int pos = s_pos[j];
    if (pos >= n) continue;                 // padding slot
    const uint32_t key = static_cast<uint32_t>(s_key[j]);
    uint32_t cw[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) cw[i] = word_at(text, n, pos + 4 * (i + 1));
    int best_score = -1, best_cand = -1, best_l = 0;
#pragma unroll
    for (int k = 1; k <= kScanK; ++k) {
      if (s - k < 0) break;
      const int pp = s_pos[j - k];
      uint32_t x = key ^ static_cast<uint32_t>(s_key[j - k]);
      int lcp = lead_bytes(x);
      for (int i = 0; i < 3 && x == 0; ++i) {
        x = cw[i] ^ word_at(text, n, pp + 4 * (i + 1));
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
    // one scattered store: cand + 1 in bits 0-16, m in bits 17 and up
    packed[static_cast<int64_t>(b) * n + pos] =
        none ? 0 : (pos - dist_b) | (min(best_l, m_exact) << 17);
  }
}

// (cand + 1) | m << 17 in m_out -> cand, m, in place and coalesced
__global__ void __launch_bounds__(256)
split_kernel(int32_t* __restrict__ cand, int32_t* __restrict__ m_out,
             int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const int32_t v = m_out[i];
  cand[i] = (v & 0x1FFFF) - 1;
  m_out[i] = v >> 17;
}

cudaError_t allow_shared(int sort_smem, int scan_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sort_smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(scan_emit_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              scan_smem);
}

cudaLaunchConfig_t sort_config(int n_members, int ctas, int smem,
                               cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_members * ctas);
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// ctas = ceil(n / 8192) and smem = 12 * min(n, 8192) come from the
// wrapper (ops/sort_match.sort_geometry); they are checked here
extern "C" int lf_sort_keys(const void* key_in, void* key_out,
                            void* pos_out, int n_members, int n, int ctas,
                            int smem, void* stream) {
  if (n_members <= 0) return 0;
  if (n < 1024 || n % 1024 || n > kMaxCtas * kSortTile
      || ctas != (n + kSortTile - 1) / kSortTile
      || smem != 12 * (n < kSortTile ? n : kSortTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sort_config(
      n_members, ctas, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_sort_kernel,
                           static_cast<const int32_t*>(key_in),
                           static_cast<int32_t*>(key_out),
                           static_cast<int32_t*>(pos_out), n, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// tile and smem come from the wrapper (ops/sort_match.scan_geometry):
// text_bytes = 16 * ceil((n + 16) / 16) bytes of the member, then
// 8 * (tile + 8) bytes of keys and positions
extern "C" int lf_scan_emit(const void* skey, const void* spos,
                            const void* blocks, void* cand, void* m,
                            int n_members, int n_pad, int n, int window,
                            int m_exact, int tile, int smem, void* stream) {
  if (n_members <= 0 || n_pad <= 0) return 0;
  const int text_bytes = (n + 31) / 16 * 16;
  if (tile <= 0 || tile > kScanTile || n > 65536 || m_exact < 0
      || smem != text_bytes + 8 * (tile + kScanK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      scan_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_pad + tile - 1) / tile;
  auto s = static_cast<cudaStream_t>(stream);
  scan_emit_kernel<<<n_members * tiles, kScanThreads, smem, s>>>(
      static_cast<const int32_t*>(skey), static_cast<const int32_t*>(spos),
      static_cast<const uint8_t*>(blocks), static_cast<int32_t*>(m), n_pad,
      n, window, m_exact, tile, tiles, text_bytes);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const int64_t total = static_cast<int64_t>(n_members) * n;
  split_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<int32_t*>(cand), static_cast<int32_t*>(m), total);
  return static_cast<int>(cudaGetLastError());
}

// registers, static shared bytes and local (spill) bytes of both kernels,
// the dynamic shared bytes given, the sort's resident clusters and the
// scan's resident blocks per SM, into out[0..9]
extern "C" int lf_match_info(int ctas, int sort_smem, int scan_smem,
                             void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t err = allow_shared(sort_smem, scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, cluster_sort_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = sort_smem;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sort_config(128, ctas, sort_smem, 0, &attr);
  err = cudaOccupancyMaxActiveClusters(&o[4], cluster_sort_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&fa, scan_emit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[5] = fa.numRegs;
  o[6] = static_cast<int>(fa.sharedSizeBytes);
  o[7] = static_cast<int>(fa.localSizeBytes);
  o[8] = scan_smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[9], scan_emit_kernel, kScanThreads, scan_smem));
}
