// Sync-indexed DEFLATE symbol decode for Hopper (sm_90a).
//
// Replaces the TPU kernel libflate_tpu/ops/pallas_sync_decode.py
// `_sync_kernel` (wrapper `sync_decode`).  The PGZF encoder records the bit
// offset of every K-th token in the member header ("LS" subfield), so every
// K-token chunk decodes on its own: one thread per chunk slot runs the
// K-step symbol loop.
//
// What bounds it: a dependent chain per token (window load -> root table
// lookup -> extra bits -> distance lookup -> extra bits), K = 256 links
// long, so the kernel is latency bound, not bandwidth bound (a 64 MiB
// shard reads ~22 MB of stream and writes ~68 MB of tokens).  The design
// answers that with occupancy: the shared litlen root (4 KiB at 10 bits,
// 16 KiB at 12), the 256-entry distance root and the length/distance
// base/extra rows sit in shared memory, so the only global reads on the
// chain are the three stream words of the window, which L1 keeps hot (a
// chunk's bits are contiguous), and tens of thousands of slots are in
// flight to hide the latency.
//
// Input is the whole stream uploaded once as little-endian 32-bit words
// plus each slot's absolute start bit; the TPU kernel's per-slot staged
// columns (a host byte gather) are not needed.  Words past the end read 0.
// Output is slot-major (n_slots, K) int32; token i of a slot is
// clip(a, 0, 511) | clip(b, 0, 65535) << 9 (a: literal byte or match
// length, b: distance, 0 for a literal), and entries past the slot's count
// are 0.  Invalid table entries (width 0) decode exactly as the reference
// does: symbol 0 of width 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLenCodes = 29;
constexpr int kDistCodes = 30;
constexpr int kRows = 2 * kLenCodes + 2 * kDistCodes;   // 118
constexpr int kDistRoot = 256;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ w,
                                            int64_t i, int64_t n) {
  return i < n ? w[i] : 0u;
}

__global__ void sync_decode_kernel(const uint32_t* __restrict__ words,
                                   int64_t n_words,
                                   const int64_t* __restrict__ start_bits,
                                   const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ lit_t,
                                   const int32_t* __restrict__ dist_t,
                                   const int32_t* __restrict__ rows,
                                   int root_bits, int32_t* __restrict__ out,
                                   int n_slots, int k_tokens) {
  extern __shared__ int32_t smem[];
  const int lit_n = 1 << root_bits;
  int32_t* s_lit = smem;
  int32_t* s_dist = s_lit + lit_n;
  int32_t* s_rows = s_dist + kDistRoot;
  for (int i = threadIdx.x; i < lit_n; i += blockDim.x) s_lit[i] = lit_t[i];
  for (int i = threadIdx.x; i < kDistRoot; i += blockDim.x)
    s_dist[i] = dist_t[i];
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) s_rows[i] = rows[i];
  __syncthreads();
  const int32_t* len_base = s_rows;
  const int32_t* len_extra = s_rows + kLenCodes;
  const int32_t* dist_base = s_rows + 2 * kLenCodes;
  const int32_t* dist_extra = s_rows + 2 * kLenCodes + kDistCodes;

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  int32_t* o = out + static_cast<int64_t>(slot) * k_tokens;
  const int cnt = min(counts[slot], k_tokens);
  const uint64_t root_mask = (1ull << root_bits) - 1;
  int64_t cursor = start_bits[slot];

  for (int i = 0; i < cnt; ++i) {
    // 64-bit window of the stream at the cursor
    const int64_t wi = cursor >> 5;
    const int r = static_cast<int>(cursor & 31);
    const uint64_t x = (static_cast<uint64_t>(word_at(words, wi + 1, n_words))
                        << 32) | word_at(words, wi, n_words);
    uint64_t win = x >> r;
    if (r) win |= static_cast<uint64_t>(word_at(words, wi + 2, n_words))
                  << (64 - r);

    const int e = s_lit[win & root_mask];
    const int width = e & 15;
    const int sym = e >> 4;
    const bool is_len = sym > 256;
    const int li = min(max(sym - 257, 0), kLenCodes - 1);
    const int lnx = len_extra[li];
    const int length = len_base[li] +
        static_cast<int>((win >> width) & ((1u << lnx) - 1));
    const int k2 = width + (is_len ? lnx : 0);
    const int de = s_dist[(win >> k2) & (kDistRoot - 1)];
    const int dsym = min(max(de >> 4, 0), kDistCodes - 1);
    const int dnx = dist_extra[dsym];
    const int k3 = k2 + (de & 15);
    const int dist = dist_base[dsym] +
        static_cast<int>((win >> k3) & ((1u << dnx) - 1));

    const int a = is_len ? length : sym;
    const int b = is_len ? dist : 0;
    o[i] = min(max(a, 0), 511) | (min(max(b, 0), 65535) << 9);
    cursor += is_len ? k3 + dnx : width;
  }
  for (int i = max(cnt, 0); i < k_tokens; ++i) o[i] = 0;
}

}  // namespace

extern "C" int lf_sync_decode(const void* words, int64_t n_words,
                              const void* start_bits, const void* counts,
                              const void* lit_t, const void* dist_t,
                              const void* rows, int root_bits, void* out,
                              int n_slots, int k_tokens, void* stream) {
  if (n_slots <= 0) return 0;
  // at most 17.9 KB (12-bit root): under the 48 KB that needs no opt-in
  const size_t smem =
      sizeof(int32_t) * ((size_t{1} << root_bits) + kDistRoot + kRows);
  const int blocks = (n_slots + kThreads - 1) / kThreads;
  sync_decode_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int64_t*>(start_bits),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(lit_t), static_cast<const int32_t*>(dist_t),
      static_cast<const int32_t*>(rows), root_bits,
      static_cast<int32_t*>(out), n_slots, k_tokens);
  return static_cast<int>(cudaGetLastError());
}
