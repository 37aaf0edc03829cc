// Per-member gathers for Hopper (sm_90a): one with the chain step fused
// in, and the two-table windowed gather.
//
// lf_gather_rows replaces libflate_tpu/ops/pallas_gather.py
// `_gather_kernel` (via `gather_rows`): out[b, i] = table[b, clip(idx[b,
// i], 0, R - 1)].  The TPU kernel scans the member's table rows in VMEM
// with a broadcast, a lane shuffle and a select per row, because Mosaic
// has no per-element gather, and skips 64-row blocks outside each vreg's
// index range.  Here one thread loads its entry from the table through
// L1/L2; no skip is needed.
//
// With window >= 0 the launch also applies the chain step of
// `_compose_cand` (libflate_tpu/ops/pipeline.py:86-87): the entry is kept
// only where idx >= 0, entry >= 0 and i - entry <= window, else -1.
//
// What bounds it: bytes.  It reads idx and the table once and writes out
// once (12 bytes an entry: 101 MB for 128 x 65536, 0.030 ms at 3.35 TB/s);
// the table reads are window-local, so they hit L2.
//
// lf_gather_two replaces `_gather2_kernel` (via `gather_two`): two tables
// of the reference's (B, R, 128) layout gathered in one pass at flat
// indices idx (B, N, 128), where every 8-row group v of idx (1024 entries)
// has a window of `win` table rows starting at lo_rows[b, v]: out_x[b, i]
// = tab_x[b, idx[b, i]] when the index's row (idx >> 7, arithmetic) lies
// in [lo, lo + win) for the unclamped lo, else 0; the window's rows are
// read from lo clamped to [0, R - win], as the reference's dynamic slice
// reads them.  The TPU kernel sweeps the window's rows with a lane shuffle
// and a select each.
//
// What bounds it: bytes.  idx read and both outputs written once (12
// bytes an entry), the tables read once: 168 MB, 0.050 ms at 3.35 TB/s for
// B = 128, R = N = 512.  Its design: a 256-thread block per group; the
// block stages both tables' window rows (a contiguous slab of win x 128
// int32 each, 2 x 8 KB at win = 16) into shared memory with 16-byte
// cp.async, loads its 1024 indices as int4 (four a thread) while the
// copies fly, then reads both entries from shared memory and stores both
// outputs as int4.  A window of more than kMaxStagedWin rows takes the
// same launch without the staging: each entry loads straight from the
// tables through L2.  Staged, a group reads its whole window, so groups
// whose windows overlap read the same rows again, mostly from L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ idx, int32_t* __restrict__ out,
              int rows, int n_out, int window) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int64_t off = static_cast<int64_t>(b) * n_out + i;
  const int j = idx[off];
  const int v =
      __ldg(table + static_cast<int64_t>(b) * rows + min(max(j, 0), rows - 1));
  out[off] = window < 0 || (j >= 0 && v >= 0 && i - v <= window) ? v : -1;
}

constexpr int kGroup = 1024;                    // entries of an 8-row group
constexpr int kMaxStagedWin = 64;               // rows: 64 KB of staging

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// entry j of the group's window (rows from r0; the window's first row
// lo unclamped), or 0 if j's row lies outside [lo, lo + win)
template <bool kStaged>
__device__ __forceinline__ void pick(int j, int lo, int win,
                                     const int32_t* ta, const int32_t* tb,
                                     int64_t r0_off, int& va, int& vb) {
  const int64_t u = static_cast<int64_t>(j >> 7) - lo;
  va = vb = 0;
  if (u >= 0 && u < win) {
    const int64_t k = u * 128 + (j & 127);
    if (kStaged) {
      va = ta[k];
      vb = tb[k];
    } else {
      va = __ldg(ta + r0_off + k);
      vb = __ldg(tb + r0_off + k);
    }
  }
}

// grid (groups, members); staged: dynamic shared 2 x win x 512 bytes
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_two_kernel(const int32_t* __restrict__ tab_a,
                  const int32_t* __restrict__ tab_b,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ lo_rows,
                  int32_t* __restrict__ out_a, int32_t* __restrict__ out_b,
                  int rows, int win) {
  extern __shared__ int4 stage[];
  const int64_t grp = static_cast<int64_t>(blockIdx.y) * gridDim.x
                      + blockIdx.x;
  const int lo = __ldg(lo_rows + grp);
  const int64_t r0_off = (static_cast<int64_t>(blockIdx.y) * rows
                          + min(max(lo, 0), rows - win)) * 128;
  const int n16 = win * 32;                     // int4 a table's window
  if (kStaged) {
    const int4* ga = reinterpret_cast<const int4*>(tab_a + r0_off);
    const int4* gb = reinterpret_cast<const int4*>(tab_b + r0_off);
    for (int k = threadIdx.x; k < n16; k += kThreads) {
      cp_async16(stage + k, ga + k);
      cp_async16(stage + n16 + k, gb + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int64_t off = grp * kGroup + 4 * threadIdx.x;
  const int4 j = __ldg(reinterpret_cast<const int4*>(idx + off));
  const int32_t* ta = tab_a;
  const int32_t* tb = tab_b;
  if (kStaged) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    ta = reinterpret_cast<const int32_t*>(stage);
    tb = ta + win * 128;
  }
  int4 oa, ob;
  pick<kStaged>(j.x, lo, win, ta, tb, r0_off, oa.x, ob.x);
  pick<kStaged>(j.y, lo, win, ta, tb, r0_off, oa.y, ob.y);
  pick<kStaged>(j.z, lo, win, ta, tb, r0_off, oa.z, ob.z);
  pick<kStaged>(j.w, lo, win, ta, tb, r0_off, oa.w, ob.w);
  *reinterpret_cast<int4*>(out_a + off) = oa;
  *reinterpret_cast<int4*>(out_b + off) = ob;
}

// The staged kernel's dynamic shared-memory limit is per device: raised
// once on each.
cudaError_t set_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(gather_two_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStagedWin * 1024);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" int lf_gather_rows(const void* table, const void* idx, void* out,
                              int n_members, int rows, int n_out, int window,
                              void* stream) {
  if (n_members <= 0 || n_out <= 0) return 0;
  if (rows <= 0 || n_members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + kThreads - 1) / kThreads, n_members);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rows, n_out, window);
  return static_cast<int>(cudaGetLastError());
}

// tab_a, tab_b: n_members x rows x 128; idx, out_a, out_b: n_members x
// n_out (n_out % 1024 == 0); lo_rows: n_members x n_out / 1024; every
// pointer 16-byte aligned.
extern "C" int lf_gather_two(const void* tab_a, const void* tab_b,
                             const void* idx, const void* lo_rows,
                             void* out_a, void* out_b, int n_members,
                             int rows, int n_out, int win, void* stream) {
  if (n_members <= 0 || n_out <= 0) return 0;
  if (win <= 0 || rows < win || n_out % kGroup || n_members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = win <= kMaxStagedWin;
  if (staged) {
    const cudaError_t err = set_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto kernel = staged ? gather_two_kernel<true>
                             : gather_two_kernel<false>;
  kernel<<<dim3(n_out / kGroup, n_members), kThreads,
           staged ? win * 1024 : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab_a), static_cast<const int32_t*>(tab_b),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(lo_rows),
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b), rows, win);
  return static_cast<int>(cudaGetLastError());
}

// The two-table gather as compiled for a window of `win` rows (staged up
// to kMaxStagedWin, direct above): out[0..7] = registers, static shared
// bytes, spill bytes, dynamic shared bytes, resident blocks per SM,
// threads per block, staged (1) or direct (0), the largest staged window.
extern "C" int lf_gather_two_info(int win, void* out) {
  int* o = static_cast<int*>(out);
  const bool staged = win <= kMaxStagedWin;
  const void* fn =
      staged ? reinterpret_cast<const void*>(gather_two_kernel<true>)
             : reinterpret_cast<const void*>(gather_two_kernel<false>);
  const int smem = staged ? win * 1024 : 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess && staged) err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = smem;
  o[5] = kThreads;
  o[6] = staged;
  o[7] = kMaxStagedWin;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], fn, kThreads, smem));
}
