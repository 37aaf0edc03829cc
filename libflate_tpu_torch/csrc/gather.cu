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
// indices idx (B, N, 128), where every 8-row group v of idx has a window of
// `win` table rows starting at lo_rows[b, v]: out_x[b, i] = tab_x[b,
// idx[b, i]] when the index's row (idx >> 7) lies in [lo, lo + win), else
// 0.  The TPU kernel sweeps the window's rows with a lane shuffle and a
// select each; here one thread per output entry tests the window and loads
// both tables' entries.  The window's rows are read from lo clamped to
// [0, R - win], as the reference's dynamic slice reads them.  Bound by
// bytes: 8 read and 8 written an entry, the table reads hit L2.
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

__global__ void __launch_bounds__(kThreads)
gather_two_kernel(const int32_t* __restrict__ tab_a,
                  const int32_t* __restrict__ tab_b,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ lo_rows,
                  int32_t* __restrict__ out_a, int32_t* __restrict__ out_b,
                  int rows, int n_out, int win) {
  const int b = blockIdx.y;
  const int i = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (i >= n_out) return;                       // n_out = N * 128 entries
  const int64_t off = static_cast<int64_t>(b) * n_out + i;
  const int j = idx[off];
  const int l0 = lo_rows[static_cast<int64_t>(b) * (n_out / 1024) + i / 1024];
  const int u = (j >> 7) - l0;                  // row within the window
  int va = 0, vb = 0;
  if (u >= 0 && u < win) {
    const int64_t t = (static_cast<int64_t>(b) * rows +
                       min(max(l0, 0), rows - win) + u) * 128 + (j & 127);
    va = __ldg(tab_a + t);
    vb = __ldg(tab_b + t);
  }
  out_a[off] = va;
  out_b[off] = vb;
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

extern "C" int lf_gather_two(const void* tab_a, const void* tab_b,
                             const void* idx, const void* lo_rows,
                             void* out_a, void* out_b, int n_members,
                             int rows, int n_out, int win, void* stream) {
  if (n_members <= 0 || n_out <= 0) return 0;
  if (win <= 0 || rows < win || n_out % 1024 || n_members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + kThreads - 1) / kThreads, n_members);
  gather_two_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab_a), static_cast<const int32_t*>(tab_b),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(lo_rows),
      static_cast<int32_t*>(out_a), static_cast<int32_t*>(out_b), rows, n_out,
      win);
  return static_cast<int>(cudaGetLastError());
}
