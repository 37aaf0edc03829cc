// CRC-32 f-values and Adler-32 for Hopper (sm_90a).
//
// lf_crc32_rows replaces libflate_tpu/ops/checksum.py `crc32_f_rows`
// (:170, with `_crc32_f_padded` :116 and `_apply_gf2_cols` :157): the CRC
// register from 0 over exactly the N bytes of each of B rows.  The TPU
// version widens every byte to 8 float32 bits for a (512 x 32) bit-matrix
// product on the MXU and folds 64-byte chunks with a 32 x 32 float product
// a tree level, after padding each row to a power of two of chunks and
// undoing the trailing zeros with an inverse shift; 32 bytes of float
// traffic a byte of input.  Here each byte is read once and looked up in
// slice-by-8 tables.
//
// What bounds it: bytes.  The rows are read once and a register written a
// row: 64 MiB in 0.0200 ms at 3.35 TB/s.  The work is a shared-memory
// table lookup a byte (64 Mi at 64 MiB, ~9 us at 32 lookups a clock on
// 132 SMs if no two lanes of a warp hit one bank; random bytes give a few
// lanes a bank).
//
// Design.  A register from 0 is unchanged by leading zero bytes (T[0] =
// 0), so a row is read as whole 64 KiB tiles (kTile) ending at the row's
// last 16-byte-aligned address e' = (a + N) & ~15, every byte before the
// row's first address a read as zero: no pad at the end, no inverse shift.
// The last (a + N) - e' < 16 bytes, the tail, are folded in one at a time
// when the row is finished.  So every load is an aligned int4 that ends at
// or before e': none reads past the row; the int4 holding a is read whole
// and its bytes before a are zeroed.
// * Pass 1: a 256-thread block a (tile, row).  Thread t owns the tile's
//   256 bytes from t * 256.  The tile is staged through shared memory in 4
//   stages of 16 KiB: a stage holds 64 bytes of every thread's run (four
//   lanes load a run's 64 contiguous bytes as int4, so every 32-byte
//   sector fetched is used), stored in shared memory with the run's four
//   int4 slots permuted by ((run >> 1) & 3) so that neither the stores nor
//   the reads of a quarter warp share a bank.  Two stage buffers: the next
//   stage's loads are in flight in registers while the thread computes the
//   current one, one __syncthreads a stage.  A thread's register over its
//   run goes slice-by-8 (8 lookups a 8 bytes) through the 8 KiB of tables
//   in shared memory.
// * The runs' registers fold in a tree: the left span's register is moved
//   over the right span's bytes by the shift operator A_{2^l} (the
//   register advanced over 2^l zero bytes, a 32 x 32 GF(2) matrix given as
//   its 32 columns: applying it is the XOR of the columns whose bit is
//   set), then XORed with the right's.  Five levels by warp shuffles, three
//   across the block's 8 warps.  The operators are built on the host
//   (ops/checksum.kernel_constants) for l < kLevels and read through L1.
// * A row of one tile is finished in pass 1.  A longer row (the engine's
//   crc32 hands one row of the whole input) writes a register a tile to a
//   scratch row, and pass 2 folds them, a 256-thread block a row: thread t
//   folds q consecutive tiles (q the least power of two with 256 q >=
//   tiles, the tiles padded in front with zero registers), then the block
//   tree, then the tail.
//
// lf_adler32 replaces `adler32_jax` (:288) with `_adler32_padded` (:270),
// XLA in the reference: Adler-32 of one buffer of n bytes, folded on the
// card into one uint32.  A = 1 + sum d_p and B = n + sum d_p (n - p) mod
// 65521, taken over 16-byte chunks at aligned addresses: chunk j (its
// first byte at p_j) gives sa_j = sum d and sb_j = sum (16 - t) d_{p_j +
// t} (two __dp4a each a word), and B gathers sb_j + ((n - p_j - 16) mod m)
// sa_j.  The bytes before the first aligned address and after the last
// (< 16 each) go one at a time.  A thread sums its chunks in 64 bits,
// reduces mod m, the block sums its warps, and a second one-block launch
// sums the blocks' pairs and writes (B << 16) | A: the host reads back one
// word.  What bounds it: bytes (n read once).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunLog = 8;                       // a thread's bytes a tile
constexpr int kRun = 1 << kRunLog;
constexpr int kStages = kRun / 64;               // 64 bytes a run a stage
constexpr int kStageInt4 = kThreads * 4;         // 16 KiB a stage
constexpr int kTileLog = kRunLog + 8;            // 256 runs: 64 KiB
constexpr int64_t kTile = int64_t{1} << kTileLog;
constexpr int kTableWords = 8 * 256;             // slice-by-8 tables
constexpr int kLevels = 48;                      // operators A_{2^l}
constexpr uint32_t kMod = 65521;
constexpr int kAdlerMaxBlocks = 1024;

// A_{2^l} applied to v: the XOR of the columns cols[j] whose bit j of v
// is set.  Every lane reads the same column: a broadcast through L1.
__device__ __forceinline__ uint32_t apply_op(const uint32_t* __restrict__ cols,
                                             uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) r ^= __ldg(cols + j) & (0u - ((v >> j) & 1u));
  return r;
}

// The register over the block's span from each thread's register over
// its 2^unit_log bytes, threads in byte order.  Valid in thread kWarps - 1.
__device__ __forceinline__ uint32_t block_fold(uint32_t v, int unit_log,
                                               const uint32_t* ops,
                                               uint32_t* wreg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const uint32_t left = __shfl_up_sync(0xffffffffu, v, 1 << s);
    if ((lane & ((2 << s) - 1)) == (2 << s) - 1)
      v ^= apply_op(ops + (unit_log + s) * 32, left);
  }
  if (lane == 31) wreg[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? wreg[lane] : 0u;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t left = __shfl_up_sync(0xffffffffu, v, 1 << s);
      if ((lane & ((2 << s) - 1)) == (2 << s) - 1)
        v ^= apply_op(ops + (unit_log + 5 + s) * 32, left);
    }
  }
  return v;
}

// The register moved over the bytes [from, to) one at a time (T0 = t).
__device__ __forceinline__ uint32_t crc_bytes(const uint32_t* t, uint32_t c,
                                              int64_t from, int64_t to) {
  for (int64_t x = from; x < to; ++x)
    c = t[(c ^ *reinterpret_cast<const uint8_t*>(x)) & 255u] ^ (c >> 8);
  return c;
}

__device__ __forceinline__ uint32_t step8(const uint32_t* t, uint32_t c,
                                          uint32_t w0, uint32_t w1) {
  const uint32_t x = w0 ^ c;
  return t[7 * 256 + (x & 255u)] ^ t[6 * 256 + ((x >> 8) & 255u)]
         ^ t[5 * 256 + ((x >> 16) & 255u)] ^ t[4 * 256 + (x >> 24)]
         ^ t[3 * 256 + (w1 & 255u)] ^ t[2 * 256 + ((w1 >> 8) & 255u)]
         ^ t[1 * 256 + ((w1 >> 16) & 255u)] ^ t[w1 >> 24];
}

// bytes of word w (bytes 4w..4w+3 of an int4) at or past byte k
__device__ __forceinline__ int keep_from(int k, int w) {
  const int drop = k - 4 * w;
  return drop <= 0 ? -1 : drop >= 4 ? 0 : static_cast<int>(~0u << (8 * drop));
}

// The aligned int4 at addr with its bytes before the row's first address
// a read as zero; not loaded when it lies wholly before a.
__device__ __forceinline__ int4 load_from(int64_t addr, int64_t a) {
  if (addr + 16 <= a) return make_int4(0, 0, 0, 0);
  int4 v = __ldg(reinterpret_cast<const int4*>(addr));
  if (addr < a) {
    const int k = static_cast<int>(a - addr);
    v.x &= keep_from(k, 0);
    v.y &= keep_from(k, 1);
    v.z &= keep_from(k, 2);
    v.w &= keep_from(k, 3);
  }
  return v;
}

// slot of int4 p (0..3) of run s in a stage buffer
__device__ __forceinline__ int slot(int s, int p) {
  return s * 4 + (p ^ ((s >> 1) & 3));
}

__global__ void __launch_bounds__(kThreads)
crc_tiles_kernel(const uint8_t* __restrict__ data, int n_rows, int64_t n,
                 int64_t tiles, const uint32_t* __restrict__ consts,
                 uint32_t* __restrict__ scratch, uint32_t* __restrict__ out) {
  __shared__ uint32_t tab[kTableWords];
  __shared__ int4 stage[2][kStageInt4];
  __shared__ uint32_t wreg[kWarps];
  const int tid = threadIdx.x;
  for (int i = tid; i < kTableWords; i += kThreads) tab[i] = __ldg(consts + i);
  const uint32_t* ops = consts + kTableWords;
  for (int b = blockIdx.y; b < n_rows; b += gridDim.y) {
    const int64_t a = static_cast<int64_t>(reinterpret_cast<uintptr_t>(data))
                      + static_cast<int64_t>(b) * n;
    const int64_t e_al = (a + n) & ~int64_t{15};
    const int64_t base = e_al - (tiles - blockIdx.x) * kTile;
    int4 regs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = j * kThreads + tid;
      regs[j] = load_from(base + (q >> 2) * kRun + (q & 3) * 16, a);
    }
    uint32_t c = 0;
#pragma unroll
    for (int r = 0; r < kStages; ++r) {
      int4* buf = stage[r & 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = j * kThreads + tid;
        buf[slot(q >> 2, q & 3)] = regs[j];
      }
      __syncthreads();
      if (r + 1 < kStages) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = j * kThreads + tid;
          regs[j] = load_from(
              base + (q >> 2) * kRun + (r + 1) * 64 + (q & 3) * 16, a);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int4 w = buf[slot(tid, p)];
        c = step8(tab, c, static_cast<uint32_t>(w.x),
                  static_cast<uint32_t>(w.y));
        c = step8(tab, c, static_cast<uint32_t>(w.z),
                  static_cast<uint32_t>(w.w));
      }
    }
    c = block_fold(c, kRunLog, ops, wreg);
    if (tid == kWarps - 1) {
      if (tiles == 1)
        out[b] = crc_bytes(tab, c, a > e_al ? a : e_al, a + n);
      else
        scratch[static_cast<int64_t>(b) * tiles + blockIdx.x] = c;
    }
    __syncthreads();                 // the buffers and wreg of the next row
  }
}

__global__ void __launch_bounds__(kThreads)
crc_fold_kernel(const uint8_t* __restrict__ data, int n_rows, int64_t n,
                int64_t tiles, const uint32_t* __restrict__ consts,
                const uint32_t* __restrict__ scratch,
                uint32_t* __restrict__ out) {
  __shared__ uint32_t wreg[kWarps];
  const uint32_t* ops = consts + kTableWords;
  int q_log = 0;
  while ((int64_t{kThreads} << q_log) < tiles) ++q_log;
  const int64_t q = int64_t{1} << q_log;
  const int64_t front = (int64_t{kThreads} << q_log) - tiles;
  for (int b = blockIdx.x; b < n_rows; b += gridDim.x) {
    const uint32_t* row = scratch + static_cast<int64_t>(b) * tiles;
    uint32_t v = 0;
    for (int64_t j = threadIdx.x * q; j < (threadIdx.x + 1) * q; ++j) {
      const int64_t i = j - front;
      v = apply_op(ops + kTileLog * 32, v) ^ (i >= 0 ? row[i] : 0u);
    }
    v = block_fold(v, kTileLog + q_log, ops, wreg);
    if (threadIdx.x == kWarps - 1) {
      const int64_t a =
          static_cast<int64_t>(reinterpret_cast<uintptr_t>(data))
          + static_cast<int64_t>(b) * n;
      const int64_t e_al = (a + n) & ~int64_t{15};
      out[b] = crc_bytes(consts, v, a > e_al ? a : e_al, a + n);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// (sa, sb) mod kMod of the block's chunks to partial[2 * block + 0/1];
// head: the bytes before the first aligned address (< 16), n_body: the
// aligned 16-byte chunks after them.
__global__ void __launch_bounds__(kThreads)
adler_partial_kernel(const uint8_t* __restrict__ data, int64_t n,
                     int64_t head, int64_t n_body,
                     uint32_t* __restrict__ partial) {
  __shared__ uint32_t red[2][kWarps];
  const int4* body = reinterpret_cast<const int4*>(data + head);
  uint64_t sa = 0, sb = 0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n_body; j += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int4 v = __ldg(body + j);
    const unsigned x = v.x, y = v.y, z = v.z, w = v.w;
    const unsigned ca = __dp4a(x, 0x01010101u, __dp4a(y, 0x01010101u,
                        __dp4a(z, 0x01010101u, __dp4a(w, 0x01010101u, 0u))));
    const unsigned cb = __dp4a(x, 0x0D0E0F10u, __dp4a(y, 0x090A0B0Cu,
                        __dp4a(z, 0x05060708u, __dp4a(w, 0x01020304u, 0u))));
    const uint64_t coef = static_cast<uint64_t>(n - head - 16 * j - 16) % kMod;
    sa += ca;
    sb += cb + coef * ca;
  }
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + 16 * n_body;
    const int64_t k = threadIdx.x < head ? threadIdx.x
                                         : tail0 + threadIdx.x - head;
    if (k < n && (threadIdx.x < head || k >= tail0)) {
      const uint32_t d = data[k];
      sa += d;
      sb += d * (static_cast<uint64_t>(n - k) % kMod);
    }
  }
  uint32_t ra = warp_sum(static_cast<uint32_t>(sa % kMod));
  uint32_t rb = warp_sum(static_cast<uint32_t>(sb % kMod));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = ra;
    red[1][warp] = rb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ra = rb = 0;
    for (int i = 0; i < kWarps; ++i) {
      ra += red[0][i];
      rb += red[1][i];
    }
    partial[2 * blockIdx.x] = ra % kMod;
    partial[2 * blockIdx.x + 1] = rb % kMod;
  }
}

__global__ void __launch_bounds__(kThreads)
adler_fold_kernel(const uint32_t* __restrict__ partial, int blocks, int64_t n,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t red[2][kWarps];
  uint32_t sa = 0, sb = 0;             // < 4 pairs a thread: no overflow
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    sa += partial[2 * i];
    sb += partial[2 * i + 1];
  }
  sa = warp_sum(sa % kMod);
  sb = warp_sum(sb % kMod);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = sa;
    red[1][warp] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t a = 1, b = static_cast<uint64_t>(n) % kMod;
    for (int i = 0; i < kWarps; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    out[0] = static_cast<uint32_t>(b % kMod) << 16
             | static_cast<uint32_t>(a % kMod);
  }
}

const void* kernel_fn(int kernel) {
  switch (kernel) {
    case 0: return reinterpret_cast<const void*>(crc_tiles_kernel);
    case 1: return reinterpret_cast<const void*>(crc_fold_kernel);
    case 2: return reinterpret_cast<const void*>(adler_partial_kernel);
    case 3: return reinterpret_cast<const void*>(adler_fold_kernel);
    default: return nullptr;
  }
}

}  // namespace

// data: n_rows rows of n bytes, contiguous, any alignment; consts: the
// kTableWords table words then kLevels x 32 operator columns; tiles: at
// least ceil(floor16(n + 15) / 65536); scratch: n_rows x tiles words when
// tiles > 1; out: n_rows words.
extern "C" int lf_crc32_rows(const void* data, int n_rows, int64_t n,
                             int64_t tiles, const void* consts, void* scratch,
                             void* out, void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (tiles <= 0 || tiles > INT_MAX || (tiles > 1 && scratch == nullptr)
      || ((n + 15) & ~int64_t{15}) > tiles * kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const uint8_t*>(data);
  const auto k = static_cast<const uint32_t*>(consts);
  const int rows = n_rows < 65535 ? n_rows : 65535;
  crc_tiles_kernel<<<dim3(static_cast<unsigned>(tiles), rows), kThreads, 0,
                     s>>>(d, n_rows, n, tiles, k,
                          static_cast<uint32_t*>(scratch),
                          static_cast<uint32_t*>(out));
  if (tiles > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    crc_fold_kernel<<<rows, kThreads, 0, s>>>(
        d, n_rows, n, tiles, k, static_cast<const uint32_t*>(scratch),
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// data: n bytes, any alignment; partial: 2 x blocks words, blocks in
// [1, 1024]; out: one word, (B << 16) | A.
extern "C" int lf_adler32(const void* data, int64_t n, int blocks,
                          void* partial, void* out, void* stream) {
  if (n <= 0 || blocks <= 0 || blocks > kAdlerMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(data);
  int64_t head = static_cast<int64_t>((16 - (addr & 15)) & 15);
  if (head > n) head = n;
  const int64_t n_body = (n - head) / 16;
  adler_partial_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), n, head, n_body,
      static_cast<uint32_t*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adler_fold_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(partial), blocks, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// kernel 0: CRC tiles, 1: CRC tile fold, 2: Adler partial sums, 3: Adler
// fold.  out[0..6] = registers, static shared bytes, spill bytes,
// resident blocks per SM, threads per block, tile bytes, operator levels.
extern "C" int lf_checksum_info(int kernel, void* out) {
  const void* fn = kernel_fn(kernel);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(out);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[4] = kThreads;
  o[5] = static_cast<int>(kTile);
  o[6] = kLevels;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[3], fn, kThreads, 0));
}
