// libflate_native — the host engine of libflate_tpu_torch (the port's own
// copy of libflate_tpu/native/libflate_native.cpp, every extern "C"
// function, with two changes: the token decoders, lf_inflate_tokens and
// lf_inflate_tokens_batch, return LF_TRUNCATED where their input ends
// inside a body; and lf_deflate3's per-thread token buffer is freed when
// its thread exits).
//
//   * CRC-32 by carry-less multiply (slice-by-8 without PCLMUL), Adler-32
//     with AVX2 (blocked scalar without)
//   * a fast serial DEFLATE decoder (two-level tables, an interleaved
//     pair decoder, unrolled copies) and its member-parallel batches
//   * a greedy / lazy / hash-chain DEFLATE encoder (dynamic blocks with
//     RLE'd code-length headers) and its member-parallel batch
//   * batched dynamic-header parsing, the PGZF LF index walk
//   * token decode (the foreign-stream device decode's host half) and
//     token expansion with CRC
//   * bit-stream splicing for parallel-encoded block outputs
//
// Plain C ABI, loaded with ctypes by libflate_tpu_torch/native/__init__.py,
// which builds it with g++ at first use.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <atomic>
#include <memory>
#include <new>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define LF_HAVE_CLMUL 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32 (IEEE, reflected) — slice-by-8
// ---------------------------------------------------------------------------
static uint32_t crc_tab[8][256];
static bool crc_init_done = false;

static void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0xEDB88320u : 0);
        crc_tab[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
        for (uint32_t i = 0; i < 256; i++)
            crc_tab[k][i] = crc_tab[0][crc_tab[k-1][i] & 0xFF] ^ (crc_tab[k-1][i] >> 8);
    crc_init_done = true;
}

static uint32_t crc32_slice8(const uint8_t* buf, uint64_t n, uint32_t crc) {
    uint32_t c = crc ^ 0xFFFFFFFFu;
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, buf, 4); memcpy(&hi, buf + 4, 4);
        lo ^= c;
        c = crc_tab[7][lo & 0xFF] ^ crc_tab[6][(lo >> 8) & 0xFF]
          ^ crc_tab[5][(lo >> 16) & 0xFF] ^ crc_tab[4][lo >> 24]
          ^ crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF]
          ^ crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
        buf += 8; n -= 8;
    }
    while (n--) c = crc_tab[0][(c ^ *buf++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

#ifdef LF_HAVE_CLMUL
// ---------------------------------------------------------------------------
// PCLMULQDQ CRC-32: fold 512 bits per step, finish through the byte table.
// Fold constants are derived at startup from x^n mod P (no magic numbers)
// and the whole path is self-tested against slice-by-8 before first use.
//
// Register convention: a 16-byte little-endian load holds the chunk
// polynomial bit-reflected (bit p = coeff of x^(127-p)), so the LOW qword
// is the HIGH-degree half.  Folding a chunk A = H*x^64 + L by distance T:
//   A*x^T ≡ H*(x^(T+64) mod P) + L*(x^T mod P)   (mod P)
// and with a constant placed at rev32(k)<<32, clmul of the reflected
// operands yields the reflected product directly (the placement absorbs
// clmul's inherent one-bit offset — hence the T+63 / T-1 exponents).
// ---------------------------------------------------------------------------
static uint32_t xpow_mod(int n) {          // x^n mod P, normal bit order
    uint32_t r = 1;
    for (int k = 0; k < n; k++) {
        uint32_t top = r & 0x80000000u;
        r <<= 1;
        if (top) r ^= 0x04C11DB7u;
    }
    return r;
}
static uint32_t rev32(uint32_t v) {
    v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
    v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
    v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
    v = ((v >> 8) & 0x00FF00FFu) | ((v & 0x00FF00FFu) << 8);
    return (v >> 16) | (v << 16);
}
static uint64_t fold_k_lo_512, fold_k_hi_512, fold_k_lo_128, fold_k_hi_128;
static int clmul_ok = -1;   // -1 unknown, 0 unusable, 1 verified

__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_clmul(const uint8_t* p, uint64_t n, uint32_t crc) {
    const __m128i K512 = _mm_set_epi64x((int64_t)fold_k_hi_512,
                                        (int64_t)fold_k_lo_512);
    const __m128i K128 = _mm_set_epi64x((int64_t)fold_k_hi_128,
                                        (int64_t)fold_k_lo_128);
    uint32_t c0 = crc ^ 0xFFFFFFFFu;
    __m128i x0 = _mm_loadu_si128((const __m128i*)p);
    __m128i x1 = _mm_loadu_si128((const __m128i*)(p+16));
    __m128i x2 = _mm_loadu_si128((const __m128i*)(p+32));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(p+48));
    x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)c0));
    p += 64; n -= 64;
    while (n >= 64) {
        x0 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x0, K512, 0x00),
                                         _mm_clmulepi64_si128(x0, K512, 0x11)),
                           _mm_loadu_si128((const __m128i*)p));
        x1 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x1, K512, 0x00),
                                         _mm_clmulepi64_si128(x1, K512, 0x11)),
                           _mm_loadu_si128((const __m128i*)(p+16)));
        x2 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x2, K512, 0x00),
                                         _mm_clmulepi64_si128(x2, K512, 0x11)),
                           _mm_loadu_si128((const __m128i*)(p+32)));
        x3 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x3, K512, 0x00),
                                         _mm_clmulepi64_si128(x3, K512, 0x11)),
                           _mm_loadu_si128((const __m128i*)(p+48)));
        p += 64; n -= 64;
    }
    __m128i x = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x0, K128, 0x00),
                                            _mm_clmulepi64_si128(x0, K128, 0x11)), x1);
    x = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, K128, 0x00),
                                    _mm_clmulepi64_si128(x, K128, 0x11)), x2);
    x = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, K128, 0x00),
                                    _mm_clmulepi64_si128(x, K128, 0x11)), x3);
    while (n >= 16) {
        x = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, K128, 0x00),
                                        _mm_clmulepi64_si128(x, K128, 0x11)),
                          _mm_loadu_si128((const __m128i*)p));
        p += 16; n -= 16;
    }
    // the folded register, stored little-endian, is a 16-byte message
    // equivalent (mod P) to everything folded so far — finish via table
    uint8_t rbytes[16];
    _mm_storeu_si128((__m128i*)rbytes, x);
    uint32_t c = 0;
    for (int i = 0; i < 16; i++) c = crc_tab[0][(c ^ rbytes[i]) & 0xFF] ^ (c >> 8);
    while (n--) c = crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

static void clmul_init() {
    if (clmul_ok >= 0) return;
    if (!__builtin_cpu_supports("pclmul") || !__builtin_cpu_supports("sse4.1")) {
        clmul_ok = 0; return;
    }
    fold_k_lo_512 = (uint64_t)rev32(xpow_mod(512 + 63)) << 32;
    fold_k_hi_512 = (uint64_t)rev32(xpow_mod(512 - 1)) << 32;
    fold_k_lo_128 = (uint64_t)rev32(xpow_mod(128 + 63)) << 32;
    fold_k_hi_128 = (uint64_t)rev32(xpow_mod(128 - 1)) << 32;
    // self-test on an awkward length with a nonzero seed
    uint8_t buf[731];
    uint32_t s = 0x12345678u;
    for (size_t i = 0; i < sizeof buf; i++) {
        s = s * 1103515245u + 12345u; buf[i] = (uint8_t)(s >> 16);
    }
    clmul_ok = crc32_clmul(buf, sizeof buf, 0xDEADBEEFu)
            == crc32_slice8(buf, sizeof buf, 0xDEADBEEFu) ? 1 : 0;
}
#endif

uint32_t lf_crc32(const uint8_t* buf, uint64_t n, uint32_t crc) {
    crc_init();
#ifdef LF_HAVE_CLMUL
    if (n >= 256) {
        clmul_init();
        if (clmul_ok == 1) return crc32_clmul(buf, n, crc);
    }
#endif
    return crc32_slice8(buf, n, crc);
}

// ---------------------------------------------------------------------------
// Adler-32
// ---------------------------------------------------------------------------
static uint32_t adler32_scalar(const uint8_t* buf, uint64_t n, uint32_t adler) {
    const uint32_t MOD = 65521;
    uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    while (n) {
        uint64_t blk = n < 5552 ? n : 5552;   // max before 32-bit overflow
        n -= blk;
        while (blk--) { a += *buf++; b += a; }
        a %= MOD; b %= MOD;
    }
    return (b << 16) | a;
}

#ifdef LF_HAVE_CLMUL
// AVX2 Adler-32: per 32-byte chunk, sad_epu8 gives the byte sum and
// maddubs with weights 32..1 the position-weighted sum; the running
// chunk-sum accumulator (scaled by 32 at block end) supplies the
// cross-chunk weights.  Block length 5536 (mult. of 32, < NMAX) keeps
// every 32-bit lane below overflow.  Self-tested at startup.
static int adler_avx2_ok = -1;

__attribute__((target("avx2")))
static uint32_t adler32_avx2(const uint8_t* p, uint64_t n, uint32_t adler) {
    const uint32_t MOD = 65521;
    uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    const __m256i W = _mm256_setr_epi8(
        32,31,30,29,28,27,26,25,24,23,22,21,20,19,18,17,
        16,15,14,13,12,11,10,9,8,7,6,5,4,3,2,1);
    const __m256i ones16 = _mm256_set1_epi16(1);
    const __m256i zero = _mm256_setzero_si256();
    while (n >= 32) {
        uint64_t blk = n & ~(uint64_t)31;
        if (blk > 5536) blk = 5536;
        uint64_t k = blk / 32;
        __m256i v_s1 = zero, v_s2 = zero, v_s1_sums = zero;
        for (uint64_t j = 0; j < k; j++) {
            __m256i c = _mm256_loadu_si256((const __m256i*)(p + 32*j));
            v_s1_sums = _mm256_add_epi32(v_s1_sums, v_s1);
            v_s1 = _mm256_add_epi32(v_s1, _mm256_sad_epu8(c, zero));
            v_s2 = _mm256_add_epi32(v_s2,
                _mm256_madd_epi16(_mm256_maddubs_epi16(c, W), ones16));
        }
        // horizontal sums: v_s1/v_s1_sums live in the 4 u64 sad lanes
        uint64_t s1l[4]; uint32_t s2l[8], ssl[8];
        _mm256_storeu_si256((__m256i*)s1l, v_s1);
        _mm256_storeu_si256((__m256i*)s2l, v_s2);
        _mm256_storeu_si256((__m256i*)ssl, v_s1_sums);
        uint32_t chunk_sum = (uint32_t)(s1l[0] + s1l[1] + s1l[2] + s1l[3]);
        uint32_t weighted = s2l[0]+s2l[1]+s2l[2]+s2l[3]+s2l[4]+s2l[5]+s2l[6]+s2l[7];
        uint32_t sums = ssl[0]+ssl[2]+ssl[4]+ssl[6];   // sad lanes: every other u32
        b = (uint32_t)((b + (uint64_t)blk * a + 32ull * sums + weighted) % MOD);
        a = (a + chunk_sum) % MOD;
        p += blk; n -= blk;
    }
    if (n) return adler32_scalar(p, n, (b << 16) | a);
    return (b << 16) | a;
}

static void adler_avx2_init() {
    if (adler_avx2_ok >= 0) return;
    if (!__builtin_cpu_supports("avx2")) { adler_avx2_ok = 0; return; }
    uint8_t buf[1217];
    uint32_t s = 0x87654321u;
    for (size_t i = 0; i < sizeof buf; i++) {
        s = s * 1103515245u + 12345u; buf[i] = (uint8_t)(s >> 16);
    }
    adler_avx2_ok = adler32_avx2(buf, sizeof buf, 0x0BADF00Du)
                 == adler32_scalar(buf, sizeof buf, 0x0BADF00Du) ? 1 : 0;
}
#endif

uint32_t lf_adler32(const uint8_t* buf, uint64_t n, uint32_t adler) {
#ifdef LF_HAVE_CLMUL
    if (n >= 64) {
        adler_avx2_init();
        if (adler_avx2_ok == 1) return adler32_avx2(buf, n, adler);
    }
#endif
    return adler32_scalar(buf, n, adler);
}

// ---------------------------------------------------------------------------
// Bit reader (LSB-first)
// ---------------------------------------------------------------------------
struct BitIn {
    const uint8_t* data;
    uint64_t size;
    uint64_t pos;       // byte position
    uint64_t acc;
    int nbits;
    bool overrun;
};

static inline void bi_init(BitIn* b, const uint8_t* d, uint64_t n, uint64_t start_bit) {
    b->data = d; b->size = n; b->pos = start_bit >> 3;
    b->acc = 0; b->nbits = 0; b->overrun = false;
    int drop = (int)(start_bit & 7);
    if (b->pos < n) { b->acc = d[b->pos++] >> drop; b->nbits = 8 - drop; }
    else if (drop) b->overrun = true;
}

static inline void bi_fill(BitIn* b) {
    if (b->pos + 8 <= b->size) {
        // branchless 64-bit refill (libdeflate-style): claim 56-63 bits
        uint64_t chunk;
        memcpy(&chunk, b->data + b->pos, 8);
        b->acc |= chunk << b->nbits;
        b->pos += (63 - b->nbits) >> 3;
        b->nbits |= 56;
        return;
    }
    while (b->nbits <= 56) {
        if (b->pos >= b->size) break;
        b->acc |= (uint64_t)b->data[b->pos++] << b->nbits;
        b->nbits += 8;
    }
}

static inline uint32_t bi_read(BitIn* b, int n) {
    if (b->nbits < n) bi_fill(b);
    if (b->nbits < n) { b->overrun = true; return 0; }
    uint32_t v = (uint32_t)(b->acc & ((1ull << n) - 1));
    b->acc >>= n; b->nbits -= n;
    return v;
}

static inline uint32_t bi_peek(BitIn* b, int n) {
    if (b->nbits < n) bi_fill(b);
    return (uint32_t)(b->acc & ((1ull << n) - 1));
}

static inline void bi_skip(BitIn* b, int n) {
    if (b->nbits < n) { b->overrun = true; b->nbits = 0; b->acc = 0; return; }
    b->acc >>= n; b->nbits -= n;
}

static inline uint64_t bi_bitpos(BitIn* b) { return b->pos * 8 - b->nbits; }

static inline void bi_align(BitIn* b) { int d = b->nbits & 7; b->acc >>= d; b->nbits -= d; }

// ---------------------------------------------------------------------------
// Huffman decode table (flat, 2^15 max)
// ---------------------------------------------------------------------------
// entry: (sym << 4) | width, 0 = invalid
static bool build_table(const int32_t* lengths, int n, uint16_t* table, int table_bits) {
    int counts[16] = {0};
    for (int i = 0; i < n; i++) {
        int l = lengths[i];
        if (l < 0 || l > table_bits) return false;
        if (l) counts[l]++;
    }
    int firsts[16]; int code = 0;
    int total = 0;
    for (int l = 1; l <= table_bits; l++) {
        code = (code + counts[l-1]) << 1;
        firsts[l] = code;
        total += counts[l] << (table_bits - l);
    }
    if (total > (1 << table_bits)) return false;   // oversubscribed
    memset(table, 0, sizeof(uint16_t) << table_bits);
    int next[16]; memcpy(next, firsts, sizeof(next));
    for (int s = 0; s < n; s++) {
        int l = lengths[s];
        if (!l) continue;
        int c = next[l]++;
        // reverse l bits
        int rev = 0, cc = c;
        for (int k = 0; k < l; k++) { rev = (rev << 1) | (cc & 1); cc >>= 1; }
        for (int idx = rev; idx < (1 << table_bits); idx += (1 << l))
            table[idx] = (uint16_t)((s << 4) | l);
    }
    return true;
}

// ---------------------------------------------------------------------------
// DEFLATE decode tables / constants
// ---------------------------------------------------------------------------
static const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
    35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
    3,3,3,3,4,4,4,4,5,5,5,5,0};
static const uint32_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,
    129,193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
    7,7,8,8,9,9,10,10,11,11,12,12,13,13};
static const uint8_t CLC_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

// ---------------------------------------------------------------------------
// Pre-decoded 32-bit decode tables (libdeflate-style single-load entries)
//   literal:      0x80000000 | byte<<16 | code_width
//   end-of-block: 0x40000000 | code_width
//   sym 286/287:  0x20000000 | code_width   (valid fixed code, invalid symbol)
//   length/dist:  base<<16 | extra_count<<8 | code_width
//   invalid:      0
// One table load yields everything the hot loop needs; the base value and
// extra-bit count are baked in so LEN_BASE/LEN_EXTRA/DIST_* lookups and the
// literal/length classification branch tree disappear from the hot path.
// ---------------------------------------------------------------------------
static bool build_table32(const int32_t* lengths, int n, uint32_t* table,
                          int table_bits, bool is_dist) {
    int counts[16] = {0};
    for (int i = 0; i < n; i++) {
        int l = lengths[i];
        if (l < 0 || l > table_bits) return false;
        if (l) counts[l]++;
    }
    int firsts[16]; int code = 0;
    int total = 0;
    for (int l = 1; l <= table_bits; l++) {
        code = (code + counts[l-1]) << 1;
        firsts[l] = code;
        total += counts[l] << (table_bits - l);
    }
    if (total > (1 << table_bits)) return false;   // oversubscribed
    memset(table, 0, sizeof(uint32_t) << table_bits);
    int next[16]; memcpy(next, firsts, sizeof(next));
    for (int s = 0; s < n; s++) {
        int l = lengths[s];
        if (!l) continue;
        int c = next[l]++;
        int rev = 0, cc = c;
        for (int k = 0; k < l; k++) { rev = (rev << 1) | (cc & 1); cc >>= 1; }
        uint32_t v;
        if (is_dist) {
            v = (DIST_BASE[s] << 16) | ((uint32_t)DIST_EXTRA[s] << 8) | l;
        } else if (s < 256) {
            v = 0x80000000u | ((uint32_t)s << 16) | l;
        } else if (s == 256) {
            v = 0x40000000u | l;
        } else if (s <= 285) {
            v = ((uint32_t)LEN_BASE[s-257] << 16)
              | ((uint32_t)LEN_EXTRA[s-257] << 8) | l;
        } else {
            v = 0x20000000u | l;
        }
        for (int idx = rev; idx < (1 << table_bits); idx += (1 << l))
            table[idx] = v;
    }
    return true;
}


// ---------------------------------------------------------------------------
// Two-level (root + sub) decode tables, libdeflate/zlib style.
// A 2^15 single-level table (128 KiB) blows L1 and its per-member
// memset+fill dominates small-member decode; a 10-bit root (4 KiB)
// stays L1-resident and builds ~16x faster.  Long codes (> root_bits,
// rare by canonical construction) indirect through subtables appended
// after the root in the same buffer.
//   pointer entry: bit5 (0x20) | root_bits | subbits<<8 | sub_base<<16
//   (bit 5 is unused by every direct entry: width occupies bits 0-4,
//   extra-count bits 8-11, base/byte bits 16+, flags bits 29-31)
// Returns entries used (root+subs), or -1 on an invalid code set.
// ---------------------------------------------------------------------------
static int build_table2l(const int32_t* lengths, int n, uint32_t* table,
                         int root_bits, bool is_dist) {
    int counts[16] = {0};
    int lmax = 0;
    for (int i = 0; i < n; i++) {
        int l = lengths[i];
        if (l < 0 || l > 15) return -1;
        if (l) { counts[l]++; if (l > lmax) lmax = l; }
    }
    if (lmax <= root_bits) root_bits = lmax > 0 ? lmax : 1;
    int firsts[16]; int code = 0; long total = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + counts[l-1]) << 1;
        firsts[l] = code;
        total += (long)counts[l] << (15 - l);
    }
    if (total > (1L << 15)) return -1;             // oversubscribed
    const int root_n = 1 << root_bits;
    memset(table, 0, sizeof(uint32_t) * root_n);
    int sub_next = root_n;

    // pass 1: per-root-prefix max length -> allocate subtables
    if (lmax > root_bits) {
        static thread_local uint8_t submax[1 << 12];
        memset(submax, 0, root_n);
        int next1[16]; memcpy(next1, firsts, sizeof(next1));
        for (int s = 0; s < n; s++) {
            int l = lengths[s];
            if (l <= root_bits) { if (l) next1[l]++; continue; }
            int c = next1[l]++;
            int rev = 0, cc = c;
            for (int k = 0; k < l; k++) { rev = (rev << 1) | (cc & 1); cc >>= 1; }
            int prefix = rev & (root_n - 1);
            if (l - root_bits > submax[prefix]) submax[prefix] = (uint8_t)(l - root_bits);
        }
        for (int p = 0; p < root_n; p++) {
            if (!submax[p]) continue;
            int subbits = submax[p];
            memset(table + sub_next, 0, sizeof(uint32_t) << subbits);
            table[p] = 0x20u | (uint32_t)root_bits
                     | ((uint32_t)subbits << 8)
                     | ((uint32_t)sub_next << 16);
            sub_next += 1 << subbits;
            if (sub_next > (1 << 15)) return -1;
        }
    }

    // pass 2: fill direct + sub entries
    int next2[16]; memcpy(next2, firsts, sizeof(next2));
    for (int s = 0; s < n; s++) {
        int l = lengths[s];
        if (!l) continue;
        int c = next2[l]++;
        int rev = 0, cc = c;
        for (int k = 0; k < l; k++) { rev = (rev << 1) | (cc & 1); cc >>= 1; }
        int w = l <= root_bits ? l : l - root_bits;
        uint32_t v;
        if (is_dist) {
            v = (DIST_BASE[s] << 16) | ((uint32_t)DIST_EXTRA[s] << 8) | w;
        } else if (s < 256) {
            v = 0x80000000u | ((uint32_t)s << 16) | w;
        } else if (s == 256) {
            v = 0x40000000u | w;
        } else if (s <= 285) {
            v = ((uint32_t)LEN_BASE[s-257] << 16)
              | ((uint32_t)LEN_EXTRA[s-257] << 8) | w;
        } else {
            v = 0x20000000u | w;
        }
        if (l <= root_bits) {
            for (int idx = rev; idx < root_n; idx += (1 << l))
                table[idx] = v;
        } else {
            int prefix = rev & (root_n - 1);
            uint32_t pe = table[prefix];
            int subbits = (pe >> 8) & 15;
            int base = (int)(pe >> 16);
            for (int idx = rev >> root_bits; idx < (1 << subbits);
                 idx += (1 << (l - root_bits)))
                table[base + idx] = v;
        }
    }
    return sub_next;
}

// build with the best single/two-level layout; *bits_out = root mask bits
static bool build_table_auto(const int32_t* lengths, int n, uint32_t* table,
                             int max_root, bool is_dist, int* bits_out) {
    int lmax = 1;
    for (int i = 0; i < n; i++) if (lengths[i] > lmax) lmax = lengths[i];
    if (lmax <= max_root) {
        *bits_out = lmax;
        return build_table32(lengths, n, table, lmax, is_dist);
    }
    *bits_out = max_root;
    return build_table2l(lengths, n, table, max_root, is_dist) >= 0;
}

// resolve a level-2 pointer entry (no-op for direct entries is the
// caller's branch; this consumes the subtable bits)
#define RESOLVE2(e, tbl, b) \
    if (__builtin_expect((e) & 0x20u, 0)) { \
        uint32_t sb_ = ((e) >> 8) & 15u; \
        (e) = (tbl)[((e) >> 16) + ((uint32_t)(b).acc & ((1u << sb_) - 1))]; \
        (b).acc >>= ((e) & 31); (b).nbits -= ((e) & 31); \
    }


static void fixed_lit_lengths(int32_t* l) {
    for (int i = 0; i < 144; i++) l[i] = 8;
    for (int i = 144; i < 256; i++) l[i] = 9;
    for (int i = 256; i < 280; i++) l[i] = 7;
    for (int i = 280; i < 288; i++) l[i] = 8;
}

// parse a dynamic header; returns 0 ok, <0 error codes
static int parse_dyn_header(BitIn* b, int32_t* lit_l, int32_t* dist_l) {
    int hlit = bi_read(b, 5) + 257;
    int hdist = bi_read(b, 5) + 1;
    int hclen = bi_read(b, 4) + 4;
    if (b->overrun) return -1;
    if (hlit > 286) return -2;            // "HLIT too big" (5-bit field reaches 288)
    if (hdist > 30) return -2;            // "HDIST too big"
    int32_t clc[19] = {0};
    for (int k = 0; k < hclen; k++) clc[CLC_ORDER[k]] = bi_read(b, 3);
    if (b->overrun) return -1;
    uint16_t clc_table[1 << 7];
    if (!build_table(clc, 19, clc_table, 7)) return -3;
    int total = hlit + hdist;
    int32_t tmp[286 + 30];
    int i = 0;
    while (i < total) {
        uint16_t e = clc_table[bi_peek(b, 7)];
        if (!e) return -3;
        bi_skip(b, e & 15);
        if (b->overrun) return -1;
        int sym = e >> 4;
        if (sym < 16) { tmp[i++] = sym; }
        else if (sym == 16) {
            if (i == 0) return -4;
            int run = 3 + bi_read(b, 2);
            if (i + run > total) return -5;
            for (int k = 0; k < run; k++) { tmp[i] = tmp[i-1]; i++; }
        } else if (sym == 17) {
            int run = 3 + bi_read(b, 3);
            if (i + run > total) return -5;
            for (int k = 0; k < run; k++) tmp[i++] = 0;
        } else {
            int run = 11 + bi_read(b, 7);
            if (i + run > total) return -5;
            for (int k = 0; k < run; k++) tmp[i++] = 0;
        }
        if (b->overrun) return -1;
    }
    memset(lit_l, 0, 286 * sizeof(int32_t));
    memset(dist_l, 0, 30 * sizeof(int32_t));
    memcpy(lit_l, tmp, hlit * sizeof(int32_t));
    memcpy(dist_l, tmp + hlit, hdist * sizeof(int32_t));
    if (!lit_l[256]) return -6;           // EOB has no code
    return 0;
}


// ---------------------------------------------------------------------------
// decode one Huffman-coded block (fastloop + careful loop).  Resumable:
// continues from the BitIn/output state it is given, so the interleaved
// pair decoder can hand a stream over mid-block.  Returns 0 on block
// end (EOB consumed), <0 on the usual error codes.
// ---------------------------------------------------------------------------
static int decode_huff_block(BitIn* bp, const uint32_t* lit_table_, int lit_bits,
                             const uint32_t* dist_table_, int dist_bits,
                             uint8_t* dst, uint64_t* o_io, uint64_t cap) {
    BitIn b = *bp;
    uint64_t o = *o_io;
    const uint32_t lit_mask = (1u << lit_bits) - 1;
    const uint32_t dist_mask = (1u << dist_bits) - 1;
    // fastloop: enough output margin (longest match + word-copy
    // overshoot) and input look-ahead that all bounds checks are
    // hoisted.  One refill covers up to two literals plus a full
    // length code incl. extras (15+15+20 = 50 <= 56); a second
    // refill before the distance covers its worst case (28 bits).
    while (o + 274 <= cap && b.pos + 16 <= b.size) {
        bi_fill(&b);
        uint32_t e = lit_table_[(uint32_t)b.acc & lit_mask];
        b.acc >>= (e & 31); b.nbits -= (e & 31);
        RESOLVE2(e, lit_table_, b);
        if ((int32_t)e < 0) {
            dst[o++] = (uint8_t)(e >> 16);
            e = lit_table_[(uint32_t)b.acc & lit_mask];
            b.acc >>= (e & 31); b.nbits -= (e & 31);
            RESOLVE2(e, lit_table_, b);
            if ((int32_t)e < 0) {
                dst[o++] = (uint8_t)(e >> 16);
                e = lit_table_[(uint32_t)b.acc & lit_mask];
                b.acc >>= (e & 31); b.nbits -= (e & 31);
                RESOLVE2(e, lit_table_, b);
                if ((int32_t)e < 0) { dst[o++] = (uint8_t)(e >> 16); continue; }
            }
        }
        if (e & 0x60000000u) {
            if (e & 0x40000000u) goto block_end;
            return -10;
        }
        if (!e) return -3;
        {
            uint32_t le = (e >> 8) & 15;
            uint32_t length = (e >> 16) +
                ((uint32_t)b.acc & ((1u << le) - 1));
            b.acc >>= le; b.nbits -= le;
            bi_fill(&b);           // distance code + extras <= 28 bits
            uint32_t de = dist_table_[(uint32_t)b.acc & dist_mask];
            b.acc >>= (de & 31); b.nbits -= (de & 31);
            RESOLVE2(de, dist_table_, b);
            if (!de) return -3;
            uint32_t dxe = (de >> 8) & 15;
            uint32_t dist = (de >> 16) +
                ((uint32_t)b.acc & ((1u << dxe) - 1));
            b.acc >>= dxe; b.nbits -= dxe;
            if (dist > o) return -12;
            const uint8_t* s = dst + o - dist;
            uint8_t* d = dst + o;
            o += length;
            if (dist >= 8) {
                // margin guaranteed: copy in unconditional 8B chunks
                memcpy(d, s, 8);
                if (length > 8) {
                    d += 8; s += 8;
                    int64_t rem = (int64_t)length - 8;
                    while (rem > 0) { memcpy(d, s, 8); d += 8; s += 8; rem -= 8; }
                }
            } else if (dist == 1) {
                memset(d, *s, length);
            } else {
                // dist 2..7: seed one >=8-byte period-aligned window
                // byte-wise, then the pattern repeats every `off`
                // bytes and word copies from d-off are exact
                int off = dist; while (off < 8) off += dist;
                uint8_t* dd = d;
                for (int k = 0; k < off; k++) { *dd = dd[-(int)dist]; dd++; }
                const uint8_t* ss = dd - off;
                int64_t rem = (int64_t)length - off;
                while (rem > 0) { memcpy(dd, ss, 8); dd += 8; ss += 8; rem -= 8; }
            }
        }
    }
    for (;;) {
        // one refill covers the worst-case symbol: 15+5+15+13 <= 56
        bi_fill(&b);
        uint32_t e = lit_table_[(uint32_t)b.acc & lit_mask];
        if (!e) return -3;
        int w = e & 31;
        if (b.nbits < w) return -1;
        b.acc >>= w; b.nbits -= w;
        if (e & 0x20u) {               // two-level: long literal code
            uint32_t sb_ = (e >> 8) & 15u;
            e = lit_table_[(e >> 16) +
                           ((uint32_t)b.acc & ((1u << sb_) - 1))];
            if (!e) return -3;
            w = e & 31;
            if (b.nbits < w) return -1;
            b.acc >>= w; b.nbits -= w;
        }
        if ((int32_t)e < 0) {
            if (o >= cap) return -8;
            dst[o++] = (uint8_t)(e >> 16);
        } else if (e & 0x40000000u) {
            break;
        } else if (e & 0x20000000u) {
            return -10;
        } else {
            uint32_t le = (e >> 8) & 15;
            uint32_t length = (e >> 16) +
                ((uint32_t)b.acc & ((1u << le) - 1));
            b.acc >>= le; b.nbits -= le;
            uint32_t de = dist_table_[(uint32_t)b.acc & dist_mask];
            if (!de) return -3;
            int dw = de & 31;
            b.acc >>= dw; b.nbits -= dw;
            if (de & 0x20u) {          // two-level: long distance code
                uint32_t sb_ = (de >> 8) & 15u;
                de = dist_table_[(de >> 16) +
                                 ((uint32_t)b.acc & ((1u << sb_) - 1))];
                if (!de) return -3;
                dw = de & 31;
                b.acc >>= dw; b.nbits -= dw;
            }
            uint32_t dxe = (de >> 8) & 15;
            uint32_t dist = (de >> 16) +
                ((uint32_t)b.acc & ((1u << dxe) - 1));
            b.acc >>= dxe; b.nbits -= dxe;
            if (b.nbits < 0) return -1;
            if (dist > o) return -12;   // distance too far back
            if (o + length > cap) return -8;
            const uint8_t* s = dst + o - dist;
            uint8_t* d = dst + o;
            o += length;
            if (dist >= 8) {
                while (length >= 8) { memcpy(d, s, 8); d += 8; s += 8; length -= 8; }
                while (length--) *d++ = *s++;
            } else {
                while (length--) *d++ = *s++;
            }
        }
    }
    block_end:;
    *bp = b;
    *o_io = o;
    return 0;
}

// ---------------------------------------------------------------------------
// Interleaved two-stream inflate.  The single-stream hot loop is a
// serial dependency chain (table load -> shift -> next index); stepping
// two independent members in lockstep lets the out-of-order core
// overlap their table loads.  Only the common PGZF shape is taken — a
// single final dynamic block per member (first 3 bits == 0b101) — and
// either stream hands over to the resumable decode_huff_block when the
// dual loop's safety margins run out.
// ---------------------------------------------------------------------------
struct DualSt {
    BitIn b;
    uint64_t o;
    int state;                 // 0 running, 1 EOB reached, <0 error code
};

static inline void dual_step(DualSt* s, const uint32_t* lit_t, uint32_t lit_mask,
                             const uint32_t* dist_t, uint32_t dist_mask,
                             uint8_t* dst) {
    BitIn* b = &s->b;
    uint64_t o = s->o;
    uint32_t e = lit_t[(uint32_t)b->acc & lit_mask];
    b->acc >>= (e & 31); b->nbits -= (e & 31);
    RESOLVE2(e, lit_t, *b);
    if ((int32_t)e < 0) {
        dst[o++] = (uint8_t)(e >> 16);
        e = lit_t[(uint32_t)b->acc & lit_mask];
        b->acc >>= (e & 31); b->nbits -= (e & 31);
        RESOLVE2(e, lit_t, *b);
        if ((int32_t)e < 0) {
            dst[o++] = (uint8_t)(e >> 16);
            e = lit_t[(uint32_t)b->acc & lit_mask];
            b->acc >>= (e & 31); b->nbits -= (e & 31);
            RESOLVE2(e, lit_t, *b);
            if ((int32_t)e < 0) { dst[o++] = (uint8_t)(e >> 16); s->o = o; return; }
        }
    }
    if (e & 0x60000000u) {
        s->o = o;
        s->state = (e & 0x40000000u) ? 1 : -10;
        return;
    }
    if (!e) { s->state = -3; return; }
    uint32_t le = (e >> 8) & 15;
    uint32_t length = (e >> 16) + ((uint32_t)b->acc & ((1u << le) - 1));
    b->acc >>= le; b->nbits -= le;
    bi_fill(b);                          // distance code + extras <= 28 bits
    uint32_t de = dist_t[(uint32_t)b->acc & dist_mask];
    b->acc >>= (de & 31); b->nbits -= (de & 31);
    RESOLVE2(de, dist_t, *b);
    if (!de) { s->state = -3; return; }
    uint32_t dxe = (de >> 8) & 15;
    uint32_t dist = (de >> 16) + ((uint32_t)b->acc & ((1u << dxe) - 1));
    b->acc >>= dxe; b->nbits -= dxe;
    if (dist > o) { s->state = -12; return; }
    const uint8_t* src_ = dst + o - dist;
    uint8_t* d = dst + o;
    o += length;
    if (dist >= 8) {
        memcpy(d, src_, 8);
        if (length > 8) {
            d += 8; src_ += 8;
            int64_t rem = (int64_t)length - 8;
            while (rem > 0) { memcpy(d, src_, 8); d += 8; src_ += 8; rem -= 8; }
        }
    } else if (dist == 1) {
        memset(d, *src_, length);
    } else {
        int off = dist; while (off < 8) off += dist;
        uint8_t* dd = d;
        for (int k = 0; k < off; k++) { *dd = dd[-(int)dist]; dd++; }
        const uint8_t* ss = dd - off;
        int64_t rem = (int64_t)length - off;
        while (rem > 0) { memcpy(dd, ss, 8); dd += 8; ss += 8; rem -= 8; }
    }
    s->o = o;
}

// set up one stream of a pair: header + tables.  Returns 0 ok, -100 if
// the member is not a single-final-dynamic-block stream (caller falls
// back to two independent lf_inflate calls), else a parse error.
static int pair_setup(const uint8_t* src, uint64_t n, BitIn* b,
                      uint32_t* lit_table, int* lit_bits,
                      uint32_t* dist_table, int* dist_bits) {
    bi_init(b, src, n, 0);
    int final_ = bi_read(b, 1);
    int btype = bi_read(b, 2);
    if (b->overrun) return -1;
    if (final_ != 1 || btype != 2) return -100;
    int32_t ll[286], dl[30];
    int rc = parse_dyn_header(b, ll, dl);
    if (rc) return rc;
    bool any_dist = false;
    for (int i = 0; i < 30; i++) any_dist |= dl[i] != 0;
    if (!build_table_auto(ll, 286, lit_table, 10, false, lit_bits))
        return -3;
    if (any_dist) {
        if (!build_table_auto(dl, 30, dist_table, 9, true, dist_bits))
            return -3;
    } else {
        *dist_bits = 1;
        memset(dist_table, 0, sizeof(uint32_t) << 1);
    }
    return 0;
}

// errors are tagged: -1000-|rc| for stream A, -2000-|rc| for stream B
int lf_inflate_pair(const uint8_t* sA, uint64_t nA, uint8_t* dA, uint64_t capA,
                    uint64_t* onA,
                    const uint8_t* sB, uint64_t nB, uint8_t* dB, uint64_t capB,
                    uint64_t* onB) {
    static thread_local uint32_t litA[1 << 15], distA[1 << 15];
    static thread_local uint32_t litB[1 << 15], distB[1 << 15];
    int lbA, dbA, lbB, dbB;
    DualSt A, B;
    A.o = 0; A.state = 0; B.o = 0; B.state = 0;
    int rc = pair_setup(sA, nA, &A.b, litA, &lbA, distA, &dbA);
    if (rc == -100) return -100;
    if (rc) return -1000 + rc;
    rc = pair_setup(sB, nB, &B.b, litB, &lbB, distB, &dbB);
    if (rc == -100) return -100;
    if (rc) return -2000 + rc;
    const uint32_t lmA = (1u << lbA) - 1, dmA = (1u << dbA) - 1;
    const uint32_t lmB = (1u << lbB) - 1, dmB = (1u << dbB) - 1;
    while (A.state == 0 && B.state == 0 &&
           A.o + 274 <= capA && A.b.pos + 16 <= A.b.size &&
           B.o + 274 <= capB && B.b.pos + 16 <= B.b.size) {
        bi_fill(&A.b);
        bi_fill(&B.b);
        dual_step(&A, litA, lmA, distA, dmA, dA);
        dual_step(&B, litB, lmB, distB, dmB, dB);
    }
    if (A.state == 0) {
        rc = decode_huff_block(&A.b, litA, lbA, distA, dbA, dA, &A.o, capA);
        A.state = rc < 0 ? rc : 1;
    }
    if (B.state == 0) {
        rc = decode_huff_block(&B.b, litB, lbB, distB, dbB, dB, &B.o, capB);
        B.state = rc < 0 ? rc : 1;
    }
    if (A.state < 0) return -1000 + A.state;
    if (B.state < 0) return -2000 + B.state;
    *onA = A.o; *onB = B.o;
    return 0;
}

// ---------------------------------------------------------------------------
// Shared-table quad-interleaved inflate (PGZF shared mode).
//
// The shared-table PGZF encoder transmits ONE batch-global code set, so
// every member's deflate header is byte-identical.  The pair decoder
// above still builds per-stream tables (2 full sets ≈ 12 KiB is why a
// 4-way interleave measured slower: 24 KiB+ of tables thrashes L1).
// Detecting the shared header lets FOUR streams interleave over a
// single table pair (≈ 6 KiB), hiding more of the per-symbol
// load→shift→index dependency chain in the out-of-order core.
// ---------------------------------------------------------------------------
struct SharedCtx {
    std::unique_ptr<uint32_t[]> lit_table;   // 2^15 each (2-level max)
    std::unique_ptr<uint32_t[]> dist_table;
    int lit_bits = 0, dist_bits = 0;
    uint64_t header_bits = 0;     // BFINAL+BTYPE+dynamic header bit length
    const uint8_t* pattern = nullptr;  // member-0 body (header byte pattern)
    uint64_t full_bytes = 0;      // whole header bytes to compare
    uint8_t last_mask = 0;        // mask for the trailing partial byte
    bool ok = false;
};

static void shared_setup(SharedCtx* sh, const uint8_t* body, uint64_t len) {
    sh->ok = false;
    if (len < 2 || (body[0] & 7) != 5) return;   // BFINAL=1, BTYPE=dynamic
    BitIn b; bi_init(&b, body, len, 0);
    bi_skip(&b, 3);
    int32_t ll[286], dl[30];
    if (parse_dyn_header(&b, ll, dl) != 0) return;
    sh->lit_table.reset(new uint32_t[1 << 15]);
    sh->dist_table.reset(new uint32_t[1 << 15]);
    if (!build_table_auto(ll, 286, sh->lit_table.get(), 10, false,
                          &sh->lit_bits))
        return;
    bool any_dist = false;
    for (int i = 0; i < 30; i++) any_dist |= dl[i] != 0;
    if (any_dist) {
        if (!build_table_auto(dl, 30, sh->dist_table.get(), 9, true,
                              &sh->dist_bits))
            return;
    } else {
        sh->dist_bits = 1;
        memset(sh->dist_table.get(), 0, sizeof(uint32_t) << 1);
    }
    sh->header_bits = bi_bitpos(&b);
    sh->pattern = body;
    sh->full_bytes = sh->header_bits >> 3;
    sh->last_mask = (uint8_t)((1u << (sh->header_bits & 7)) - 1);
    sh->ok = true;
}

static inline bool shared_matches(const SharedCtx& sh, const uint8_t* body,
                                  uint64_t len) {
    if (len <= sh.full_bytes + 1) return false;
    if (memcmp(body, sh.pattern, sh.full_bytes) != 0) return false;
    if (sh.last_mask &&
        ((body[sh.full_bytes] ^ sh.pattern[sh.full_bytes]) & sh.last_mask))
        return false;
    return true;
}

// Decode 4 shared-header streams in lockstep; k-th stream's error is
// returned as -(1000*(k+1)) - |rc|.  Streams hand over to the resumable
// decode_huff_block when the interleaved loop's margins run out.
static int lf_inflate_quad_shared(const SharedCtx& sh,
                                  const uint8_t* const* s,
                                  const uint64_t* n, uint8_t* const* d,
                                  const uint64_t* cap, uint64_t* on) {
    DualSt st[4];
    for (int k = 0; k < 4; k++) {
        bi_init(&st[k].b, s[k], n[k], sh.header_bits);
        st[k].o = 0;
        st[k].state = 0;
    }
    const uint32_t lm = (1u << sh.lit_bits) - 1;
    const uint32_t dm = (1u << sh.dist_bits) - 1;
    const uint32_t* lt = sh.lit_table.get();
    const uint32_t* dt = sh.dist_table.get();
    for (;;) {
        bool go = true;
        for (int k = 0; k < 4; k++)
            go &= st[k].state == 0 && st[k].o + 274 <= cap[k]
                  && st[k].b.pos + 16 <= st[k].b.size;
        if (!go) break;
        bi_fill(&st[0].b); bi_fill(&st[1].b);
        bi_fill(&st[2].b); bi_fill(&st[3].b);
        dual_step(&st[0], lt, lm, dt, dm, d[0]);
        dual_step(&st[1], lt, lm, dt, dm, d[1]);
        dual_step(&st[2], lt, lm, dt, dm, d[2]);
        dual_step(&st[3], lt, lm, dt, dm, d[3]);
    }
    for (int k = 0; k < 4; k++) {
        if (st[k].state == 0) {
            int rc = decode_huff_block(&st[k].b, lt, sh.lit_bits, dt,
                                       sh.dist_bits, d[k], &st[k].o, cap[k]);
            st[k].state = rc < 0 ? rc : 1;
        }
        if (st[k].state < 0) return -1000 * (k + 1) + st[k].state;
        on[k] = st[k].o;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Serial inflate
//   returns: 0 ok; <0 error; sets *out_n, *end_bit
// ---------------------------------------------------------------------------
int lf_inflate(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
               uint64_t* out_n, uint64_t* end_bit) {
    BitIn b; bi_init(&b, src, n, 0);
    uint64_t o = 0;
    static thread_local uint32_t lit_table[1 << 15];
    static thread_local uint32_t dist_table[1 << 15];
    for (;;) {
        int final_ = bi_read(&b, 1);
        int btype = bi_read(&b, 2);
        if (b.overrun) return -1;
        if (btype == 0) {
            bi_align(&b);
            uint32_t len = bi_read(&b, 16);
            uint32_t nlen = bi_read(&b, 16);
            if (b.overrun) return -1;
            if (len != (nlen ^ 0xFFFFu)) return -7;
            if (o + len > cap) return -8;
            // drain acc bytes first
            while (b.nbits >= 8 && len) {
                dst[o++] = (uint8_t)(b.acc & 0xFF); b.acc >>= 8; b.nbits -= 8; len--;
            }
            // the 64-bit refill keeps a read-ahead byte in acc beyond
            // nbits; the bulk copy below moves pos arbitrarily, so that
            // byte would no longer match data[pos] — mask it off
            b.acc &= (1ull << b.nbits) - 1;
            if (b.pos + len > b.size) return -1;
            memcpy(dst + o, b.data + b.pos, len);
            o += len; b.pos += len;
        } else if (btype == 3) {
            return -9;                     // reserved type
        } else {
            bool ok;
            int lit_bits = 15, dist_bits = 15;
            if (btype == 1) {
                int32_t ll[288], dl[30];
                fixed_lit_lengths(ll);
                for (int i = 0; i < 30; i++) dl[i] = 5;
                lit_bits = 9; dist_bits = 5;
                ok = build_table32(ll, 288, lit_table, lit_bits, false)
                  && build_table32(dl, 30, dist_table, dist_bits, true);
            } else {
                int32_t ll[286], dl[30];
                int rc = parse_dyn_header(&b, ll, dl);
                if (rc) return rc;
                bool any_dist = false;
                for (int i = 0; i < 30; i++) any_dist |= dl[i] != 0;
                // two-level root+sub: the root stays L1-resident and a
                // per-member build touches KiBs, not the 2^15 worst case
                ok = build_table_auto(ll, 286, lit_table, 10, false,
                                      &lit_bits);
                if (ok) {
                    if (any_dist)
                        ok = build_table_auto(dl, 30, dist_table, 9, true,
                                              &dist_bits);
                    else {
                        dist_bits = 1;
                        memset(dist_table, 0, sizeof(uint32_t) << 1);
                    }
                }
            }
            if (!ok) return -3;
            int rc2 = decode_huff_block(&b, lit_table, lit_bits,
                                        dist_table, dist_bits, dst, &o, cap);
            if (rc2 < 0) return rc2;
        }
        if (final_) break;
    }
    *out_n = o;
    *end_bit = bi_bitpos(&b);
    return 0;
}

// ---------------------------------------------------------------------------
// Batched dynamic-header parse (for the TPU decode pipeline)
//   bodies: concatenated member payloads; offsets[i]..offsets[i+1] per member
//   outputs: lit_lengths (B*286), dist_lengths (B*30), start_bits (B)
// ---------------------------------------------------------------------------
// lit_lengths stride is 288 (full fixed alphabet incl. symbols 286/287,
// which shift the canonical 9-bit range); dynamic headers fill <= 286.
int lf_parse_dyn_headers(const uint8_t* bodies, const uint64_t* offsets,
                         int32_t batch, int32_t* lit_lengths,
                         int32_t* dist_lengths, int64_t* start_bits,
                         int32_t* flags /* per-member: bfinal|btype<<1 */) {
    for (int32_t i = 0; i < batch; i++) {
        const uint8_t* p = bodies + offsets[i];
        uint64_t len = offsets[i+1] - offsets[i];
        BitIn b; bi_init(&b, p, len, 0);
        int final_ = bi_read(&b, 1);
        int btype = bi_read(&b, 2);
        if (b.overrun) return -(i * 100 + 1);
        flags[i] = final_ | (btype << 1);
        int32_t* lit_row = lit_lengths + (int64_t)i * 288;
        if (btype == 2) {
            lit_row[286] = 0; lit_row[287] = 0;
            int rc = parse_dyn_header(&b, lit_row,
                                      dist_lengths + (int64_t)i * 30);
            if (rc) return -(i * 100 - rc);
        } else if (btype == 1) {
            fixed_lit_lengths(lit_row);
            for (int k = 0; k < 30; k++) dist_lengths[(int64_t)i * 30 + k] = 5;
        } else if (btype == 0) {
            // stored member: caller handles it host-side via flags
        } else {
            return -(i * 100 + 9);
        }
        start_bits[i] = (int64_t)bi_bitpos(&b);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Bit writer
// ---------------------------------------------------------------------------
struct BitOut {
    uint8_t* data;
    uint64_t cap;
    uint64_t pos;
    uint64_t acc;
    int nbits;
    bool overflow;
};

static inline void bo_init(BitOut* b, uint8_t* d, uint64_t cap) {
    b->data = d; b->cap = cap; b->pos = 0; b->acc = 0; b->nbits = 0; b->overflow = false;
}

static inline void bo_write(BitOut* b, uint32_t v, int n) {
    b->acc |= (uint64_t)(v & ((1u << n) - 1)) << b->nbits;
    b->nbits += n;
    if (b->nbits >= 32) {
        // flush 4 bytes with one 8-byte store (callers write <= 15 bits,
        // so nbits stays < 47 and the upper acc bytes are just-in-flight
        // bits that the next flush or bo_align will commit)
        if (b->pos + 8 <= b->cap) {
            memcpy(b->data + b->pos, &b->acc, 8);
            b->pos += 4; b->acc >>= 32; b->nbits -= 32;
        } else {
            while (b->nbits >= 8) {
                if (b->pos >= b->cap) { b->overflow = true; b->nbits = 0; return; }
                b->data[b->pos++] = (uint8_t)(b->acc & 0xFF);
                b->acc >>= 8; b->nbits -= 8;
            }
        }
    }
}

static inline void bo_align(BitOut* b) {
    if (b->nbits & 7) { b->nbits += 8 - (b->nbits & 7); }   // zero pad bits
    while (b->nbits >= 8) {                 // drain every whole byte
        if (b->pos >= b->cap) { b->overflow = true; b->nbits = 0; return; }
        b->data[b->pos++] = (uint8_t)(b->acc & 0xFF);
        b->acc >>= 8; b->nbits -= 8;
    }
}

// ---------------------------------------------------------------------------
// Huffman construction (package-merge) for the native encoder
// ---------------------------------------------------------------------------
struct PmNode { uint64_t w; int count_idx; };

// compute optimal length-limited code lengths; freqs length n <= 288
static void pm_lengths(const uint32_t* freqs, int n, int limit, int32_t* lengths) {
    // active symbols sorted by freq
    int order[288]; int na = 0;
    for (int i = 0; i < n; i++) { lengths[i] = 0; if (freqs[i]) order[na++] = i; }
    if (na == 0) return;
    if (na == 1) { lengths[order[0]] = 1; return; }
    std::sort(order, order + na, [&](int a, int bb) {
        return freqs[a] != freqs[bb] ? freqs[a] < freqs[bb] : a < bb; });
    // levels algorithm (mirrors ops/huffman.py): sorted leaf weights,
    // per-level merged (weight, is_leaf) lists, then selection counting.
    const int S = 2 * 288;
    static thread_local uint64_t items[S];        // current level items
    static thread_local uint64_t leaves[288];
    static thread_local uint8_t leaf_flags[16][S]; // per level
    static thread_local int level_sizes[16];
    for (int i = 0; i < na; i++) leaves[i] = freqs[order[i]];
    int cur_n = na;
    for (int i = 0; i < na; i++) items[i] = leaves[i];
    for (int i = 0; i < cur_n; i++) leaf_flags[0][i] = 1;
    level_sizes[0] = cur_n;
    for (int lev = 1; lev < limit; lev++) {
        // package pairs of current items
        int np = cur_n / 2;
        static thread_local uint64_t pkg[S];
        for (int i = 0; i < np; i++) pkg[i] = items[2*i] + items[2*i+1];
        // merge leaves with packages (stable: leaves first on ties)
        int ia = 0, ip = 0, k = 0;
        static thread_local uint64_t mi[S];
        static thread_local uint8_t mf[S];
        while ((ia < na || ip < np) && k < S) {
            bool take_leaf = ip >= np || (ia < na && leaves[ia] <= pkg[ip]);
            if (take_leaf) { mi[k] = leaves[ia++]; mf[k] = 1; }
            else { mi[k] = pkg[ip++]; mf[k] = 0; }
            k++;
        }
        cur_n = k < 2 * (na - 1) ? k : 2 * (na - 1);
        memcpy(items, mi, cur_n * sizeof(uint64_t));
        memcpy(leaf_flags[lev], mf, cur_n);
        level_sizes[lev] = cur_n;
    }
    // selection: top level = last built
    int m = 2 * (na - 1);
    int cs[16];
    for (int lev = limit - 1; lev >= 0; lev--) {
        int take = m < level_sizes[lev] ? m : level_sizes[lev];
        int c = 0;
        for (int i = 0; i < take; i++) c += leaf_flags[lev][i];
        cs[lev] = c;
        m = 2 * (m - c);
    }
    for (int k = 0; k < na; k++) {
        int L = 0;
        for (int lev = 0; lev < limit; lev++) L += (k < cs[lev]) ? 1 : 0;
        lengths[order[k]] = L;
    }
}

// canonical codes from lengths (reversed for LSB-first emission)
static void canon_codes_rev(const int32_t* lengths, int n, uint16_t* codes) {
    int counts[16] = {0};
    for (int i = 0; i < n; i++) if (lengths[i]) counts[lengths[i]]++;
    int firsts[16]; int code = 0;
    for (int l = 1; l <= 15; l++) { code = (code + counts[l-1]) << 1; firsts[l] = code; }
    int next[16]; memcpy(next, firsts, sizeof(next));
    for (int i = 0; i < n; i++) {
        int l = lengths[i];
        if (!l) { codes[i] = 0; continue; }
        int c = next[l]++;
        int rev = 0;
        for (int k = 0; k < l; k++) { rev = (rev << 1) | (c & 1); c >>= 1; }
        codes[i] = (uint16_t)rev;
    }
}

// length/distance code LUTs for the encoder
static uint16_t len_code_lut[259]; static uint8_t len_nextra_lut[259]; static uint16_t len_extra_lut[259];
static int32_t dist_code_of(uint32_t d) {
    // branchless-ish binary search over DIST_BASE
    int lo = 0, hi = 29;
    while (lo < hi) { int mid = (lo + hi + 1) >> 1; if (DIST_BASE[mid] <= d) lo = mid; else hi = mid - 1; }
    return lo;
}
// two-range distance-code table (zlib d_code scheme): distances 1..256
// index directly, larger ones via (d-1)>>7
static uint8_t dist_code_lut[512];
static inline int dist_code_fast(uint32_t d) {
    return d <= 256 ? dist_code_lut[d - 1] : dist_code_lut[256 + ((d - 1) >> 7)];
}
static bool enc_luts_done = false;
static void enc_luts_init() {
    if (enc_luts_done) return;
    for (int c = 0; c < 29; c++) {
        uint32_t lo = LEN_BASE[c];
        uint32_t hi = c == 28 ? 258 : (uint32_t)(LEN_BASE[c+1] - 1);
        for (uint32_t L = lo; L <= hi && L <= 258; L++) {
            len_code_lut[L] = 257 + c; len_nextra_lut[L] = LEN_EXTRA[c]; len_extra_lut[L] = L - lo;
        }
    }
    len_code_lut[258] = 285; len_nextra_lut[258] = 0; len_extra_lut[258] = 0;
    for (uint32_t d = 1; d <= 256; d++) dist_code_lut[d - 1] = (uint8_t)dist_code_of(d);
    for (uint32_t idx = 2; idx < 256; idx++)
        dist_code_lut[256 + idx] = (uint8_t)dist_code_of((idx << 7) + 1);
    enc_luts_done = true;
}

// ---------------------------------------------------------------------------
// Greedy LZ77 + dynamic-block DEFLATE encoder
// ---------------------------------------------------------------------------
// token buffer entry: literal (b==0) or match
struct Tok { uint16_t a; uint16_t b_lo; uint16_t b_hi; };

static void write_dyn_header(BitOut* bo, const int32_t* lit_l, const int32_t* dist_l) {
    // determine HLIT/HDIST
    int hlit = 257, hdist = 1;
    for (int i = 256; i < 286; i++) if (lit_l[i]) hlit = i + 1;
    for (int i = 0; i < 30; i++) if (dist_l[i]) hdist = i + 1;
    // RLE the combined sequence
    int total = hlit + hdist;
    int32_t seq[316];
    memcpy(seq, lit_l, hlit * sizeof(int32_t));
    memcpy(seq + hlit, dist_l, hdist * sizeof(int32_t));
    // rle symbols: (sym, extra, nbits)
    int rs[316 * 2], re[316 * 2], rn[316 * 2]; int nr = 0;
    int i = 0;
    while (i < total) {
        int v = seq[i]; int run = 1;
        while (i + run < total && seq[i + run] == v) run++;
        i += run;
        if (v == 0) {
            while (run >= 11) { int r = run < 138 ? run : 138; rs[nr]=18; re[nr]=r-11; rn[nr]=7; nr++; run -= r; }
            if (run >= 3) { rs[nr]=17; re[nr]=run-3; rn[nr]=3; nr++; run = 0; }
            while (run--) { rs[nr]=0; re[nr]=0; rn[nr]=0; nr++; }
        } else {
            rs[nr]=v; re[nr]=0; rn[nr]=0; nr++; run--;
            while (run >= 3) { int r = run < 6 ? run : 6; rs[nr]=16; re[nr]=r-3; rn[nr]=2; nr++; run -= r; }
            while (run-- > 0) { rs[nr]=v; re[nr]=0; rn[nr]=0; nr++; }
        }
    }
    uint32_t clc_freq[19] = {0};
    for (int k = 0; k < nr; k++) clc_freq[rs[k]]++;
    int32_t clc_l[19]; pm_lengths(clc_freq, 19, 7, clc_l);
    uint16_t clc_c[19]; canon_codes_rev(clc_l, 19, clc_c);
    int hclen = 4;
    for (int k = 0; k < 19; k++) if (clc_l[CLC_ORDER[k]]) hclen = k + 1;
    bo_write(bo, hlit - 257, 5);
    bo_write(bo, hdist - 1, 5);
    bo_write(bo, hclen - 4, 4);
    for (int k = 0; k < hclen; k++) bo_write(bo, clc_l[CLC_ORDER[k]], 3);
    for (int k = 0; k < nr; k++) {
        bo_write(bo, clc_c[rs[k]], clc_l[rs[k]]);
        if (rn[k]) bo_write(bo, re[k], rn[k]);
    }
}

// encode tokens as one dynamic block
static void emit_block(BitOut* bo, const Tok* toks, int64_t ntok, int bfinal) {
    enc_luts_init();
    uint32_t lit_freq[286] = {0}, dist_freq[30] = {0};
    for (int64_t i = 0; i < ntok; i++) {
        uint32_t d = toks[i].b_lo | ((uint32_t)toks[i].b_hi << 16);
        if (d == 0) lit_freq[toks[i].a]++;
        else { lit_freq[len_code_lut[toks[i].a]]++; dist_freq[dist_code_fast(d)]++; }
    }
    lit_freq[256]++;
    bool any_dist = false;
    for (int i = 0; i < 30; i++) any_dist |= dist_freq[i] != 0;
    if (!any_dist) dist_freq[0] = 1;       // a dummy distance code, as serial deflate
    int32_t lit_l[286], dist_l[30];
    // cap code lengths at 12: decode tables stay <= 4096 entries (8 KiB,
    // L1-resident) and match the device shared-table root width; the
    // ratio cost vs limit-15 is < 0.1%
    pm_lengths(lit_freq, 286, 12, lit_l);
    pm_lengths(dist_freq, 30, 12, dist_l);
    uint16_t lit_c[286], dist_c[30];
    canon_codes_rev(lit_l, 286, lit_c);
    canon_codes_rev(dist_l, 30, dist_c);
    bo_write(bo, bfinal, 1);
    bo_write(bo, 2, 2);
    write_dyn_header(bo, lit_l, dist_l);
    for (int64_t i = 0; i < ntok; i++) {
        uint32_t d = toks[i].b_lo | ((uint32_t)toks[i].b_hi << 16);
        if (d == 0) {
            bo_write(bo, lit_c[toks[i].a], lit_l[toks[i].a]);
        } else {
            int lc = len_code_lut[toks[i].a];
            bo_write(bo, lit_c[lc], lit_l[lc]);
            if (len_nextra_lut[toks[i].a]) bo_write(bo, len_extra_lut[toks[i].a], len_nextra_lut[toks[i].a]);
            int dc = dist_code_fast(d);
            bo_write(bo, dist_c[dc], dist_l[dc]);
            if (DIST_EXTRA[dc]) bo_write(bo, d - DIST_BASE[dc], DIST_EXTRA[dc]);
        }
    }
    bo_write(bo, lit_c[256], lit_l[256]);
}

// greedy matcher (parity with the reference's single-slot strategy:
// libflate_lz77/src/default.rs — most-recent previous 3-byte prefix)
// matcher core: greedy or one-step-lazy parse (lazy defers a match when
// the next position holds a longer one — zlib-style, better ratio than
// the reference's pure greedy at ~25% extra scan cost)
int lf_deflate3(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                uint64_t* out_n, uint64_t block_size, int final_marker,
                int lazy, int max_chain) {
    enc_luts_init();
    BitOut bo; bo_init(&bo, dst, cap);
    const int HB = 16;                      // 64K buckets over the 3-byte hash
    // epoch-stamped heads packed as (epoch<<32)|pos in ONE array: a
    // single random cache access per input byte instead of two
    static thread_local uint64_t head2[1 << 16];
    // hash-chain ring: back-link per position (valid within the window)
    static thread_local uint32_t chain_ring[1 << 15];
    static thread_local uint32_t cur_epoch = 0;
    // the token buffer dies with its thread: the batch encoders start new
    // threads on every call, and a bare pointer here leaked one buffer a
    // thread a call (the reference's copy still does)
    static thread_local std::unique_ptr<Tok[]> toks_buf;
    static thread_local uint64_t toks_cap = 0;
    if (toks_cap < block_size + 1) {
        toks_cap = block_size + 1;
        toks_buf.reset(new (std::nothrow) Tok[toks_cap]);
        if (!toks_buf) { toks_cap = 0; return -100; }
    }
    Tok* toks = toks_buf.get();
    uint64_t pos = 0;
    bool first = true;
    while (first || pos < n) {
        first = false;
        uint64_t bstart = pos;
        uint64_t bend = pos + block_size < n ? pos + block_size : n;
        if (++cur_epoch == 0) {             // u32 wrap: hard reset once
            memset(head2, 0, sizeof(head2));
            cur_epoch = 1;
        }
        int64_t ntok = 0;
        uint64_t i = pos;
        // zlib-style search cutoffs: stop the chain once a match reaches
        // `nice`, quarter the remaining chain budget once one reaches
        // `good` (cf. zlib deflate.c configuration_table, level 6)
        const uint32_t nice_len = max_chain >= 64 ? 128 : 32;
        const uint32_t good_len = 8;
        auto probe_insert = [&](uint64_t at, uint32_t* dist,
                                bool search) -> uint32_t {
            if (at + 3 > bend) return 0;
            // single 4-byte load (callers guarantee a sentinel byte at
            // src[n]); the mask keeps exactly the 3-byte prefix
            uint32_t w4; memcpy(&w4, src + at, 4);
            uint32_t h = ((w4 & 0xFFFFFFu) * 2654435761u) >> (32 - HB);
            uint64_t slot = head2[h];
            int64_t cand = (uint32_t)(slot >> 32) == cur_epoch
                           ? (int64_t)(uint32_t)slot : -1;
            head2[h] = ((uint64_t)cur_epoch << 32) | (uint32_t)at;
            chain_ring[at & 32767] = cand >= 0 ? (uint32_t)cand : 0xFFFFFFFFu;
            if (!search) return 0;
            uint64_t maxl = bend - at < 258 ? bend - at : 258;
            uint32_t best_len = 0, best_dist = 0;
            int chain_left = max_chain > 0 ? max_chain : 1;
            bool reduced = false;
            while (cand >= (int64_t)bstart && at - cand <= 32768 && chain_left--) {
                // cheap reject: candidate must beat best_len
                if (best_len == 0 ||
                    src[cand + best_len] == src[at + best_len]) {
                    if (src[cand] == src[at] && src[cand+1] == src[at+1]
                        && src[cand+2] == src[at+2]) {
                        // word-wise extension: L+8 <= maxl keeps every
                        // 8-byte load inside [0, bend) on both sides
                        uint64_t L = 3;
                        while (L + 8 <= maxl) {
                            uint64_t a8, c8;
                            memcpy(&c8, src + cand + L, 8);
                            memcpy(&a8, src + at + L, 8);
                            uint64_t x = a8 ^ c8;
                            if (x) { L += (uint64_t)__builtin_ctzll(x) >> 3; goto extended; }
                            L += 8;
                        }
                        while (L < maxl && src[cand + L] == src[at + L]) L++;
                    extended:
                        if (L > best_len) {
                            best_len = (uint32_t)L;
                            best_dist = (uint32_t)(at - cand);
                            if (L >= maxl || L >= nice_len) break;
                            if (L >= good_len && !reduced) {
                                chain_left >>= 2; reduced = true;
                            }
                        }
                    }
                }
                uint32_t nxt = chain_ring[cand & 32767];
                if (nxt == 0xFFFFFFFFu || nxt >= (uint32_t)cand) break;
                cand = nxt;
            }
            if (best_len < 3) return 0;
            // zlib TOO_FAR: a length-3 match beyond 4 KiB codes longer
            // than the three literals it replaces
            if (best_len == 3 && best_dist > 4096) return 0;
            *dist = best_dist;
            return best_len;
        };
        auto reindex = [&](uint64_t from, uint64_t to) {
            uint64_t stop = to < bend - 2 ? to : (bend >= 2 ? bend - 2 : 0);
            for (uint64_t j = from; j < stop; j++) {
                uint32_t w4; memcpy(&w4, src + j, 4);
                uint32_t h2 = ((w4 & 0xFFFFFFu) * 2654435761u) >> (32 - HB);
                uint64_t slot2 = head2[h2];
                chain_ring[j & 32767] =
                    (uint32_t)(slot2 >> 32) == cur_epoch
                    ? (uint32_t)slot2 : 0xFFFFFFFFu;
                head2[h2] = ((uint64_t)cur_epoch << 32) | (uint32_t)j;
            }
        };
        if (!lazy) {
            while (i < bend) {
                uint32_t d = 0;
                uint32_t L = probe_insert(i, &d, true);
                if (L >= 3) {
                    toks[ntok].a = (uint16_t)L; toks[ntok].b_lo = d & 0xFFFF; toks[ntok].b_hi = d >> 16;
                    ntok++;
                    reindex(i + 1, i + L);
                    i += L;
                } else {
                    if (i + 3 > bend) { /* tail literal */ }
                    toks[ntok].a = src[i]; toks[ntok].b_lo = 0; toks[ntok].b_hi = 0; ntok++; i++;
                }
            }
        } else {
            // one-step lazy evaluation
            uint32_t pend_len = 0, pend_dist = 0;
            bool have_pending = false;       // position i-1 not yet emitted
            // zlib max_lazy: a pending match this long is accepted without
            // searching the current position (insert-only probe)
            const uint32_t max_lazy_len = 16;
            while (i < bend) {
                uint32_t d = 0;
                uint32_t L = probe_insert(i, &d,
                    !(have_pending && pend_len >= max_lazy_len));
                if (have_pending && pend_len >= 3 && pend_len >= L) {
                    // previous position's match wins
                    toks[ntok].a = (uint16_t)pend_len;
                    toks[ntok].b_lo = pend_dist & 0xFFFF;
                    toks[ntok].b_hi = pend_dist >> 16;
                    ntok++;
                    uint64_t end_m = i - 1 + pend_len;
                    reindex(i + 1, end_m);
                    i = end_m;
                    have_pending = false;
                    pend_len = 0;
                    continue;
                }
                if (have_pending) {
                    toks[ntok].a = src[i - 1]; toks[ntok].b_lo = 0; toks[ntok].b_hi = 0; ntok++;
                }
                pend_len = L; pend_dist = d; have_pending = true;
                i++;
            }
            if (have_pending) {
                if (pend_len >= 3 && (i - 1 + pend_len) <= bend) {
                    toks[ntok].a = (uint16_t)pend_len;
                    toks[ntok].b_lo = pend_dist & 0xFFFF;
                    toks[ntok].b_hi = pend_dist >> 16;
                    ntok++;
                } else {
                    toks[ntok].a = src[i - 1]; toks[ntok].b_lo = 0; toks[ntok].b_hi = 0; ntok++;
                }
            }
        }
        int bfinal = (bend >= n && final_marker) ? 1 : 0;
        emit_block(&bo, toks, ntok, bfinal);
        if (bo.overflow) return -8;
        pos = bend;
    }
    bo_align(&bo);
    if (bo.overflow) return -8;
    *out_n = bo.pos;
    return 0;
}

int lf_deflate_greedy(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                      uint64_t* out_n, uint64_t block_size, int final_marker) {
    return lf_deflate3(src, n, dst, cap, out_n, block_size, final_marker, 0, 1);
}

int lf_deflate_greedy2(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                       uint64_t* out_n, uint64_t block_size, int final_marker,
                       int lazy) {
    return lf_deflate3(src, n, dst, cap, out_n, block_size, final_marker, lazy, 1);
}

// ---------------------------------------------------------------------------
// Multithreaded member-parallel codec (the host runtime's scale-out path:
// gzip members are embarrassingly parallel — SURVEY.md §2.3.2 — so the
// native engine fans them out over a small thread pool)
// ---------------------------------------------------------------------------

// decode `batch` independent DEFLATE bodies into preallocated slots.
// out_offsets[i]..out_offsets[i+1] is member i's expected output extent;
// a member failing to decode or mismatching its size aborts with its index.
int lf_inflate_batch_at(const uint8_t* base, const uint64_t* starts,
                        const uint64_t* ends, int32_t batch, uint8_t* out,
                        const uint64_t* out_offsets, uint32_t* crcs,
                        int32_t n_threads);

int lf_inflate_batch(const uint8_t* bodies, const uint64_t* offsets,
                     int32_t batch, uint8_t* out,
                     const uint64_t* out_offsets, uint32_t* crcs,
                     int32_t n_threads) {
    // contiguous layout is the scattered layout with starts = offsets[i],
    // ends = offsets[i+1]; share the pair-capable worker
    return lf_inflate_batch_at(bodies, offsets, offsets + 1, batch, out,
                               out_offsets, crcs, n_threads);
}


// walk a PGZF stream's LF index entirely in C (the Python walk costs
// ~2 ms per 256 members): emits body [start,end) plus the trailer CRC
// and ISIZE per member.  Returns the member count, or <0 if any member
// is malformed or lacks the index subfield (caller falls back to the
// generic Python header parser).  Layout per RFC 1952 §2.3 and the
// PGZF EXTRA subfield "LF" (u32 total member length), cf. docs/PGZF.md.
int64_t lf_pgzf_index(const uint8_t* d, uint64_t n, uint64_t* body_start,
                      uint64_t* body_end, uint32_t* crcs, uint64_t* isizes,
                      int64_t max_members) {
    uint64_t pos = 0;
    int64_t count = 0;
    while (pos < n) {
        if (count >= max_members) return -2;
        if (pos + 18 > n) return -1;           // header + trailer minimum
        if (d[pos] != 0x1F || d[pos+1] != 0x8B || d[pos+2] != 8) return -1;
        uint8_t flg = d[pos+3];
        uint64_t p = pos + 10;
        uint64_t member_size = 0;
        if (flg & 4) {                          // FEXTRA
            if (p + 2 > n) return -1;
            uint64_t xlen = d[p] | ((uint64_t)d[p+1] << 8);
            p += 2;
            uint64_t xend = p + xlen;
            if (xend > n) return -1;
            while (p + 4 <= xend) {
                uint8_t id0 = d[p], id1 = d[p+1];
                uint64_t sl = d[p+2] | ((uint64_t)d[p+3] << 8);
                p += 4;
                if (p + sl > xend) return -1;
                if (id0 == 'L' && id1 == 'F' && sl == 4) {
                    member_size = (uint64_t)d[p] | ((uint64_t)d[p+1] << 8)
                                | ((uint64_t)d[p+2] << 16)
                                | ((uint64_t)d[p+3] << 24);
                }
                p += sl;
            }
            p = xend;
        }
        if (flg & 8) { while (p < n && d[p]) p++; if (p >= n) return -1; p++; }
        if (flg & 16) { while (p < n && d[p]) p++; if (p >= n) return -1; p++; }
        if (flg & 2) p += 2;                    // FHCRC
        if (member_size == 0) return -1;        // no LF index subfield
        if (pos + member_size > n || pos + member_size < p + 8) return -1;
        body_start[count] = p;
        body_end[count] = pos + member_size - 8;
        const uint8_t* t = d + pos + member_size - 8;
        crcs[count] = (uint32_t)t[0] | ((uint32_t)t[1] << 8)
                    | ((uint32_t)t[2] << 16) | ((uint32_t)t[3] << 24);
        isizes[count] = (uint64_t)t[4] | ((uint64_t)t[5] << 8)
                      | ((uint64_t)t[6] << 16) | ((uint64_t)t[7] << 24);
        count++;
        pos += member_size;
    }
    return count;
}

// member-parallel inflate with scattered bodies: member i occupies
// base[starts[i] .. ends[i]) — no host-side join/copy of the payloads
int lf_inflate_batch_at(const uint8_t* base, const uint64_t* starts,
                        const uint64_t* ends, int32_t batch, uint8_t* out,
                        const uint64_t* out_offsets, uint32_t* crcs,
                        int32_t n_threads) {
    crc_init();
    std::atomic<int32_t> next{0};
    std::atomic<int32_t> bad{-1};
    // shared-table detection: one table pair serves a 4-way interleave
    // when members transmit the byte-identical PGZF shared header
    SharedCtx shared;
    if (batch >= 4 && ends[0] > starts[0] && !getenv("LF_NO_QUAD"))
        shared_setup(&shared, base + starts[0], ends[0] - starts[0]);
    auto one = [&](int32_t i) -> bool {
        uint64_t body_len = ends[i] - starts[i];
        uint64_t cap = out_offsets[i + 1] - out_offsets[i];
        uint64_t on = 0, eb = 0;
        int rc = lf_inflate(base + starts[i], body_len,
                            out + out_offsets[i], cap, &on, &eb);
        if (rc != 0 || on != cap) { bad.store(i); return false; }
        if (crcs) crcs[i] = lf_crc32(out + out_offsets[i], on, 0);
        return true;
    };
    // pair-or-single fallback for members i, i+1 (bounds-checked)
    auto two = [&](int32_t i) -> bool {
        if (i + 1 < batch) {
            // interleaved pair path when both members have the
            // single-final-dynamic-block shape (first 3 bits 0b101)
            uint64_t lenA = ends[i] - starts[i];
            uint64_t lenB = ends[i+1] - starts[i+1];
            if (lenA > 0 && lenB > 0 &&
                (base[starts[i]] & 7) == 5 && (base[starts[i+1]] & 7) == 5) {
                uint64_t capA = out_offsets[i + 1] - out_offsets[i];
                uint64_t capB = out_offsets[i + 2] - out_offsets[i + 1];
                uint64_t onA = 0, onB = 0;
                int rc = lf_inflate_pair(
                    base + starts[i], lenA, out + out_offsets[i], capA, &onA,
                    base + starts[i+1], lenB, out + out_offsets[i+1], capB, &onB);
                if (rc == 0) {
                    if (onA != capA) { bad.store(i); return false; }
                    if (onB != capB) { bad.store(i + 1); return false; }
                    if (crcs) {
                        crcs[i] = lf_crc32(out + out_offsets[i], onA, 0);
                        crcs[i+1] = lf_crc32(out + out_offsets[i+1], onB, 0);
                    }
                    return true;
                }
                if (rc <= -2000) { bad.store(i + 1); return false; }
                if (rc <= -1000) { bad.store(i); return false; }
                // rc == -100: shape mismatch — decode singly below
            }
            return one(i) && one(i + 1);
        }
        return one(i);
    };
    const int step = shared.ok ? 4 : 2;
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(step);
            if (i >= batch || bad.load() >= 0) return;
            if (step == 4) {
                bool quad = i + 3 < batch;
                for (int k = 0; quad && k < 4; k++)
                    quad = shared_matches(shared, base + starts[i + k],
                                          ends[i + k] - starts[i + k]);
                if (quad) {
                    const uint8_t* s[4]; uint64_t n[4]; uint8_t* d[4];
                    uint64_t cap[4]; uint64_t on[4];
                    for (int k = 0; k < 4; k++) {
                        s[k] = base + starts[i + k];
                        n[k] = ends[i + k] - starts[i + k];
                        d[k] = out + out_offsets[i + k];
                        cap[k] = out_offsets[i + k + 1] - out_offsets[i + k];
                    }
                    int rc = lf_inflate_quad_shared(shared, s, n, d, cap, on);
                    if (rc != 0) { bad.store(i + (-rc / 1000) - 1); return; }
                    bool sized_ok = true;
                    for (int k = 0; k < 4; k++)
                        if (on[k] != cap[k]) { bad.store(i + k); sized_ok = false; break; }
                    if (!sized_ok) return;
                    if (crcs)
                        for (int k = 0; k < 4; k++)
                            crcs[i + k] = lf_crc32(d[k], on[k], 0);
                    continue;
                }
                if (!two(i)) return;
                if (i + 2 < batch && !two(i + 2)) return;
            } else {
                if (!two(i)) return;
            }
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return bad.load() >= 0 ? -(bad.load() + 1) : 0;
}

// encode `batch` chunks of `data` as independent DEFLATE streams.
// Each member i gets the slot dst[i*stride .. (i+1)*stride); emits its
// compressed size in out_sizes[i] and the chunk CRC in crcs[i].
int lf_deflate_batch(const uint8_t* data, const uint64_t* chunk_offsets,
                     int32_t batch, uint8_t* dst, uint64_t stride,
                     uint64_t* out_sizes, uint32_t* crcs,
                     uint64_t block_size, int32_t n_threads, int32_t lazy,
                     int32_t max_chain) {
    crc_init();
    enc_luts_init();                   // single-threaded LUT init
    std::atomic<int32_t> next{0};
    std::atomic<int32_t> bad{-1};
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= batch || bad.load() >= 0) return;
            uint64_t n = chunk_offsets[i + 1] - chunk_offsets[i];
            uint64_t on = 0;
            int rc = lf_deflate3(data + chunk_offsets[i], n,
                                 dst + (uint64_t)i * stride, stride,
                                 &on, block_size, 1, lazy, max_chain);
            if (rc != 0) { bad.store(i); return; }
            out_sizes[i] = on;
            if (crcs) crcs[i] = lf_crc32(data + chunk_offsets[i], n, 0);
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return bad.load() >= 0 ? -(bad.load() + 1) : 0;
}

// expand decoded LZ77 token batches (device decode's final stage: the
// overlapping-copy expansion is memcpy-speed on the host).
// a/b: (batch, stride) int32 token arrays (b==0 literal, else distance),
// counts: tokens per member; out slots at out_offsets; crcs optional.
// packed: when nonzero, `a` holds packed tokens (a | b<<9) and `b` is
// ignored — halves the device->host transfer feeding this stage.
// The token decoders' return code for input that ends inside the
// stream (the reference's copy returns -1 there).
#define LF_TRUNCATED (-13)

// ---------------------------------------------------------------------------
// Token-emitting inflate (FOREIGN-stream device-decode bridge).
// Decodes a full member body — any conformant mix of stored / fixed /
// per-member dynamic blocks, i.e. streams whose tables can NOT ride the
// shared-table TPU kernels — into packed LZ77 tokens
// (lit, or len | dist << 9; ops/device_expand packing) WITHOUT
// materializing output bytes.  The host does only the sequential
// entropy phase; expansion + CRC run in the device chain
// (formats/pgzf._foreign_to_device).
//
// Return codes: 0 ok; -2 .. -12 a malformed stream (-8: more tokens than
// the caller's budget); LF_TRUNCATED: the input ended inside the stream.
// Only these two decoders report LF_TRUNCATED: lf_inflate and the batch
// decoders keep -1 for a cut stream.
// ---------------------------------------------------------------------------
static int inflate_tokens_one(const uint8_t* src, uint64_t n,
                              int32_t* toks, int64_t tcap,
                              int64_t* tn_out, uint64_t* osize_out,
                              uint64_t* end_bit = nullptr) {
    BitIn b; bi_init(&b, src, n, 0);
    uint64_t o = 0;                    // decoded byte count (validation)
    int64_t t = 0;
    static thread_local uint32_t lit_table[1 << 15];
    static thread_local uint32_t dist_table[1 << 15];
    for (;;) {
        int final_ = bi_read(&b, 1);
        int btype = bi_read(&b, 2);
        if (b.overrun) return LF_TRUNCATED;
        if (btype == 0) {
            bi_align(&b);
            uint32_t len = bi_read(&b, 16);
            uint32_t nlen = bi_read(&b, 16);
            if (b.overrun) return LF_TRUNCATED;
            if (len != (nlen ^ 0xFFFFu)) return -7;
            if (t + (int64_t)len > tcap) return -8;
            while (b.nbits >= 8 && len) {
                toks[t++] = (int32_t)(b.acc & 0xFF);
                b.acc >>= 8; b.nbits -= 8; len--; o++;
            }
            b.acc &= (1ull << b.nbits) - 1;
            if (b.pos + len > b.size) return LF_TRUNCATED;
            for (uint32_t k = 0; k < len; k++)
                toks[t++] = (int32_t)b.data[b.pos + k];
            o += len; b.pos += len;
        } else if (btype == 3) {
            return -9;
        } else {
            bool ok;
            int lit_bits = 15, dist_bits = 15;
            if (btype == 1) {
                int32_t ll[288], dl[30];
                fixed_lit_lengths(ll);
                for (int i = 0; i < 30; i++) dl[i] = 5;
                lit_bits = 9; dist_bits = 5;
                ok = build_table32(ll, 288, lit_table, lit_bits, false)
                  && build_table32(dl, 30, dist_table, dist_bits, true);
            } else {
                int32_t ll[286], dl[30];
                int rc = parse_dyn_header(&b, ll, dl);
                if (rc == -1) return LF_TRUNCATED;   // header overrun
                if (rc) return rc;
                bool any_dist = false;
                for (int i = 0; i < 30; i++) any_dist |= dl[i] != 0;
                ok = build_table_auto(ll, 286, lit_table, 10, false,
                                      &lit_bits);
                if (ok) {
                    if (any_dist)
                        ok = build_table_auto(dl, 30, dist_table, 9, true,
                                              &dist_bits);
                    else {
                        dist_bits = 1;
                        memset(dist_table, 0, sizeof(uint32_t) << 1);
                    }
                }
            }
            if (!ok) return -3;
            const uint32_t lit_mask = (1u << lit_bits) - 1;
            const uint32_t dist_mask = (1u << dist_bits) - 1;
            for (;;) {
                bi_fill(&b);
                uint32_t e = lit_table[(uint32_t)b.acc & lit_mask];
                if (!e) return b.nbits < lit_bits ? LF_TRUNCATED : -3;
                int w = e & 31;
                if (b.nbits < w) return LF_TRUNCATED;
                b.acc >>= w; b.nbits -= w;
                if (e & 0x20u) {       // two-level: long literal code
                    uint32_t sb_ = (e >> 8) & 15u;
                    e = lit_table[(e >> 16) +
                                  ((uint32_t)b.acc & ((1u << sb_) - 1))];
                    if (!e) return -3;
                    w = e & 31;
                    if (b.nbits < w) return LF_TRUNCATED;
                    b.acc >>= w; b.nbits -= w;
                }
                if ((int32_t)e < 0) {
                    if (t >= tcap) return -8;
                    toks[t++] = (int32_t)((e >> 16) & 0xFF); o++;
                } else if (e & 0x40000000u) {
                    break;             // end of block
                } else if (e & 0x20000000u) {
                    return -10;
                } else {
                    uint32_t le = (e >> 8) & 15;
                    uint32_t length = (e >> 16) +
                        ((uint32_t)b.acc & ((1u << le) - 1));
                    b.acc >>= le; b.nbits -= le;
                    uint32_t de = dist_table[(uint32_t)b.acc & dist_mask];
                    if (!de) return b.nbits < dist_bits ? LF_TRUNCATED : -3;
                    int dw = de & 31;
                    b.acc >>= dw; b.nbits -= dw;
                    if (de & 0x20u) {  // two-level: long distance code
                        uint32_t sb_ = (de >> 8) & 15u;
                        de = dist_table[(de >> 16) +
                                        ((uint32_t)b.acc
                                         & ((1u << sb_) - 1))];
                        if (!de) return -3;
                        dw = de & 31;
                        b.acc >>= dw; b.nbits -= dw;
                    }
                    uint32_t dxe = (de >> 8) & 15;
                    uint32_t dist = (de >> 16) +
                        ((uint32_t)b.acc & ((1u << dxe) - 1));
                    b.acc >>= dxe; b.nbits -= dxe;
                    if (b.nbits < 0) return LF_TRUNCATED;
                    if (dist > o) return -12;
                    if (t >= tcap) return -8;
                    toks[t++] = (int32_t)(length | (dist << 9));
                    o += length;
                }
            }
        }
        if (final_) break;
    }
    *tn_out = t;
    *osize_out = o;
    if (end_bit) *end_bit = bi_bitpos(&b);
    return 0;
}

// Single-member token decode reporting the end bit — the foreign
// multi-member walk discovers each member's extent from it (no LF
// index on foreign streams).
int lf_inflate_tokens(const uint8_t* src, uint64_t n, int32_t* toks,
                      int64_t tcap, int64_t* tn_out,
                      uint64_t* osize_out, uint64_t* end_bit) {
    return inflate_tokens_one(src, n, toks, tcap, tn_out, osize_out,
                              end_bit);
}

int lf_inflate_tokens_batch(const uint8_t* base, const uint64_t* starts,
                            const uint64_t* ends, int32_t batch,
                            int32_t* toks, int64_t tstride,
                            int64_t* tn, uint64_t* osz,
                            int32_t n_threads) {
    std::atomic<int32_t> next{0};
    std::atomic<int32_t> bad{-1};
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= batch || bad.load() >= 0) return;
            int rc = inflate_tokens_one(
                base + starts[i], ends[i] - starts[i],
                toks + (int64_t)i * tstride, tstride, &tn[i], &osz[i]);
            if (rc != 0) { bad.store(i); return; }
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return bad.load() >= 0 ? -(bad.load() + 1) : 0;
}

int lf_expand_batch(const int32_t* a, const int32_t* b, int64_t stride,
                    const int64_t* counts, int32_t batch, uint8_t* out,
                    const uint64_t* out_offsets, uint32_t* crcs,
                    int32_t n_threads, int32_t packed) {
    crc_init();
    std::atomic<int32_t> next{0};
    std::atomic<int32_t> bad{-1};
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= batch || bad.load() >= 0) return;
            const int32_t* ai = a + (int64_t)i * stride;
            const int32_t* bi = packed ? nullptr : b + (int64_t)i * stride;
            uint8_t* dst = out + out_offsets[i];
            uint64_t cap = out_offsets[i + 1] - out_offsets[i];
            uint64_t o = 0;
            int64_t n = counts[i];
            for (int64_t t = 0; t < n; t++) {
                int32_t av = packed ? (ai[t] & 0x1FF) : ai[t];
                int32_t bb = packed ? ((ai[t] >> 9) & 0xFFFF) : bi[t];
                if (bb == 0) {
                    if (o >= cap) { bad.store(i); return; }
                    dst[o++] = (uint8_t)av;
                } else {
                    uint32_t len = (uint32_t)av;
                    if ((uint64_t)bb > o || o + len > cap) {
                        bad.store(i); return;
                    }
                    const uint8_t* s = dst + o - bb;
                    uint8_t* d = dst + o;
                    o += len;
                    if (bb >= 8) {
                        while (len >= 8) { memcpy(d, s, 8); d += 8; s += 8; len -= 8; }
                        while (len--) *d++ = *s++;
                    } else {
                        while (len--) *d++ = *s++;
                    }
                }
            }
            if (o != cap) { bad.store(i); return; }
            if (crcs) crcs[i] = lf_crc32(dst, o, 0);
        }
    };
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return bad.load() >= 0 ? -(bad.load() + 1) : 0;
}

// ---------------------------------------------------------------------------
// Bit splice: shift many bit-streams to packed concatenation
// ---------------------------------------------------------------------------
// words: B rows of W uint32; bits[i] = meaningful bit count of row i
int lf_splice(const uint32_t* words, int64_t b, int64_t w,
              const int64_t* bits, uint8_t* dst, uint64_t cap,
              uint64_t* out_bits) {
    uint64_t offset = 0;
    memset(dst, 0, cap);
    for (int64_t blk = 0; blk < b; blk++) {
        int64_t nb = bits[blk];
        const uint32_t* row = words + blk * w;
        int64_t nw = (nb + 31) / 32;
        uint64_t word0 = offset >> 5;
        int sh = (int)(offset & 31);
        if (((offset + nb + 7) >> 3) + 8 > cap) return -8;
        uint32_t* out32 = (uint32_t*)dst;
        for (int64_t k = 0; k < nw; k++) {
            uint64_t v = row[k];
            if (k == nw - 1) {
                int tail = (int)(nb & 31);
                if (tail) v &= (1ull << tail) - 1;
            }
            uint64_t shifted = v << sh;
            out32[word0 + k] |= (uint32_t)(shifted & 0xFFFFFFFFu);
            out32[word0 + k + 1] |= (uint32_t)(shifted >> 32);
        }
        offset += (uint64_t)nb;
    }
    *out_bits = offset;
    return 0;
}

}  // extern "C"
