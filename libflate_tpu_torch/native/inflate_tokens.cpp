// Token-emitting inflate for the foreign-stream device decode.
//
// A port-owned copy of the reference host engine's token decode
// (libflate_tpu/native/libflate_native.cpp: the bit reader, the
// length/distance tables, the table builders and dynamic-header parser,
// inflate_tokens_one, lf_inflate_tokens and lf_inflate_tokens_batch),
// and nothing else of that file.  Members whose per-member tables cannot
// ride the shared-table kernels (stdlib gzip, pigz, stored blocks) are
// entropy-decoded here on the host into packed LZ77 tokens, lit or
// len | dist << 9; the expansion and the CRC run on the device
// (libflate_tpu_torch/formats/pgzf._foreign_to_device).
//
// Plain C ABI, loaded with ctypes by libflate_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

extern "C" {

// Return codes of the decoders below: 0 ok; -2 .. -12 a malformed stream
// (-8: more tokens than the caller's budget); LF_TRUNCATED: the input
// ended inside the stream.
#define LF_TRUNCATED (-13)


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
    if (b->overrun) return LF_TRUNCATED;
    if (hlit > 286) return -2;            // "HLIT too big" (5-bit field reaches 288)
    if (hdist > 30) return -2;            // "HDIST too big"
    int32_t clc[19] = {0};
    for (int k = 0; k < hclen; k++) clc[CLC_ORDER[k]] = bi_read(b, 3);
    if (b->overrun) return LF_TRUNCATED;
    uint16_t clc_table[1 << 7];
    if (!build_table(clc, 19, clc_table, 7)) return -3;
    int total = hlit + hdist;
    int32_t tmp[286 + 30];
    int i = 0;
    while (i < total) {
        uint16_t e = clc_table[bi_peek(b, 7)];
        if (!e) return -3;
        bi_skip(b, e & 15);
        if (b->overrun) return LF_TRUNCATED;
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
        if (b->overrun) return LF_TRUNCATED;
    }
    memset(lit_l, 0, 286 * sizeof(int32_t));
    memset(dist_l, 0, 30 * sizeof(int32_t));
    memcpy(lit_l, tmp, hlit * sizeof(int32_t));
    memcpy(dist_l, tmp + hlit, hdist * sizeof(int32_t));
    if (!lit_l[256]) return -6;           // EOB has no code
    return 0;
}


// ---------------------------------------------------------------------------
// Token-emitting inflate (FOREIGN-stream device-decode bridge).
// Decodes a full member body — any conformant mix of stored / fixed /
// per-member dynamic blocks, i.e. streams whose tables can NOT ride the
// shared-table device kernels — into packed LZ77 tokens
// (lit, or len | dist << 9; ops/device_expand packing) WITHOUT
// materializing output bytes.  The host does only the sequential
// entropy phase; expansion + CRC run in the device chain
// (formats/pgzf._foreign_to_device).
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

}  // extern "C"
