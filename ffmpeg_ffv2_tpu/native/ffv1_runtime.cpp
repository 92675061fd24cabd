// ffv1_runtime.cpp — C++17 host runtime for the FFV1 codec.
//
// This is the host-side production path of the ffmpeg_ffv2_tpu framework:
// a complete FFV1 frame encoder/decoder (versions 0-4, range + Golomb-Rice
// coding, slice CRCs, PCM fallback, damaged-slice concealment) with a
// std::thread slice pool, exposed through a small C ABI consumed via
// ctypes.  Bitstream semantics follow RFC 9043 / the reference
// implementation (libavcodec/ffv1*.c); the code itself is organized for
// this framework: a single templated line codec, explicit SliceTask
// objects, byte buffers instead of pointer arithmetic.
//
// The scalar Python oracle (ffv1/codec_py.py) validates this file; the
// device kernels (ffv1/tpu.py) are validated against both.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <array>
#include <memory>
#include <thread>
#include <atomic>
#include <algorithm>
#include <cmath>

namespace f2t {

// ---------------------------------------------------------------------------
// CRC-32/IEEE (slice + extradata trailers); table form matches libavutil.
// ---------------------------------------------------------------------------

struct Crc32 {
    uint32_t tab[256];
    Crc32() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i << 24;
            for (int j = 0; j < 8; j++)
                c = (c << 1) ^ (0x04C11DB7u & (uint32_t)(-(int32_t)(c >> 31)));
            tab[i] = __builtin_bswap32(c);
        }
    }
    uint32_t run(const uint8_t* p, size_t n, uint32_t crc = 0) const {
        for (size_t i = 0; i < n; i++)
            crc = tab[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
        return crc;
    }
};
static const Crc32 g_crc;

// ---------------------------------------------------------------------------
// Adaptive binary range coder
// ---------------------------------------------------------------------------

struct RacTables {
    uint8_t zero[256];
    uint8_t one[256];

    void build_default(int64_t factor = (int64_t)(0.05 * 4294967296.0),
                       int max_p = 256 - 8) {
        const int64_t kOne = 1LL << 32;
        std::memset(zero, 0, sizeof(zero));
        std::memset(one, 0, sizeof(one));
        int last_p8 = 0;
        int64_t p = kOne / 2;
        for (int i = 0; i < 128; i++) {
            int p8 = (int)((256 * p + kOne / 2) >> 32);
            if (p8 <= last_p8) p8 = last_p8 + 1;
            if (last_p8 && last_p8 < 256 && p8 <= max_p)
                one[last_p8] = (uint8_t)p8;
            p += ((kOne - p) * factor + kOne / 2) >> 32;
            last_p8 = p8;
        }
        for (int i = 256 - max_p; i <= max_p; i++) {
            if (one[i]) continue;
            p = ((int64_t)i * kOne + 128) >> 8;
            p += ((kOne - p) * factor + kOne / 2) >> 32;
            int p8 = (int)((256 * p + kOne / 2) >> 32);
            if (p8 <= i) p8 = i + 1;
            if (p8 > max_p) p8 = max_p;
            one[i] = (uint8_t)p8;
        }
        for (int i = 1; i < 255; i++)
            zero[i] = (uint8_t)(256 - one[256 - i]);
    }

    void from_transition(const uint8_t* one_state) {
        std::memset(zero, 0, sizeof(zero));
        std::memset(one, 0, sizeof(one));
        for (int i = 1; i < 256; i++) {
            one[i] = one_state[i];
            zero[256 - i] = (uint8_t)(256 - one_state[i]);
        }
    }
};

static const RacTables& default_tables() {
    static RacTables t = [] { RacTables x; x.build_default(); return x; }();
    return t;
}

struct RangeEnc {
    int low = 0;
    int range = 0xFF00;
    int outstanding_count = 0;
    int outstanding_byte = -1;
    std::vector<uint8_t>* out = nullptr;
    const RacTables* tab = &default_tables();

    void attach(std::vector<uint8_t>* o) { out = o; }

    void renorm() {
        while (range < 0x100) {
            if (outstanding_byte < 0) {
                outstanding_byte = low >> 8;
            } else if (low <= 0xFF00) {
                out->push_back((uint8_t)outstanding_byte);
                out->insert(out->end(), outstanding_count, 0xFF);
                outstanding_count = 0;
                outstanding_byte = low >> 8;
            } else if (low >= 0x10000) {
                out->push_back((uint8_t)(outstanding_byte + 1));
                out->insert(out->end(), outstanding_count, 0x00);
                outstanding_count = 0;
                outstanding_byte = (low >> 8) & 0xFF;
            } else {
                outstanding_count++;
            }
            low = (low & 0xFF) << 8;
            range <<= 8;
        }
    }

    void put(uint8_t* state, int bit) {
        int r1 = (range * (*state)) >> 8;
        if (!bit) {
            range -= r1;
            *state = tab->zero[*state];
        } else {
            low += range - r1;
            range = r1;
            *state = tab->one[*state];
        }
        renorm();
    }

    void put_fixed(int bit, uint8_t prob = 128) {
        uint8_t s = prob;
        put(&s, bit);
    }

    // flush; version 1 emits the state-129 terminator bit first
    void terminate(int version) {
        if (version == 1) put_fixed(0, 129);
        range = 0xFF;
        low += 0xFF;
        renorm();
        range = 0xFF;
        renorm();
    }
};

struct RangeDec {
    const uint8_t* buf = nullptr;
    size_t pos = 0, end = 0;
    int low = 0, range = 0xFF00;
    int overread = 0;
    const RacTables* tab = &default_tables();

    void init(const uint8_t* b, size_t n) {
        buf = b;
        end = n;
        low = n >= 2 ? (b[0] << 8 | b[1]) : 0;
        pos = 2;
        range = 0xFF00;
        overread = 0;
        if (low >= 0xFF00) { low = 0xFF00; end = pos; }
    }

    void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (pos < end) low += buf[pos++];
            else overread++;
        }
    }

    int get(uint8_t* state) {
        int r1 = (range * (*state)) >> 8;
        range -= r1;
        if (low < range) {
            *state = tab->zero[*state];
            refill();
            return 0;
        }
        low -= range;
        *state = tab->one[*state];
        range = r1;
        refill();
        return 1;
    }

    int get_fixed(uint8_t prob = 128) {
        uint8_t s = prob;
        return get(&s);
    }
};

// ---------------------------------------------------------------------------
// Symbol layer: 32-state exponent/sign/mantissa contexts
// ---------------------------------------------------------------------------

static inline int ilog2(unsigned v) { return 31 - __builtin_clz(v); }

struct RcStats {
    // [state_value][bit] and per-(context,slot)[bit] tallies (pass 1)
    std::vector<uint64_t> stat;    // 256*2
    std::vector<uint64_t> stat2;   // ctx*32*2 for the active quant table
    void init(size_t nctx) {
        stat.assign(256 * 2, 0);
        stat2.assign(nctx * 32 * 2, 0);  // 32 == kContextSize
    }
};

static void put_symbol_stats(RangeEnc& c, uint8_t* st, int v, bool is_signed,
                             RcStats& rs, size_t ctx_base) {
    auto put = [&](int slot, int bit) {
        rs.stat[(size_t)st[slot] * 2 + bit]++;
        rs.stat2[(ctx_base + slot) * 2 + bit]++;
        c.put(st + slot, bit);
    };
    if (v) {
        const unsigned a = v < 0 ? -(unsigned)v : (unsigned)v;
        const int e = ilog2(a);
        put(0, 0);
        if (e <= 9) {
            for (int i = 0; i < e; i++) put(1 + i, 1);
            put(1 + e, 0);
            for (int i = e - 1; i >= 0; i--) put(22 + i, (a >> i) & 1);
            if (is_signed) put(11 + e, v < 0);
        } else {
            for (int i = 0; i < e; i++) put(1 + std::min(i, 9), 1);
            put(1 + 9, 0);
            for (int i = e - 1; i >= 0; i--)
                put(22 + std::min(i, 9), (a >> i) & 1);
            if (is_signed) put(11 + 10, v < 0);
        }
    } else {
        put(0, 1);
    }
}

static void put_symbol(RangeEnc& c, uint8_t* st, int v, bool is_signed) {
    if (v) {
        const unsigned a = v < 0 ? -(unsigned)v : (unsigned)v;
        const int e = ilog2(a);
        c.put(st + 0, 0);
        if (e <= 9) {
            for (int i = 0; i < e; i++) c.put(st + 1 + i, 1);
            c.put(st + 1 + e, 0);
            for (int i = e - 1; i >= 0; i--)
                c.put(st + 22 + i, (a >> i) & 1);
            if (is_signed) c.put(st + 11 + e, v < 0);
        } else {
            for (int i = 0; i < e; i++)
                c.put(st + 1 + std::min(i, 9), 1);
            c.put(st + 1 + 9, 0);
            for (int i = e - 1; i >= 0; i--)
                c.put(st + 22 + std::min(i, 9), (a >> i) & 1);
            if (is_signed) c.put(st + 11 + 10, v < 0);
        }
    } else {
        c.put(st + 0, 1);
    }
}

static int get_symbol(RangeDec& c, uint8_t* st, bool is_signed) {
    if (c.get(st + 0)) return 0;
    int e = 0;
    while (c.get(st + 1 + std::min(e, 9))) {
        e++;
        if (e > 31) return 0;  // corrupt; caller checks overread
    }
    unsigned a = 1;
    for (int i = e - 1; i >= 0; i--)
        a += a + c.get(st + 22 + std::min(i, 9));
    int neg = is_signed && c.get(st + 11 + std::min(e, 10));
    return neg ? -(int)a : (int)a;
}

// ---------------------------------------------------------------------------
// Op planner for the on-device arithmetic coder: expands a slice's entire
// range-coded stream (headers + per-pixel symbols) into (state_value, bit)
// pairs with the context adaptation already applied.  The device lane coder
// (ffv1/tpu_coder.py) then runs the pure low/range arithmetic for all
// slices in parallel; outputs are byte-exact with RangeEnc.
// ---------------------------------------------------------------------------

struct OpSink {
    std::vector<uint8_t> sv;
    std::vector<uint8_t> bit;
    // (op offset, row width) at every plane-row start: lets the caller
    // replay the encoder's per-row budget check (obuf + w*35 > budget)
    // against the device coder's byte prefix for the exact v4 PCM rule
    std::vector<int64_t> row_marks;
    std::vector<int32_t> row_widths;
    void mark_row(int w) {
        row_marks.push_back((int64_t)sv.size());
        row_widths.push_back(w);
    }
    void put(uint8_t* state, int b, const RacTables& tab) {
        sv.push_back(*state);
        bit.push_back((uint8_t)b);
        *state = b ? tab.one[*state] : tab.zero[*state];
    }
};

// golomb-mode planning sink: (value, nbits) pairs for the device
// bit-packer (ffv1/tpu_coder.py:bit_pack_lanes)
struct BitSink {
    std::vector<uint32_t> val;
    std::vector<uint8_t> nb;
    void put(int n, unsigned v) {
        val.push_back(v);
        nb.push_back((uint8_t)n);
    }
};

static void plan_symbol(OpSink& o, uint8_t* st, int v, bool is_signed,
                        const RacTables& tab, RcStats* rs = nullptr,
                        size_t ctx_base = 0) {
    if (rs) {
        // mirror put_symbol_stats' tallies on the planned ops so pass-1
        // runs through the device-coder path too
        if (v) {
            const unsigned a = v < 0 ? -(unsigned)v : (unsigned)v;
            const int e = ilog2(a);
            // replay the slot walk against the CURRENT states (before
            // o.put advances them): tally then fall through to planning
            uint8_t snap[32];
            std::memcpy(snap, st, 32);
            auto tally = [&](int slot, int bit) {
                rs->stat[(size_t)snap[slot] * 2 + bit]++;
                rs->stat2[(ctx_base + slot) * 2 + bit]++;
                snap[slot] = bit ? tab.one[snap[slot]] : tab.zero[snap[slot]];
            };
            tally(0, 0);
            for (int i = 0; i < e; i++) tally(1 + std::min(i, 9), 1);
            tally(1 + std::min(e, 9), 0);
            for (int i = e - 1; i >= 0; i--)
                tally(22 + std::min(i, 9), (a >> i) & 1);
            if (is_signed) tally(11 + std::min(e, 10), v < 0);
        } else {
            rs->stat[(size_t)st[0] * 2 + 1]++;
            rs->stat2[(ctx_base + 0) * 2 + 1]++;
        }
    }
    if (v) {
        const unsigned a = v < 0 ? -(unsigned)v : (unsigned)v;
        const int e = ilog2(a);
        o.put(st + 0, 0, tab);
        for (int i = 0; i < e; i++) o.put(st + 1 + std::min(i, 9), 1, tab);
        o.put(st + 1 + std::min(e, 9), 0, tab);
        for (int i = e - 1; i >= 0; i--)
            o.put(st + 22 + std::min(i, 9), (a >> i) & 1, tab);
        if (is_signed) o.put(st + 11 + std::min(e, 10), v < 0, tab);
    } else {
        o.put(st + 0, 1, tab);
    }
}

// ---------------------------------------------------------------------------
// Bit IO (MSB-first) + Golomb-Rice
// ---------------------------------------------------------------------------

// MSB-first bit writer over a raw growable buffer (no per-write size
// bookkeeping in the hot path; callers reserve per line via ensure()).
struct BitWriter {
    std::vector<uint8_t>* out = nullptr;  // final destination (on flush)
    uint8_t* buf = nullptr;
    size_t cap = 0;
    size_t len = 0;
    uint64_t acc = 0;
    int nbits = 0;

    ~BitWriter() { std::free(buf); }

    void attach(std::vector<uint8_t>* o) {
        out = o;
        if (!buf) {
            cap = 1 << 16;
            buf = (uint8_t*)std::malloc(cap);
        }
        len = 0;
        acc = 0;
        nbits = 0;
    }

    void ensure(size_t extra) {
        if (len + extra + 16 > cap) {
            while (len + extra + 16 > cap) cap *= 2;
            buf = (uint8_t*)std::realloc(buf, cap);
        }
    }

    inline void put(int n, uint32_t v) {
        acc = (acc << n) | (v & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
        nbits += n;
        if (nbits >= 32) {
            nbits -= 32;
            uint32_t w = (uint32_t)(acc >> nbits);
            buf[len++] = (uint8_t)(w >> 24);
            buf[len++] = (uint8_t)(w >> 16);
            buf[len++] = (uint8_t)(w >> 8);
            buf[len++] = (uint8_t)w;
            acc &= (1ull << nbits) - 1;
        }
    }

    // byte count written so far (excluding buffered bits)
    size_t byte_len() const { return len + (size_t)(nbits >> 3); }

    void flush() {
        while (nbits >= 8) {
            nbits -= 8;
            buf[len++] = (uint8_t)(acc >> nbits);
        }
        if (nbits) {
            buf[len++] = (uint8_t)(acc << (8 - nbits));
            nbits = 0;
        }
        acc = 0;
        out->insert(out->end(), buf, buf + len);
        len = 0;
    }
};

struct BitReader {
    const uint8_t* buf = nullptr;
    size_t size_bits = 0;
    size_t pos = 0;

    void init(const uint8_t* b, size_t nbytes, size_t start_byte) {
        buf = b;
        size_bits = nbytes * 8;
        pos = start_byte * 8;
    }

    int get1() {
        int bit = 0;
        if (pos < size_bits)
            bit = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return bit;
    }

    uint32_t get(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | get1();
        return v;
    }

    bool exhausted() const { return pos >= size_bits; }
};

static const uint8_t kLog2Run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24,
};

struct VlcState {
    int16_t drift = 0;
    uint16_t error_sum = 4;
    int8_t bias = 0;
    uint8_t count = 1;

    void reset() { drift = 0; error_sum = 4; bias = 0; count = 1; }

    void update(int v) {
        int d = drift, cnt = count;
        error_sum = (uint16_t)(error_sum + (v < 0 ? -v : v));
        d += v;
        if (cnt == 128) {
            cnt >>= 1;
            d >>= 1;
            error_sum >>= 1;
        }
        cnt++;
        if (d <= -cnt) {
            bias = (int8_t)std::max(bias - 1, -128);
            d = std::max(d + cnt, -cnt + 1);
        } else if (d > 0) {
            bias = (int8_t)std::min(bias + 1, 127);
            d = std::min(d - cnt, 0);
        }
        drift = (int16_t)d;
        count = (uint8_t)cnt;
    }
};

static inline int fold(int diff, int bits) {
    diff &= (1 << bits) - 1;
    if (diff & (1 << (bits - 1))) diff -= 1 << bits;
    return diff;
}

__attribute__((always_inline)) static inline void put_sr_golomb(BitWriter& pb, int i, int k, int limit,
                          int esc_len) {
    unsigned v = i >= 0 ? 2u * i : -2u * i - 1;
    int e = v >> k;
    if (e < limit)
        pb.put(e + k + 1, (1u << k) + (v & ((1u << k) - 1)));
    else
        pb.put(limit + esc_len, v - limit + 1);
}

static int get_sr_golomb(BitReader& gb, int k, int limit, int esc_len) {
    unsigned v;
    int zeros = 0;
    for (;;) {
        if (zeros >= limit) { v = gb.get(esc_len) + limit - 1; break; }
        if (gb.get1()) { v = ((unsigned)zeros << k) + gb.get(k); break; }
        zeros++;
    }
    return (int)(v >> 1) ^ -(int)(v & 1);
}

static inline int rice_k(int count, unsigned error_sum) {
    // smallest k with count << k >= error_sum (no division: start from the
    // bit-length gap and adjust by at most one)
    if ((unsigned)count >= error_sum) return 0;
    int k = (32 - __builtin_clz(error_sum - 1)) - (32 - __builtin_clz(count));
    if (k > 0 && ((unsigned)count << (k - 1)) >= error_sum) k--;
    if (((unsigned)count << k) < error_sum) k++;
    return k;
}

__attribute__((always_inline)) static inline void put_vlc_symbol(BitWriter& pb, VlcState& st, int v, int bits) {
    v = fold(v - st.bias, bits);
    int k = rice_k(st.count, st.error_sum);
    int code = v ^ ((2 * st.drift + st.count) >> 31);
    put_sr_golomb(pb, code, k, 12, bits);
    st.update(v);
}

static int get_vlc_symbol(BitReader& gb, VlcState& st, int bits) {
    int k = rice_k(st.count, st.error_sum);
    int v = get_sr_golomb(gb, k, 12, bits);
    v ^= (2 * st.drift + st.count) >> 31;
    int ret = fold(v + st.bias, bits);
    st.update(v);
    return ret;
}

static void plan_sr_golomb(BitSink& b, int i, int k, int limit,
                           int esc_len) {
    unsigned v = i >= 0 ? 2u * i : -2u * i - 1;
    int e = v >> k;
    if (e < limit)
        b.put(e + k + 1, (1u << k) + (v & ((1u << k) - 1)));
    else
        b.put(limit + esc_len, v - limit + 1);
}

static void plan_vlc_symbol(BitSink& b, VlcState& st, int v, int bits) {
    v = fold(v - st.bias, bits);
    int k = rice_k(st.count, st.error_sum);
    int code = v ^ ((2 * st.drift + st.count) >> 31);
    plan_sr_golomb(b, code, k, 12, bits);
    st.update(v);
}

// ---------------------------------------------------------------------------
// Parameters (C ABI mirror)
// ---------------------------------------------------------------------------

struct Params {
    int version, micro_version;
    int width, height;
    int colorspace, bits;
    int chroma_planes, chroma_h_shift, chroma_v_shift, transparency;
    int ac, ec, intra, context_model;
    int num_h_slices, num_v_slices;
    int plane_count, use32bit;
    int quant_table_count;
    int context_counts[8];
    int16_t quant_tables[8][5][256];
    uint8_t state_transition[256];
    // optional initial states (2-pass); empty = all 128
    std::vector<std::vector<uint8_t>> initial_states;
};

enum { AC_GOLOMB = 0, AC_RANGE_DEFAULT = 1, AC_RANGE_CUSTOM = 2 };

// Planar RGB at 9..14 bpc without alpha: the reference reads the G plane
// as 'b' and the B plane as 'g' (ffv1enc_template.c:170-172 else-branch;
// the decoder mirrors it), so the coded-g stream carries plane-1 content.
static inline bool gb_swapped(const struct Params& p);
enum { kContextSize = 32 };

struct Rect { int x, y, w, h; };

static inline bool gb_swapped(const Params& p) {
    return p.colorspace == 1 && !p.use32bit && !p.transparency && p.bits > 8;
}

static Rect slice_rect(const Params& p, int i) {
    int sx = i % p.num_h_slices, sy = i / p.num_h_slices;
    int x0 = p.width * sx / p.num_h_slices;
    int x1 = p.width * (sx + 1) / p.num_h_slices;
    int y0 = p.height * sy / p.num_v_slices;
    int y1 = p.height * (sy + 1) / p.num_v_slices;
    return {x0, y0, x1 - x0, y1 - y0};
}

// ---------------------------------------------------------------------------
// Per-slice persistent coder state
// ---------------------------------------------------------------------------

struct SliceState {
    std::vector<std::vector<uint8_t>> states;    // per plane: ctx*32
    std::vector<std::vector<VlcState>> vlc;      // per plane
    std::array<int, 4> qt_index{};
    std::array<int, 4> ctx_count{};
    int run_index = 0;
    int rct_by = 1, rct_ry = 1;
    int coding_mode = 0;
    int reset_contexts = 0;
    bool damaged = false;
    RcStats* stats = nullptr;   // set when pass-1 collection is on

    void init(const Params& p) {
        states.assign(p.plane_count, {});
        vlc.assign(p.plane_count, {});
        for (int i = 0; i < p.plane_count; i++) {
            qt_index[i] = p.context_model;
            ctx_count[i] = p.context_counts[p.context_model];
            alloc_plane(p, i);
        }
    }

    void alloc_plane(const Params& p, int i) {
        if (p.ac != AC_GOLOMB) {
            states[i].assign((size_t)ctx_count[i] * kContextSize, 128);
        } else {
            vlc[i].assign(ctx_count[i], VlcState());
        }
    }

    void clear(const Params& p) {
        for (int i = 0; i < p.plane_count; i++) {
            if (p.ac != AC_GOLOMB) {
                const auto& init = p.initial_states;
                int qi = qt_index[i];
                if ((int)init.size() > qi && !init[qi].empty()) {
                    size_t n = (size_t)ctx_count[i] * kContextSize;
                    std::memcpy(states[i].data(), init[qi].data(),
                                std::min(n, init[qi].size()));
                } else {
                    std::fill(states[i].begin(), states[i].end(), 128);
                }
            } else {
                for (auto& v : vlc[i]) v.reset();
            }
        }
    }
};

// ---------------------------------------------------------------------------
// Line codec, templated on the sample type (int16 regular / int32 use32bit)
// ---------------------------------------------------------------------------

template <typename T>
struct LineCodec {
    const Params& p;
    SliceState& ss;

    LineCodec(const Params& par, SliceState& s) : p(par), ss(s) {}

    static inline int ctx5(const int16_t qt[5][256], const T* cur,
                           const T* prev, const T* prev2, int x) {
        const int LT = prev[x - 1], Tv = prev[x], RT = prev[x + 1];
        const int L = cur[x - 1];
        int c = qt[0][(L - LT) & 0xFF] + qt[1][(LT - Tv) & 0xFF]
              + qt[2][(Tv - RT) & 0xFF];
        if (qt[3][127] || qt[4][127]) {
            const int TT = prev2[x];
            const int LL = cur[x - 2];
            c += qt[3][(LL - L) & 0xFF] + qt[4][(TT - Tv) & 0xFF];
        }
        return c;
    }

    static inline int med(int a, int b, int c) {
        if (a > b) std::swap(a, b);
        return std::min(std::max(a, c), b);
    }

    static inline int pred(const T* cur, const T* prev, int x) {
        const int L = cur[x - 1], Tv = prev[x], LT = prev[x - 1];
        return med(L, L + Tv - LT, Tv);
    }

    bool encode_line(RangeEnc& c, BitWriter& pb, const int16_t qt[5][256],
                     uint8_t* states, VlcState* vlc, int w, const T* cur,
                     const T* prev, const T* prev2, int bits,
                     size_t byte_budget, const std::vector<uint8_t>& buf) {
        // budget check mirrors the reference's w*35 headroom rule
        if (p.ac != AC_GOLOMB) {
            if (buf.size() + (size_t)w * 35 > byte_budget) return false;
        } else {
            if (buf.size() + pb.byte_len() + (size_t)w * 4 > byte_budget)
                return false;
            pb.ensure((size_t)w * 4 + 64);
        }

        if (ss.coding_mode == 1) {
            for (int x = 0; x < w; x++) {
                int v = cur[x];
                for (int i = bits - 1; i >= 0; i--)
                    c.put_fixed((v >> i) & 1);
            }
            return true;
        }

        int run_index = ss.run_index, run_count = 0, run_mode = 0;
        for (int x = 0; x < w; x++) {
            int context = ctx5(qt, cur, prev, prev2, x);
            int diff = cur[x] - pred(cur, prev, x);
            if (context < 0) { context = -context; diff = -diff; }
            diff = fold(diff, bits);

            if (p.ac != AC_GOLOMB) {
                if (ss.stats)
                    put_symbol_stats(c, states + (size_t)context * kContextSize,
                                     diff, true, *ss.stats,
                                     (size_t)context * kContextSize);
                else
                    put_symbol(c, states + (size_t)context * kContextSize,
                               diff, true);
            } else {
                if (context == 0) run_mode = 1;
                if (run_mode) {
                    if (diff) {
                        while (run_count >= 1 << kLog2Run[run_index]) {
                            run_count -= 1 << kLog2Run[run_index];
                            run_index++;
                            pb.put(1, 1);
                        }
                        pb.put(1 + kLog2Run[run_index], run_count);
                        if (run_index) run_index--;
                        run_count = 0;
                        run_mode = 0;
                        if (diff > 0) diff--;
                    } else {
                        run_count++;
                    }
                }
                if (run_mode == 0)
                    put_vlc_symbol(pb, vlc[context], diff, bits);
            }
        }
        if (run_mode) {
            while (run_count >= 1 << kLog2Run[run_index]) {
                run_count -= 1 << kLog2Run[run_index];
                run_index++;
                pb.put(1, 1);
            }
            if (run_count) pb.put(1, 1);
        }
        ss.run_index = run_index;
        return true;
    }

    bool decode_line(RangeDec& c, BitReader& gb, const int16_t qt[5][256],
                     uint8_t* states, VlcState* vlc, int w, T* cur,
                     const T* prev, int bits) {
        const int mask = (int)((1u << bits) - 1);
        if (p.ac != AC_GOLOMB) {
            if (c.overread > 2) return false;
        } else {
            if (gb.exhausted()) return false;
        }

        if (ss.coding_mode == 1) {
            for (int x = 0; x < w; x++) {
                int v = 0;
                for (int i = 0; i < bits; i++) v += v + c.get_fixed();
                cur[x] = (T)v;
            }
            return true;
        }

        int run_count = 0, run_mode = 0, run_index = ss.run_index;
        for (int x = 0; x < w; x++) {
            if (!(x & 1023) && p.ac != AC_GOLOMB && c.overread > 2)
                return false;
            int context = ctx5(qt, cur, prev, cur, x);
            int sign = 0;
            if (context < 0) { context = -context; sign = 1; }

            int diff;
            if (p.ac != AC_GOLOMB) {
                diff = get_symbol(c, states + (size_t)context * kContextSize,
                                  true);
            } else {
                if (context == 0 && run_mode == 0) run_mode = 1;
                if (run_mode) {
                    if (run_count == 0 && run_mode == 1) {
                        if (gb.get1()) {
                            run_count = 1 << kLog2Run[run_index];
                            if (x + run_count <= w) run_index++;
                        } else {
                            run_count = kLog2Run[run_index]
                                            ? (int)gb.get(kLog2Run[run_index])
                                            : 0;
                            if (run_index) run_index--;
                            run_mode = 2;
                        }
                    }
                    if (cur[x - 1] == prev[x - 1]) {
                        while (run_count > 1 && w - x > 1) {
                            cur[x] = prev[x];
                            x++;
                            run_count--;
                        }
                    } else {
                        while (run_count > 1 && w - x > 1) {
                            cur[x] = (T)pred(cur, prev, x);
                            x++;
                            run_count--;
                        }
                    }
                    run_count--;
                    if (run_count < 0) {
                        run_mode = 0;
                        run_count = 0;
                        diff = get_vlc_symbol(gb, vlc[context], bits);
                        if (diff >= 0) diff++;
                    } else {
                        diff = 0;
                    }
                } else {
                    diff = get_vlc_symbol(gb, vlc[context], bits);
                }
            }
            if (sign) diff = -diff;
            cur[x] = (T)((pred(cur, prev, x) + diff) & mask);
        }
        ss.run_index = run_index;
        return true;
    }
};

// ---------------------------------------------------------------------------
// Slice coding over padded row rings
// ---------------------------------------------------------------------------

// Padded rows: index 0..w+5 with logical [-3, w+2] at offset 3.
template <typename T>
struct RowRing {
    std::vector<T> buf;
    int stride;
    int n;
    RowRing(int w, int rows) : stride(w + 6), n(rows) {
        buf.assign((size_t)stride * rows, 0);
    }
    T* row(int i) { return buf.data() + (size_t)i * stride + 3; }
};

// int32 view of a frame plane inside a slice rect
struct PlaneView {
    const int32_t* data;  // frame-level plane base
    int32_t* out;
    int stride;           // elements per row
    int x0, y0, w, h;     // slice rect in this plane's resolution
    const int32_t* src_row(int y) const {
        return data + (size_t)(y0 + y) * stride + x0;
    }
    int32_t* dst_row(int y) const {
        return out + (size_t)(y0 + y) * stride + x0;
    }
};

template <typename T>
static bool encode_plane_t(const Params& p, SliceState& ss, RangeEnc& c,
                           BitWriter& pb, const PlaneView& pv,
                           int plane_index, int bits, size_t budget,
                           const std::vector<uint8_t>& obuf) {
    LineCodec<T> lc(p, ss);
    const int w = pv.w, h = pv.h;
    const int ring = p.context_model ? 3 : 2;
    RowRing<T> ring_buf(w, ring);
    ss.run_index = 0;
    const int16_t(*qt)[256] = p.quant_tables[ss.qt_index[plane_index]];
    uint8_t* states = p.ac != AC_GOLOMB ? ss.states[plane_index].data()
                                        : nullptr;
    VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[plane_index].data() : nullptr;

    for (int y = 0; y < h; y++) {
        T* cur = ring_buf.row((h + 0 - y) % ring);
        T* prev = ring_buf.row((h + 1 - y) % ring);
        T* prev2 = ring == 3 ? ring_buf.row((h + 2 - y) % ring) : cur;
        const int32_t* src = pv.src_row(y);
        for (int x = 0; x < w; x++) cur[x] = (T)src[x];
        cur[-1] = prev[0];
        prev[w] = prev[w - 1];
        if (!lc.encode_line(c, pb, qt, states, vlc, w, cur, prev, prev2,
                            bits, budget, obuf))
            return false;
    }
    return true;
}

template <typename T>
static bool decode_plane_t(const Params& p, SliceState& ss, RangeDec& c,
                           BitReader& gb, const PlaneView& pv,
                           int plane_index, int bits) {
    LineCodec<T> lc(p, ss);
    const int w = pv.w, h = pv.h;
    RowRing<T> ring_buf(w, 2);
    ss.run_index = 0;
    const int16_t(*qt)[256] = p.quant_tables[ss.qt_index[plane_index]];
    uint8_t* states = p.ac != AC_GOLOMB ? ss.states[plane_index].data()
                                        : nullptr;
    VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[plane_index].data() : nullptr;
    const int mask = (int)((1u << bits) - 1);

    for (int y = 0; y < h; y++) {
        T* prev = ring_buf.row(y & 1);
        T* cur = ring_buf.row((y + 1) & 1);
        cur[-1] = prev[0];
        prev[w] = prev[w - 1];
        if (!lc.decode_line(c, gb, qt, states, vlc, w, cur, prev, bits))
            return false;
        int32_t* dst = pv.dst_row(y);
        for (int x = 0; x < w; x++) dst[x] = cur[x] & mask;
    }
    return true;
}

// Phase-B-only plane encode: (context, diff) precomputed by the device
// phase-A pass (ffv1/tpu.py); full-frame int32 streams, same geometry as
// the plane.  Coder semantics identical to encode_line.
struct SymView {
    const int32_t* ctx;   // contiguous [h, w] crop for this slice+plane
    const int32_t* diff;
    int stride;
    const int32_t* ctx_row(int y) const {
        return ctx + (size_t)y * stride;
    }
    const int32_t* diff_row(int y) const {
        return diff + (size_t)y * stride;
    }
};

static void encode_sym_row(const Params& p, SliceState& ss, RangeEnc& c,
                           BitWriter& pb, const int32_t* ctxs,
                           const int32_t* diffs, int w, uint8_t* states,
                           VlcState* vlc, int bits);

static bool sym_row_budget(const Params& p, BitWriter& pb, int w,
                           size_t budget, const std::vector<uint8_t>& obuf) {
    if (p.ac != AC_GOLOMB)
        return obuf.size() + (size_t)w * 35 <= budget;
    if (obuf.size() + pb.byte_len() + (size_t)w * 4 > budget) return false;
    pb.ensure((size_t)w * 4 + 64);
    return true;
}

static bool encode_plane_sym(const Params& p, SliceState& ss, RangeEnc& c,
                             BitWriter& pb, const SymView& sv, int w, int h,
                             int plane_index, int bits, size_t budget,
                             const std::vector<uint8_t>& obuf) {
    ss.run_index = 0;
    uint8_t* states = p.ac != AC_GOLOMB ? ss.states[plane_index].data()
                                        : nullptr;
    VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[plane_index].data() : nullptr;

    for (int y = 0; y < h; y++) {
        if (!sym_row_budget(p, pb, w, budget, obuf)) return false;
        encode_sym_row(p, ss, c, pb, sv.ctx_row(y), sv.diff_row(y), w,
                       states, vlc, bits);
    }
    return true;
}

// one row of precomputed (ctx, diff) symbols; golomb run state carries
// through ss.run_index (shared across planes in the RGB interleave)
static void encode_sym_row(const Params& p, SliceState& ss, RangeEnc& c,
                           BitWriter& pb, const int32_t* ctxs,
                           const int32_t* diffs, int w, uint8_t* states,
                           VlcState* vlc, int bits) {
    {
        int run_index = ss.run_index, run_count = 0, run_mode = 0;
        for (int x = 0; x < w; x++) {
            int context = ctxs[x];
            int diff = diffs[x];
            if (p.ac != AC_GOLOMB) {
                if (ss.stats)
                    put_symbol_stats(c, states + (size_t)context * kContextSize,
                                     diff, true, *ss.stats,
                                     (size_t)context * kContextSize);
                else
                    put_symbol(c, states + (size_t)context * kContextSize,
                               diff, true);
            } else {
                if (context == 0) run_mode = 1;
                if (run_mode) {
                    if (diff) {
                        while (run_count >= 1 << kLog2Run[run_index]) {
                            run_count -= 1 << kLog2Run[run_index];
                            run_index++;
                            pb.put(1, 1);
                        }
                        pb.put(1 + kLog2Run[run_index], run_count);
                        if (run_index) run_index--;
                        run_count = 0;
                        run_mode = 0;
                        if (diff > 0) diff--;
                    } else {
                        run_count++;
                    }
                }
                if (run_mode == 0)
                    put_vlc_symbol(pb, vlc[context], diff, bits);
            }
        }
        if (run_mode) {
            while (run_count >= 1 << kLog2Run[run_index]) {
                run_count -= 1 << kLog2Run[run_index];
                run_index++;
                pb.put(1, 1);
            }
            if (run_count) pb.put(1, 1);
        }
        ss.run_index = run_index;
    }
}

// row-interleaved RGB sym coding (ffv1enc_template.c:encode_rgb_frame
// order: row y of g, b, r, (a); run_index shared across planes)
static bool encode_rgb_sym(const Params& p, SliceState& ss, RangeEnc& c,
                           BitWriter& pb, const SymView* svs, int nplanes,
                           int w, int h, int bits, size_t budget,
                           const std::vector<uint8_t>& obuf) {
    ss.run_index = 0;
    for (int y = 0; y < h; y++) {
        for (int pl = 0; pl < nplanes; pl++) {
            if (!sym_row_budget(p, pb, w, budget, obuf)) return false;
            int pi = (pl + 1) / 2;
            uint8_t* states = p.ac != AC_GOLOMB ? ss.states[pi].data()
                                                : nullptr;
            VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[pi].data() : nullptr;
            encode_sym_row(p, ss, c, pb, svs[pl].ctx_row(y),
                           svs[pl].diff_row(y), w, states, vlc, bits);
        }
    }
    return true;
}

template <typename T>
static bool encode_rgb_t(const Params& p, SliceState& ss, RangeEnc& c,
                         BitWriter& pb, const PlaneView* pv, int nplanes,
                         int bits, size_t budget,
                         const std::vector<uint8_t>& obuf) {
    LineCodec<T> lc(p, ss);
    const int w = pv[0].w, h = pv[0].h;
    const bool lbd = p.bits <= 8;
    const int offset = 1 << bits;
    const int ring = p.context_model ? 3 : 2;
    std::array<std::unique_ptr<RowRing<T>>, 4> rings;
    for (int i = 0; i < 4; i++)
        rings[i] = std::make_unique<RowRing<T>>(w, ring);
    ss.run_index = 0;

    for (int y = 0; y < h; y++) {
        T* cur[4];
        T* prev[4];
        T* prev2[4];
        for (int pl = 0; pl < 4; pl++) {
            cur[pl] = rings[pl]->row((h + 0 - y) % ring);
            prev[pl] = rings[pl]->row((h + 1 - y) % ring);
            prev2[pl] = ring == 3 ? rings[pl]->row((h + 2 - y) % ring)
                                  : cur[pl];
        }
        const bool swap = gb_swapped(p);
        const int32_t* gs = pv[swap ? 1 : 0].src_row(y);
        const int32_t* bs = pv[swap ? 0 : 1].src_row(y);
        const int32_t* rs = pv[2].src_row(y);
        const int32_t* as = nplanes > 3 ? pv[3].src_row(y) : nullptr;
        for (int x = 0; x < w; x++) {
            int g = gs[x], b = bs[x], r = rs[x];
            if (ss.coding_mode != 1) {
                b -= g;
                r -= g;
                g += (b * ss.rct_by + r * ss.rct_ry) >> 2;
                b += offset;
                r += offset;
            }
            cur[0][x] = (T)g;
            cur[1][x] = (T)b;
            cur[2][x] = (T)r;
            if (as) cur[3][x] = (T)as[x];
        }
        for (int pl = 0; pl < nplanes; pl++) {
            cur[pl][-1] = prev[pl][0];
            prev[pl][w] = prev[pl][w - 1];
            int plane_index = (pl + 1) / 2;
            const int16_t(*qt)[256] =
                p.quant_tables[ss.qt_index[plane_index]];
            uint8_t* states = p.ac != AC_GOLOMB
                                  ? ss.states[plane_index].data()
                                  : nullptr;
            VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[plane_index].data()
                                              : nullptr;
            int eff_bits = (lbd && ss.coding_mode == 0)
                               ? 9
                               : bits + (ss.coding_mode != 1);
            if (!lc.encode_line(c, pb, qt, states, vlc, w, cur[pl],
                                prev[pl], prev2[pl], eff_bits, budget, obuf))
                return false;
        }
    }
    return true;
}

template <typename T>
static bool decode_rgb_t(const Params& p, SliceState& ss, RangeDec& c,
                         BitReader& gb, const PlaneView* pv, int nplanes,
                         int bits) {
    LineCodec<T> lc(p, ss);
    const int w = pv[0].w, h = pv[0].h;
    const bool lbd = p.bits <= 8;
    const int offset = 1 << bits;
    std::array<std::unique_ptr<RowRing<T>>, 4> rings;
    for (int i = 0; i < 4; i++)
        rings[i] = std::make_unique<RowRing<T>>(w, 2);
    ss.run_index = 0;

    for (int y = 0; y < h; y++) {
        T* cur[4];
        for (int pl = 0; pl < nplanes; pl++) {
            T* prev = rings[pl]->row(y & 1);
            cur[pl] = rings[pl]->row((y + 1) & 1);
            cur[pl][-1] = prev[0];
            prev[w] = prev[w - 1];
            int plane_index = (pl + 1) / 2;
            const int16_t(*qt)[256] =
                p.quant_tables[ss.qt_index[plane_index]];
            uint8_t* states = p.ac != AC_GOLOMB
                                  ? ss.states[plane_index].data()
                                  : nullptr;
            VlcState* vlc = p.ac == AC_GOLOMB ? ss.vlc[plane_index].data()
                                              : nullptr;
            int eff_bits = (lbd && ss.coding_mode == 0)
                               ? 9
                               : bits + (ss.coding_mode != 1);
            if (!lc.decode_line(c, gb, qt, states, vlc, w, cur[pl], prev,
                                eff_bits))
                return false;
        }
        const bool swap = gb_swapped(p);
        int32_t* gd = pv[swap ? 1 : 0].dst_row(y);
        int32_t* bd = pv[swap ? 0 : 1].dst_row(y);
        int32_t* rd = pv[2].dst_row(y);
        int32_t* ad = nplanes > 3 ? pv[3].dst_row(y) : nullptr;
        for (int x = 0; x < w; x++) {
            int g = cur[0][x], b = cur[1][x], r = cur[2][x];
            if (ss.coding_mode != 1) {
                b -= offset;
                r -= offset;
                g -= (b * ss.rct_by + r * ss.rct_ry) >> 2;
                b += g;
                r += g;
            }
            gd[x] = g;
            bd[x] = b;
            rd[x] = r;
            if (ad) ad[x] = cur[3][x];
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// Headers
// ---------------------------------------------------------------------------

static void header_put_qtable(RangeEnc& c, const int16_t* tab) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    int last = 0;
    for (int i = 1; i < 128; i++) {
        if (tab[i] != tab[i - 1]) {
            put_symbol(c, st, i - last - 1, false);
            last = i;
        }
    }
    put_symbol(c, st, 128 - last - 1, false);
}

static bool header_get_qtable(RangeDec& c, int16_t* tab, int scale,
                              int* ranges) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    int i = 0, v = 0;
    while (i < 128) {
        int len = get_symbol(c, st, false) + 1;
        if (len <= 0 || len > 128 - i) return false;
        while (len--) tab[i++] = (int16_t)(scale * v);
        v++;
    }
    for (int j = 1; j < 128; j++) tab[256 - j] = (int16_t)(-tab[j]);
    tab[128] = (int16_t)(-tab[127]);
    *ranges = 2 * v - 1;
    return true;
}

static void write_v01_header(RangeEnc& c, const Params& p) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    put_symbol(c, st, p.version, false);
    put_symbol(c, st, p.ac, false);
    if (p.ac == AC_RANGE_CUSTOM)
        for (int i = 1; i < 256; i++)
            put_symbol(c, st,
                       p.state_transition[i] - default_tables().one[i], true);
    put_symbol(c, st, p.colorspace, false);
    if (p.version > 0) put_symbol(c, st, p.bits, false);
    c.put(st, p.chroma_planes);
    put_symbol(c, st, p.chroma_h_shift, false);
    put_symbol(c, st, p.chroma_v_shift, false);
    c.put(st, p.transparency);
    for (int i = 0; i < 5; i++)
        header_put_qtable(c, p.quant_tables[p.context_model][i]);
}

static bool read_v01_header(RangeDec& c, Params& p) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    int version = get_symbol(c, st, false);
    if (version >= 2) return false;
    p.version = version;
    p.ac = get_symbol(c, st, false);
    if (p.ac == AC_RANGE_CUSTOM) {
        for (int i = 1; i < 256; i++) {
            int s = get_symbol(c, st, true) + default_tables().one[i];
            if (s < 1 || s > 255) return false;
            p.state_transition[i] = (uint8_t)s;
        }
    } else {
        std::memcpy(p.state_transition, default_tables().one, 256);
    }
    p.colorspace = get_symbol(c, st, false);
    p.bits = version > 0 ? get_symbol(c, st, false) : (p.bits ? p.bits : 8);
    if (!p.bits) p.bits = 8;
    p.chroma_planes = c.get(st);
    p.chroma_h_shift = get_symbol(c, st, false);
    p.chroma_v_shift = get_symbol(c, st, false);
    p.transparency = c.get(st);
    p.plane_count = 2 + p.transparency;
    p.quant_table_count = 1;
    int count = 1;
    for (int i = 0; i < 5; i++) {
        int ranges;
        if (!header_get_qtable(c, p.quant_tables[0][i], count, &ranges))
            return false;
        count *= ranges;
        if (count > 32768) return false;
    }
    p.context_counts[0] = (count + 1) / 2;
    p.context_model = 0;
    p.num_h_slices = p.num_v_slices = 1;
    p.use32bit = p.colorspace == 1 && p.bits >= 16;
    return true;
}

static void write_slice_header(RangeEnc& c, const Params& p, SliceState& ss,
                               const Rect& r) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    put_symbol(c, st, (r.x + 1) * p.num_h_slices / p.width, false);
    put_symbol(c, st, (r.y + 1) * p.num_v_slices / p.height, false);
    put_symbol(c, st, (r.w + 1) * p.num_h_slices / p.width - 1, false);
    put_symbol(c, st, (r.h + 1) * p.num_v_slices / p.height - 1, false);
    for (int j = 0; j < p.plane_count; j++)
        put_symbol(c, st, ss.qt_index[j], false);
    put_symbol(c, st, 3, false);  // progressive
    put_symbol(c, st, 0, false);  // sar num
    put_symbol(c, st, 1, false);  // sar den -- see note in encode_frame
    if (p.version > 3) {
        c.put(st, ss.coding_mode == 1);
        if (ss.coding_mode == 1) ss.clear(p);
        put_symbol(c, st, ss.coding_mode, false);
        if (ss.coding_mode != 1) {
            put_symbol(c, st, ss.rct_by, false);
            put_symbol(c, st, ss.rct_ry, false);
        }
    }
}

static bool read_slice_header(RangeDec& c, const Params& p, SliceState& ss,
                              Rect& r) {
    uint8_t st[kContextSize];
    std::memset(st, 128, sizeof(st));
    int sx = get_symbol(c, st, false) * p.width;
    int sy = get_symbol(c, st, false) * p.height;
    int sw = (get_symbol(c, st, false) + 1) * p.width + sx;
    int sh = (get_symbol(c, st, false) + 1) * p.height + sy;
    sx /= p.num_h_slices;
    sy /= p.num_v_slices;
    sw = sw / p.num_h_slices - sx;
    sh = sh / p.num_v_slices - sy;
    if (sw <= 0 || sh <= 0 || sw > p.width || sh > p.height ||
        sx + sw > p.width || sy + sh > p.height)
        return false;
    r = {sx, sy, sw, sh};
    for (int i = 0; i < p.plane_count; i++) {
        int idx = get_symbol(c, st, false);
        if (idx >= p.quant_table_count) return false;
        if (ss.qt_index[i] != idx ||
            ss.ctx_count[i] != p.context_counts[idx]) {
            ss.qt_index[i] = idx;
            ss.ctx_count[i] = p.context_counts[idx];
            ss.alloc_plane(p, i);
        }
    }
    get_symbol(c, st, false);  // picture structure
    get_symbol(c, st, false);  // sar num
    get_symbol(c, st, false);  // sar den
    ss.reset_contexts = 0;
    ss.coding_mode = 0;
    ss.rct_by = ss.rct_ry = 1;
    if (p.version > 3) {
        ss.reset_contexts = c.get(st);
        ss.coding_mode = get_symbol(c, st, false);
        if (ss.coding_mode != 1) {
            ss.rct_by = get_symbol(c, st, false);
            ss.rct_ry = get_symbol(c, st, false);
            if (ss.rct_by + ss.rct_ry > 4) return false;
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// Codec context
// ---------------------------------------------------------------------------

struct PlaneDesc {
    int w, h;  // full-frame plane dims
};

struct Codec {
    Params p;
    std::vector<SliceState> slices;
    RacTables custom_tab;
    bool have_custom = false;
    int n_threads = 1;
    bool stats_mode = false;
    size_t budget_override = 0;   // test hook for the v4 PCM retry path
    int gob_count = 0;
    std::vector<RcStats> slice_stats;
    std::vector<OpSink> planned;
    std::vector<BitSink> planned_bits;
    // previous decoded frame for concealment
    std::vector<std::vector<int32_t>> last_frame;
    bool key_frame_ok = false;

    void init_slices() {
        slices.assign(p.num_h_slices * p.num_v_slices, SliceState());
        for (auto& s : slices) s.init(p);
        if (p.ac == AC_RANGE_CUSTOM) {
            custom_tab.from_transition(p.state_transition);
            have_custom = true;
        }
    }

    int plane_count_layout() const {
        if (p.colorspace == 1) return 3 + p.transparency;
        int n = 1;
        if (p.chroma_planes) n += 2;
        if (p.transparency) n += 1;
        return n;
    }

    std::vector<PlaneDesc> plane_layout() const {
        std::vector<PlaneDesc> v;
        if (p.colorspace == 0) {
            v.push_back({p.width, p.height});
            if (p.chroma_planes) {
                int cw = (p.width + (1 << p.chroma_h_shift) - 1)
                         >> p.chroma_h_shift;
                int ch = (p.height + (1 << p.chroma_v_shift) - 1)
                         >> p.chroma_v_shift;
                v.push_back({cw, ch});
                v.push_back({cw, ch});
            }
            if (p.transparency) v.push_back({p.width, p.height});
        } else {
            int n = 3 + p.transparency;
            for (int i = 0; i < n; i++) v.push_back({p.width, p.height});
        }
        return v;
    }

    // per-slice views of the frame planes
    std::vector<PlaneView> slice_views(const Rect& r,
                                       const int32_t* const* planes,
                                       int32_t* const* out) const {
        std::vector<PlaneView> v;
        auto layout = plane_layout();
        if (p.colorspace == 0) {
            v.push_back({planes ? planes[0] : nullptr,
                         out ? out[0] : nullptr, layout[0].w, r.x, r.y, r.w,
                         r.h});
            int idx = 1;
            if (p.chroma_planes) {
                int cx = r.x >> p.chroma_h_shift;
                int cy = r.y >> p.chroma_v_shift;
                int cw = (r.w + (1 << p.chroma_h_shift) - 1)
                         >> p.chroma_h_shift;
                int ch = (r.h + (1 << p.chroma_v_shift) - 1)
                         >> p.chroma_v_shift;
                for (int i = 0; i < 2; i++) {
                    v.push_back({planes ? planes[idx] : nullptr,
                                 out ? out[idx] : nullptr, layout[idx].w, cx,
                                 cy, cw, ch});
                    idx++;
                }
            }
            if (p.transparency) {
                v.push_back({planes ? planes[idx] : nullptr,
                             out ? out[idx] : nullptr, layout[idx].w, r.x,
                             r.y, r.w, r.h});
            }
        } else {
            int n = 3 + p.transparency;
            for (int i = 0; i < n; i++)
                v.push_back({planes ? planes[i] : nullptr,
                             out ? out[i] : nullptr, layout[i].w, r.x, r.y,
                             r.w, r.h});
        }
        return v;
    }

    // ---- encode ----

    // choose_rct_params (version 4): L1 cost over 2nd differences
    void choose_rct(SliceState& ss, const std::vector<PlaneView>& pv) {
        static const int kCoeff[15][2] = {
            {0, 0}, {1, 1}, {2, 2}, {0, 2}, {2, 0}, {4, 0}, {0, 4},
            {0, 3}, {3, 0}, {3, 1}, {1, 3}, {1, 2}, {2, 1}, {0, 1}, {1, 0}};
        const int w = pv[0].w, h = pv[0].h;
        long long stat[15] = {0};
        std::vector<int> pg(w), pb_(w), pr(w);
        for (int y = 0; y < h; y++) {
            const int32_t* gs = pv[0].src_row(y);
            const int32_t* bs = pv[1].src_row(y);
            const int32_t* rs = pv[2].src_row(y);
            int lg = 0, lb = 0, lr = 0;
            for (int x = 0; x < w; x++) {
                int ag = gs[x] - lg, ab = bs[x] - lb, ar = rs[x] - lr;
                if (x && y) {
                    int bg = ag - pg[x];
                    int bb = ab - pb_[x];
                    int br = ar - pr[x];
                    br -= bg;
                    bb -= bg;
                    for (int i = 0; i < 15; i++) {
                        long long t =
                            bg + ((br * kCoeff[i][0] + bb * kCoeff[i][1])
                                  >> 2);
                        stat[i] += t < 0 ? -t : t;
                    }
                }
                pg[x] = ag;
                pb_[x] = ab;
                pr[x] = ar;
                lg = gs[x];
                lb = bs[x];
                lr = rs[x];
            }
        }
        int best = 0;
        for (int i = 1; i < 15; i++)
            if (stat[i] < stat[best]) best = i;
        ss.rct_by = kCoeff[best][1];
        ss.rct_ry = kCoeff[best][0];
    }

    // optional precomputed (ctx, diff) streams, one per coded plane
    std::vector<const int32_t*> sym_ctx, sym_diff;

    bool encode_slice_body_sym(int si, RangeEnc& c,
                               std::vector<uint8_t>& obuf,
                               const int32_t* const* planes, bool keyframe,
                               size_t budget) {
        SliceState& ss = slices[si];
        Rect r = slice_rect(p, si);
        if (keyframe) ss.clear(p);
        if (p.version > 2) write_slice_header(c, p, ss, r);

        BitWriter pb;
        pb.attach(&obuf);
        if (p.ac == AC_GOLOMB) {
            if (p.version > 2 || si == 0) c.terminate(p.version > 2 ? 1 : 0);
        }

        auto pv = slice_views(r, planes, nullptr);
        const int n_coded = (int)pv.size();
        int idx = 0;
        auto one = [&](int li, int plane_index, int cbits) {
            size_t k = (size_t)si * n_coded + li;
            SymView sv{sym_ctx[k], sym_diff[k], pv[li].w};
            return encode_plane_sym(p, ss, c, pb, sv, pv[li].w, pv[li].h,
                                    plane_index, cbits, budget, obuf);
        };
        bool ok;
        if (p.colorspace == 1) {
            // RGB: streams already RCT-transformed by phase A; rows
            // interleave across g,b,r,(a) at bits+1
            int rb = (p.bits > 8 ? p.bits : 8) + 1;
            std::vector<SymView> svs;
            for (int li = 0; li < n_coded; li++) {
                size_t k = (size_t)si * n_coded + li;
                svs.push_back(SymView{sym_ctx[k], sym_diff[k], pv[li].w});
            }
            ok = encode_rgb_sym(p, ss, c, pb, svs.data(), n_coded,
                                pv[0].w, pv[0].h, rb, budget, obuf);
        } else {
            ok = one(0, 0, p.bits);
            idx = 1;
            if (ok && p.chroma_planes) {
                ok = one(1, 1, p.bits) && one(2, 1, p.bits);
                idx = 3;
            }
            if (ok && p.transparency) ok = one(idx, 2, p.bits);
        }
        if (!ok) return false;
        if (p.ac == AC_GOLOMB)
            pb.flush();
        else
            c.terminate(1);
        return true;
    }

    bool encode_slice_body(int si, RangeEnc& c, std::vector<uint8_t>& obuf,
                           const int32_t* const* planes, bool keyframe,
                           size_t budget) {
        SliceState& ss = slices[si];
        Rect r = slice_rect(p, si);
        auto pv = slice_views(r, planes, nullptr);

        if (keyframe) ss.clear(p);
        if (p.version > 2) write_slice_header(c, p, ss, r);

        BitWriter pb;
        pb.attach(&obuf);
        if (p.ac == AC_GOLOMB) {
            if (p.version > 2 || si == 0) c.terminate(p.version > 2 ? 1 : 0);
        }

        bool ok;
        if (p.colorspace == 0) {
            ok = encode_plane_t<int16_t>(p, ss, c, pb, pv[0], 0, p.bits,
                                         budget, obuf);
            if (ok && p.chroma_planes) {
                ok = encode_plane_t<int16_t>(p, ss, c, pb, pv[1], 1, p.bits,
                                             budget, obuf) &&
                     encode_plane_t<int16_t>(p, ss, c, pb, pv[2], 1, p.bits,
                                             budget, obuf);
            }
            if (ok && p.transparency)
                ok = encode_plane_t<int16_t>(p, ss, c, pb, pv.back(), 2,
                                             p.bits, budget, obuf);
        } else if (p.use32bit) {
            ok = encode_rgb_t<int32_t>(p, ss, c, pb, pv.data(),
                                       (int)pv.size(), p.bits, budget, obuf);
        } else {
            ok = encode_rgb_t<int16_t>(p, ss, c, pb, pv.data(),
                                       (int)pv.size(), p.bits, budget, obuf);
        }
        if (!ok) return false;
        if (p.ac == AC_GOLOMB)
            pb.flush();
        else
            c.terminate(1);
        return true;
    }

    int64_t encode_frame(const int32_t* const* planes, int keyframe,
                         uint8_t* out, int64_t cap) {
        const int n_slices = (int)slices.size();
        size_t budget =
            (16384 + (size_t)p.width * p.height * 37 * 4) / n_slices;
        if (p.version > 3)
            budget = (16384 + (size_t)p.width * p.height * 3 * 4) / n_slices;
        if (budget_override) budget = budget_override;

        // slice 0 carries the keyframe bit (+ v<2 header)
        std::vector<std::vector<uint8_t>> chunks(n_slices);
        bool fail = false;

        if (stats_mode && slice_stats.empty()) {
            slice_stats.resize(slices.size());
            for (auto& st : slice_stats)
                st.init(p.context_counts[p.context_model]);
        }
        if (keyframe) gob_count++;

        auto encode_one = [&](int si) {
            SliceState& ss = slices[si];
            ss.stats = stats_mode ? &slice_stats[si] : nullptr;
            ss.coding_mode = 0;
            Rect r = slice_rect(p, si);
            if (p.version > 3 && p.colorspace == 1) {
                auto pv = slice_views(r, planes, nullptr);
                choose_rct(ss, pv);
            } else {
                ss.rct_by = ss.rct_ry = 1;
            }
            for (int attempt = 0; attempt < 2; attempt++) {
                std::vector<uint8_t> obuf;
                RangeEnc c;
                c.attach(&obuf);
                if (si == 0) {
                    uint8_t key_state = 128;
                    c.put(&key_state, keyframe ? 1 : 0);
                    if (keyframe && p.version < 2) write_v01_header(c, p);
                    // (version 2 in-band slice tables unsupported: the
                    //  encoder never emits version 2, matching the
                    //  reference's "experimental" gating)
                    if (p.ac == AC_RANGE_CUSTOM) c.tab = &custom_tab;
                } else if (p.ac == AC_RANGE_CUSTOM) {
                    c.tab = &custom_tab;
                }
                // PCM retry codes raw samples: use the plane path then
                bool done = (!sym_ctx.empty() && slices[si].coding_mode == 0)
                    ? encode_slice_body_sym(si, c, obuf, planes, keyframe,
                                            budget)
                    : encode_slice_body(si, c, obuf, planes, keyframe,
                                        budget);
                if (done) {
                    chunks[si] = std::move(obuf);
                    return;
                }
                if (p.version < 4 || p.ac == AC_GOLOMB) {
                    fail = true;
                    return;
                }
                slices[si].coding_mode = 1;
            }
            fail = true;
        };

        if (n_threads > 1 && n_slices > 1) {
            std::vector<std::thread> pool;
            std::atomic_int next{0};
            int nt = std::min(n_threads, n_slices);
            for (int t = 0; t < nt; t++)
                pool.emplace_back([&] {
                    for (;;) {
                        int si = next.fetch_add(1);
                        if (si >= n_slices) break;
                        encode_one(si);
                    }
                });
            for (auto& th : pool) th.join();
        } else {
            for (int si = 0; si < n_slices; si++) encode_one(si);
        }
        if (fail) return -1;

        // assemble packet with size/CRC trailers
        int64_t pos = 0;
        for (int si = 0; si < n_slices; si++) {
            auto& d = chunks[si];
            size_t bytes = d.size();
            if (si > 0 || p.version > 2) {
                d.push_back((uint8_t)(bytes >> 16));
                d.push_back((uint8_t)(bytes >> 8));
                d.push_back((uint8_t)bytes);
                if (p.ec) {
                    d.push_back(0);
                    uint32_t crc = g_crc.run(d.data(), d.size());
                    for (int k = 0; k < 4; k++)
                        d.push_back((uint8_t)(crc >> (8 * k)));
                }
            }
            if (pos + (int64_t)d.size() > cap) return -1;
            std::memcpy(out + pos, d.data(), d.size());
            pos += d.size();
        }
        return pos;
    }

    // ---- op planning (range-coder modes; see tpu_coder.py) ----

    // plans the ops for every slice of one frame; slice 0 includes the
    // keyframe bit (+ v<2 header).  Uses and ADVANCES the persistent
    // adaptive states exactly like a real encode.
    bool plan_frame_ops(const int32_t* const* planes, int keyframe,
                        std::vector<OpSink>& sinks) {
        if (p.ac == AC_GOLOMB) return false;
        const RacTables& tab = p.ac == AC_RANGE_CUSTOM ? custom_tab
                                                       : default_tables();
        const RacTables& def = default_tables();
        if (keyframe) gob_count++;
        if (stats_mode && slice_stats.empty()) {
            slice_stats.resize(slices.size());
            for (auto& st : slice_stats)
                st.init(p.context_counts[p.context_model]);
        }
        sinks.assign(slices.size(), OpSink());
        for (int si = 0; si < (int)slices.size(); si++) {
            OpSink& o = sinks[si];
            SliceState& ss = slices[si];
            ss.stats = stats_mode ? &slice_stats[si] : nullptr;
            ss.coding_mode = 0;
            Rect r = slice_rect(p, si);
            if (p.version > 3 && p.colorspace == 1) {
                auto pv = slice_views(r, planes, nullptr);
                choose_rct(ss, pv);
            } else {
                ss.rct_by = ss.rct_ry = 1;
            }
            if (si == 0) {
                uint8_t key_state = 128;
                // keyframe bit + v<2 header use the default tables
                o.put(&key_state, keyframe ? 1 : 0, def);
                if (keyframe && p.version < 2) {
                    // v<2 header ops (default tables)
                    PlanEnc pe{&o, &def};
                    write_v01_header_ops(pe);
                }
            }
            if (keyframe) ss.clear(p);
            if (p.version > 2) {
                // slice header ops with the slice tables
                uint8_t st[kContextSize];
                std::memset(st, 128, sizeof(st));
                plan_slice_header(o, ss, r, st, tab);
            }
            // plane data
            auto pv = slice_views(r, planes, nullptr);
            bool ok = true;
            if (p.colorspace == 0) {
                ok = plan_plane<int16_t>(o, ss, pv[0], 0, tab);
                if (ok && p.chroma_planes)
                    ok = plan_plane<int16_t>(o, ss, pv[1], 1, tab) &&
                         plan_plane<int16_t>(o, ss, pv[2], 1, tab);
                if (ok && p.transparency)
                    ok = plan_plane<int16_t>(o, ss, pv.back(), 2, tab);
            } else if (p.use32bit) {
                ok = plan_rgb<int32_t>(o, ss, pv.data(), (int)pv.size(), tab);
            } else {
                ok = plan_rgb<int16_t>(o, ss, pv.data(), (int)pv.size(), tab);
            }
            if (!ok) return false;
            // terminator bit (version-1 termination, state 129)
            uint8_t t129 = 129;
            o.put(&t129, 0, tab);
        }
        return true;
    }

    struct PlanEnc {
        OpSink* o;
        const RacTables* tab;
    };

    void write_v01_header_ops(PlanEnc& pe) {
        uint8_t st[kContextSize];
        std::memset(st, 128, sizeof(st));
        auto sym = [&](int v, bool sgn) {
            plan_symbol(*pe.o, st, v, sgn, *pe.tab);
        };
        sym(p.version, false);
        sym(p.ac, false);
        if (p.ac == AC_RANGE_CUSTOM)
            for (int i = 1; i < 256; i++)
                sym(p.state_transition[i] - default_tables().one[i], true);
        sym(p.colorspace, false);
        if (p.version > 0) sym(p.bits, false);
        pe.o->put(st, p.chroma_planes, *pe.tab);
        sym(p.chroma_h_shift, false);
        sym(p.chroma_v_shift, false);
        pe.o->put(st, p.transparency, *pe.tab);
        for (int t = 0; t < 5; t++) {
            const int16_t* tabq = p.quant_tables[p.context_model][t];
            uint8_t qst[kContextSize];
            std::memset(qst, 128, sizeof(qst));
            int last = 0;
            for (int i = 1; i < 128; i++)
                if (tabq[i] != tabq[i - 1]) {
                    plan_symbol(*pe.o, qst, i - last - 1, false, *pe.tab);
                    last = i;
                }
            plan_symbol(*pe.o, qst, 128 - last - 1, false, *pe.tab);
        }
    }

    void plan_slice_header(OpSink& o, SliceState& ss, const Rect& r,
                           uint8_t* st, const RacTables& tab) {
        auto sym = [&](int v) { plan_symbol(o, st, v, false, tab); };
        sym((r.x + 1) * p.num_h_slices / p.width);
        sym((r.y + 1) * p.num_v_slices / p.height);
        sym((r.w + 1) * p.num_h_slices / p.width - 1);
        sym((r.h + 1) * p.num_v_slices / p.height - 1);
        for (int j = 0; j < p.plane_count; j++) sym(ss.qt_index[j]);
        sym(3);
        sym(0);
        sym(1);
        if (p.version > 3) {
            o.put(st, ss.coding_mode == 1, tab);
            sym(ss.coding_mode);
            if (ss.coding_mode != 1) {
                sym(ss.rct_by);
                sym(ss.rct_ry);
            }
        }
    }

    template <typename T>
    bool plan_plane(OpSink& o, SliceState& ss, const PlaneView& pv,
                    int plane_index, const RacTables& tab) {
        LineCodec<T> lc(p, ss);
        const int w = pv.w, h = pv.h;
        const int ring = p.context_model ? 3 : 2;
        RowRing<T> rb(w, ring);
        ss.run_index = 0;
        const int16_t(*qt)[256] = p.quant_tables[ss.qt_index[plane_index]];
        uint8_t* states = ss.states[plane_index].data();
        for (int y = 0; y < h; y++) {
            o.mark_row(w);
            T* cur = rb.row((h + 0 - y) % ring);
            T* prev = rb.row((h + 1 - y) % ring);
            T* prev2 = ring == 3 ? rb.row((h + 2 - y) % ring) : cur;
            const int32_t* src = pv.src_row(y);
            for (int x = 0; x < w; x++) cur[x] = (T)src[x];
            cur[-1] = prev[0];
            prev[w] = prev[w - 1];
            for (int x = 0; x < w; x++) {
                int context = lc.ctx5(qt, cur, prev, prev2, x);
                int diff = cur[x] - lc.pred(cur, prev, x);
                if (context < 0) { context = -context; diff = -diff; }
                diff = fold(diff, p.bits);
                plan_symbol(o, states + (size_t)context * kContextSize,
                            diff, true, tab, ss.stats,
                            (size_t)context * kContextSize);
            }
        }
        return true;
    }

    // RGB planning: encode_rgb_t's RCT + per-row plane interleave with
    // plan_symbol sinks.  PCM fallback (v4 budget overflow) is not
    // planned -- pathological content stays on the host encoder.
    template <typename T>
    bool plan_rgb(OpSink& o, SliceState& ss, const PlaneView* pv,
                  int nplanes, const RacTables& tab) {
        LineCodec<T> lc(p, ss);
        const int w = pv[0].w, h = pv[0].h;
        const bool lbd = p.bits <= 8;
        const int bits = p.bits;
        const int offset = 1 << bits;
        const int ring = p.context_model ? 3 : 2;
        std::array<std::unique_ptr<RowRing<T>>, 4> rings;
        for (int i = 0; i < 4; i++)
            rings[i] = std::make_unique<RowRing<T>>(w, ring);
        ss.run_index = 0;
        for (int y = 0; y < h; y++) {
            T* cur[4];
            T* prev[4];
            T* prev2[4];
            for (int pl = 0; pl < 4; pl++) {
                cur[pl] = rings[pl]->row((h + 0 - y) % ring);
                prev[pl] = rings[pl]->row((h + 1 - y) % ring);
                prev2[pl] = ring == 3 ? rings[pl]->row((h + 2 - y) % ring)
                                      : cur[pl];
            }
            const bool swap = gb_swapped(p);
            const int32_t* gs = pv[swap ? 1 : 0].src_row(y);
            const int32_t* bs = pv[swap ? 0 : 1].src_row(y);
            const int32_t* rs = pv[2].src_row(y);
            const int32_t* as = nplanes > 3 ? pv[3].src_row(y) : nullptr;
            for (int x = 0; x < w; x++) {
                int g = gs[x], b = bs[x], r = rs[x];
                b -= g;
                r -= g;
                g += (b * ss.rct_by + r * ss.rct_ry) >> 2;
                b += offset;
                r += offset;
                cur[0][x] = (T)g;
                cur[1][x] = (T)b;
                cur[2][x] = (T)r;
                if (as) cur[3][x] = (T)as[x];
            }
            for (int pl = 0; pl < nplanes; pl++) {
                o.mark_row(w);
                cur[pl][-1] = prev[pl][0];
                prev[pl][w] = prev[pl][w - 1];
                int plane_index = (pl + 1) / 2;
                const int16_t(*qt)[256] =
                    p.quant_tables[ss.qt_index[plane_index]];
                uint8_t* states = ss.states[plane_index].data();
                int eff_bits = lbd ? 9 : bits + 1;
                for (int x = 0; x < w; x++) {
                    int context =
                        lc.ctx5(qt, cur[pl], prev[pl], prev2[pl], x);
                    int diff = cur[pl][x] - lc.pred(cur[pl], prev[pl], x);
                    if (context < 0) { context = -context; diff = -diff; }
                    diff = fold(diff, eff_bits);
                    plan_symbol(o,
                                states + (size_t)context * kContextSize,
                                diff, true, tab, ss.stats,
                                (size_t)context * kContextSize);
                }
            }
        }
        return true;
    }

    // PCM replan (v4 budget-overflow fallback, ffv1enc.c:1107-1117):
    // rebuild one slice's ops with slice_coding_mode=1 — header (with
    // the raw-PCM flag, which clears the slice state), then every sample
    // as fixed p=128 bits (put_fixed semantics: a throwaway state per
    // bit, so every op is (sv=128, bit) with no adaptation).
    bool plan_pcm_slice(int si, const int32_t* const* planes, int keyframe,
                        std::vector<OpSink>& sinks) {
        if (p.version < 4 || p.ac == AC_GOLOMB) return false;
        const RacTables& tab = p.ac == AC_RANGE_CUSTOM ? custom_tab
                                                       : default_tables();
        const RacTables& def = default_tables();
        OpSink o;
        SliceState& ss = slices[si];
        ss.coding_mode = 1;
        Rect r = slice_rect(p, si);
        if (si == 0) {
            uint8_t key_state = 128;
            o.put(&key_state, keyframe ? 1 : 0, def);
        }
        ss.clear(p);
        uint8_t st[kContextSize];
        std::memset(st, 128, sizeof(st));
        plan_slice_header(o, ss, r, st, tab);
        auto pv = slice_views(r, planes, nullptr);
        auto raw_plane = [&](const PlaneView& v, int bits_) {
            for (int y = 0; y < v.h; y++) {
                o.mark_row(v.w);
                const int32_t* src = v.src_row(y);
                for (int x = 0; x < v.w; x++)
                    for (int i = bits_ - 1; i >= 0; i--) {
                        uint8_t fixed = 128;
                        o.put(&fixed, (src[x] >> i) & 1, tab);
                    }
            }
        };
        if (p.colorspace == 0) {
            for (auto& v : pv) raw_plane(v, p.bits);
        } else {
            // raw interleaved rows, no RCT (encode_rgb coding_mode 1)
            const bool swap = gb_swapped(p);
            int order[4] = {swap ? 1 : 0, swap ? 0 : 1, 2, 3};
            for (int y = 0; y < pv[0].h; y++)
                for (int pl = 0; pl < (int)pv.size(); pl++) {
                    o.mark_row(pv[0].w);
                    const int32_t* src = pv[order[pl]].src_row(y);
                    for (int x = 0; x < pv[0].w; x++)
                        for (int i = p.bits - 1; i >= 0; i--) {
                            uint8_t fixed = 128;
                            o.put(&fixed, (src[x] >> i) & 1, tab);
                        }
                }
        }
        uint8_t t129 = 129;
        o.put(&t129, 0, tab);
        sinks[si] = std::move(o);
        return true;
    }

    // golomb-mode line planning: the exact encode_line run-ladder +
    // Rice logic, emitting (value, nbits) pairs instead of writing bits
    template <typename T>
    void plan_line_golomb(BitSink& b, SliceState& ss, LineCodec<T>& lc,
                          const int16_t (*qt)[256], VlcState* vlc, int w,
                          T* cur, const T* prev, const T* prev2, int bits) {
        int run_index = ss.run_index, run_count = 0, run_mode = 0;
        for (int x = 0; x < w; x++) {
            int context = lc.ctx5(qt, cur, prev, prev2, x);
            int diff = cur[x] - lc.pred(cur, prev, x);
            if (context < 0) { context = -context; diff = -diff; }
            diff = fold(diff, bits);
            if (context == 0) run_mode = 1;
            if (run_mode) {
                if (diff) {
                    while (run_count >= 1 << kLog2Run[run_index]) {
                        run_count -= 1 << kLog2Run[run_index];
                        run_index++;
                        b.put(1, 1);
                    }
                    b.put(1 + kLog2Run[run_index], run_count);
                    if (run_index) run_index--;
                    run_count = 0;
                    run_mode = 0;
                    if (diff > 0) diff--;
                } else {
                    run_count++;
                }
            }
            if (run_mode == 0)
                plan_vlc_symbol(b, vlc[context], diff, bits);
        }
        if (run_mode) {
            while (run_count >= 1 << kLog2Run[run_index]) {
                run_count -= 1 << kLog2Run[run_index];
                run_index++;
                b.put(1, 1);
            }
            if (run_count) b.put(1, 1);
        }
        ss.run_index = run_index;
    }

    template <typename T>
    bool plan_plane_golomb(BitSink& b, SliceState& ss, const PlaneView& pv,
                           int plane_index, int bits) {
        LineCodec<T> lc(p, ss);
        const int w = pv.w, h = pv.h;
        const int ring = p.context_model ? 3 : 2;
        RowRing<T> rb(w, ring);
        ss.run_index = 0;
        const int16_t(*qt)[256] = p.quant_tables[ss.qt_index[plane_index]];
        VlcState* vlc = ss.vlc[plane_index].data();
        for (int y = 0; y < h; y++) {
            T* cur = rb.row((h + 0 - y) % ring);
            T* prev = rb.row((h + 1 - y) % ring);
            T* prev2 = ring == 3 ? rb.row((h + 2 - y) % ring) : cur;
            const int32_t* src = pv.src_row(y);
            for (int x = 0; x < w; x++) cur[x] = (T)src[x];
            cur[-1] = prev[0];
            prev[w] = prev[w - 1];
            plan_line_golomb(b, ss, lc, qt, vlc, w, cur, prev, prev2, bits);
        }
        return true;
    }

    template <typename T>
    bool plan_rgb_golomb(BitSink& b, SliceState& ss, const PlaneView* pv,
                         int nplanes, int bits) {
        LineCodec<T> lc(p, ss);
        const int w = pv[0].w, h = pv[0].h;
        const bool lbd = p.bits <= 8;
        const int offset = 1 << bits;
        const int ring = p.context_model ? 3 : 2;
        std::array<std::unique_ptr<RowRing<T>>, 4> rings;
        for (int i = 0; i < 4; i++)
            rings[i] = std::make_unique<RowRing<T>>(w, ring);
        ss.run_index = 0;
        for (int y = 0; y < h; y++) {
            T* cur[4];
            T* prev[4];
            T* prev2[4];
            for (int pl = 0; pl < 4; pl++) {
                cur[pl] = rings[pl]->row((h + 0 - y) % ring);
                prev[pl] = rings[pl]->row((h + 1 - y) % ring);
                prev2[pl] = ring == 3 ? rings[pl]->row((h + 2 - y) % ring)
                                      : cur[pl];
            }
            const bool swap = gb_swapped(p);
            const int32_t* gs = pv[swap ? 1 : 0].src_row(y);
            const int32_t* bs = pv[swap ? 0 : 1].src_row(y);
            const int32_t* rs = pv[2].src_row(y);
            const int32_t* as = nplanes > 3 ? pv[3].src_row(y) : nullptr;
            for (int x = 0; x < w; x++) {
                int g = gs[x], bb = bs[x], r = rs[x];
                bb -= g;
                r -= g;
                g += (bb * ss.rct_by + r * ss.rct_ry) >> 2;
                bb += offset;
                r += offset;
                cur[0][x] = (T)g;
                cur[1][x] = (T)bb;
                cur[2][x] = (T)r;
                if (as) cur[3][x] = (T)as[x];
            }
            for (int pl = 0; pl < nplanes; pl++) {
                cur[pl][-1] = prev[pl][0];
                prev[pl][w] = prev[pl][w - 1];
                int plane_index = (pl + 1) / 2;
                const int16_t(*qt)[256] =
                    p.quant_tables[ss.qt_index[plane_index]];
                VlcState* vlc = ss.vlc[plane_index].data();
                int eff_bits = lbd ? 9 : bits + 1;
                plan_line_golomb(b, ss, lc, qt, vlc, w, cur[pl], prev[pl],
                                 prev2[pl], eff_bits);
            }
        }
        return true;
    }

    bool plan_frame_ops_golomb(const int32_t* const* planes, int keyframe,
                               std::vector<OpSink>& sinks,
                               std::vector<BitSink>& bsinks) {
        if (p.ac != AC_GOLOMB) return false;
        const RacTables& def = default_tables();
        if (keyframe) gob_count++;
        sinks.assign(slices.size(), OpSink());
        bsinks.assign(slices.size(), BitSink());
        for (int si = 0; si < (int)slices.size(); si++) {
            OpSink& o = sinks[si];
            BitSink& b = bsinks[si];
            SliceState& ss = slices[si];
            ss.coding_mode = 0;
            Rect r = slice_rect(p, si);
            if (p.version > 3 && p.colorspace == 1) {
                auto rpv = slice_views(r, planes, nullptr);
                choose_rct(ss, rpv);
            } else {
                ss.rct_by = ss.rct_ry = 1;
            }
            if (si == 0) {
                uint8_t key_state = 128;
                o.put(&key_state, keyframe ? 1 : 0, def);
                if (keyframe && p.version < 2) {
                    PlanEnc pe{&o, &def};
                    write_v01_header_ops(pe);
                }
            }
            if (keyframe) ss.clear(p);
            if (p.version > 2) {
                uint8_t st[kContextSize];
                std::memset(st, 128, sizeof(st));
                plan_slice_header(o, ss, r, st, def);
                // v>2 golomb slices terminate the header coder with the
                // version-1 terminator (state-129 zero bit)
                uint8_t t129 = 129;
                o.put(&t129, 0, def);
            }
            auto pv = slice_views(r, planes, nullptr);
            bool ok;
            if (p.colorspace == 0) {
                ok = plan_plane_golomb<int16_t>(b, ss, pv[0], 0, p.bits);
                if (ok && p.chroma_planes)
                    ok = plan_plane_golomb<int16_t>(b, ss, pv[1], 1,
                                                    p.bits) &&
                         plan_plane_golomb<int16_t>(b, ss, pv[2], 1,
                                                    p.bits);
                if (ok && p.transparency)
                    ok = plan_plane_golomb<int16_t>(b, ss, pv.back(), 2,
                                                    p.bits);
            } else if (p.use32bit) {
                ok = plan_rgb_golomb<int32_t>(b, ss, pv.data(),
                                              (int)pv.size(), p.bits);
            } else {
                ok = plan_rgb_golomb<int16_t>(b, ss, pv.data(),
                                              (int)pv.size(), p.bits);
            }
            if (!ok) return false;
        }
        return true;
    }

    // ---- decode ----

    struct Region { int64_t off, len; };

    // One slice of one frame.  main_c = the packet-head range coder just
    // past the keyframe bit (slice 0 continues it — the reference shares
    // the frame header's coder with slice 0, ffv1dec.c decode_frame).
    // Returns false if the slice is damaged (CRC, header, or slack).
    bool decode_slice_impl(int si, const uint8_t* pkt, const Region& reg,
                           int keyframe, const RangeDec& main_c,
                           int32_t* const* out_planes) {
        SliceState& ss = slices[si];
        ss.damaged = false;
        const uint8_t* sp = pkt + reg.off;
        size_t slen = (size_t)reg.len;
        if (p.ec && g_crc.run(sp, slen) != 0) return false;
        RangeDec sc;
        if (si == 0) {
            sc = main_c;
            sc.end = (size_t)(reg.off + reg.len);
        } else {
            sc.init(sp, slen);
        }
        if (p.ac == AC_RANGE_CUSTOM) sc.tab = &custom_tab;

        ss.rct_by = ss.rct_ry = 1;
        ss.coding_mode = 0;
        Rect r = slice_rect(p, si);
        if (p.version > 2) {
            if (!read_slice_header(sc, p, ss, r)) return false;
        }
        if (keyframe || ss.reset_contexts) ss.clear(p);

        BitReader gb;
        if (p.ac == AC_GOLOMB) {
            if ((p.version == 3 && p.micro_version > 1) || p.version > 3)
                sc.get_fixed(129);
            size_t start =
                (p.version > 2 || si == 0) ? sc.pos - 1 : 0;
            gb.init(sc.buf, sc.end, start);
        }

        auto pv = slice_views(r, nullptr, out_planes);
        bool good;
        if (p.colorspace == 0) {
            good = decode_plane_t<int16_t>(p, ss, sc, gb, pv[0], 0,
                                           p.bits);
            if (good && p.chroma_planes)
                good = decode_plane_t<int16_t>(p, ss, sc, gb, pv[1], 1,
                                               p.bits) &&
                       decode_plane_t<int16_t>(p, ss, sc, gb, pv[2], 1,
                                               p.bits);
            if (good && p.transparency) {
                int pi = (p.version >= 4 && !p.chroma_planes) ? 1 : 2;
                good = decode_plane_t<int16_t>(p, ss, sc, gb, pv.back(),
                                               pi, p.bits);
            }
        } else if (p.use32bit) {
            good = decode_rgb_t<int32_t>(p, ss, sc, gb, pv.data(),
                                         (int)pv.size(), p.bits);
        } else {
            good = decode_rgb_t<int16_t>(p, ss, sc, gb, pv.data(),
                                         (int)pv.size(), p.bits);
        }
        if (!good) return false;
        if (p.ac != AC_GOLOMB && p.version > 2) {
            sc.get_fixed(129);
            int64_t slack =
                (int64_t)sc.end - (int64_t)sc.pos - 2 - 5 * p.ec;
            if (slack) return false;
        }
        return true;
    }

    int decode_frame(const uint8_t* pkt, int64_t size,
                     int32_t* const* out_planes) {
        RangeDec c;
        c.tab = &default_tables();
        c.init(pkt, (size_t)size);
        uint8_t key_state = 128;
        int keyframe = c.get(&key_state);

        if (keyframe) {
            key_frame_ok = false;
            if (p.version < 2) {
                Params np = p;  // keep width/height/bits defaults
                if (!read_v01_header(c, np)) return -1;
                bool relayout =
                    slices.empty() || np.ac != p.ac ||
                    np.context_counts[0] != p.context_counts[0] ||
                    np.plane_count != p.plane_count;
                p = np;
                if (relayout) init_slices();
            }
            key_frame_ok = true;
        } else if (!key_frame_ok) {
            return -1;
        }

        const int n_slices = (int)slices.size();
        const int trailer = 3 + 5 * (p.ec ? 1 : 0);

        std::vector<Region> regions;
        if (p.version >= 3) {
            int64_t end = size;
            while ((int)regions.size() < 1024 && trailer < end) {
                int64_t sz = ((int64_t)pkt[end - trailer] << 16) |
                             ((int64_t)pkt[end - trailer + 1] << 8) |
                             pkt[end - trailer + 2];
                if (sz + trailer > end) break;
                regions.push_back({end - sz - trailer, sz + trailer});
                end -= sz + trailer;
            }
            std::reverse(regions.begin(), regions.end());
            if ((int)regions.size() != n_slices) return -2;
        } else {
            regions.push_back({0, size});
        }

        std::vector<int> ok(n_slices, 1);

        auto decode_one = [&](int si) {
            ok[si] = decode_slice_impl(si, pkt, regions[si], keyframe, c,
                                       out_planes) ? 1 : 0;
        };

        if (n_threads > 1 && n_slices > 1) {
            std::vector<std::thread> pool;
            std::atomic_int next{0};
            int nt = std::min(n_threads, n_slices);
            for (int t = 0; t < nt; t++)
                pool.emplace_back([&] {
                    for (;;) {
                        int si = next.fetch_add(1);
                        if (si >= n_slices) break;
                        decode_one(si);
                    }
                });
            for (auto& th : pool) th.join();
        } else {
            for (int si = 0; si < n_slices; si++) decode_one(si);
        }

        // concealment + remember frame
        auto layout = plane_layout();
        bool have_last = !last_frame.empty();
        for (int si = 0; si < n_slices; si++) {
            slices[si].damaged = !ok[si];
            if (!ok[si] && have_last) {
                Rect r = slice_rect(p, si);
                auto dst = slice_views(r, nullptr, out_planes);
                for (size_t pi = 0; pi < dst.size(); pi++) {
                    const int32_t* lp = last_frame[pi].data();
                    for (int y = 0; y < dst[pi].h; y++) {
                        std::memcpy(
                            dst[pi].dst_row(y),
                            lp + (size_t)(dst[pi].y0 + y) * dst[pi].stride +
                                dst[pi].x0,
                            sizeof(int32_t) * dst[pi].w);
                    }
                }
            }
        }
        if (last_frame.size() != layout.size())
            last_frame.assign(layout.size(), {});
        for (size_t pi = 0; pi < layout.size(); pi++) {
            size_t n = (size_t)layout[pi].w * layout[pi].h;
            last_frame[pi].assign(out_planes[pi], out_planes[pi] + n);
        }

        int any_damaged = 0;
        for (auto& s : slices)
            if (s.damaged) any_damaged = 1;
        return any_damaged ? 1 : 0;
    }

    // Frame-pipelined decode — the frame-thread analogue
    // (pthread_frame.c:473,558; ffv1dec.c progress waits): consecutive
    // frames decode concurrently, slice s of frame t+1 gated on slice s
    // of frame t (adaptive contexts carry across non-key frames; slices
    // never read across slice boundaries).  Expressed as slice-column
    // chains: a worker owns whole slices and streams through the frames,
    // so the per-slice order constraint costs zero synchronisation and
    // the slice's context state stays hot in cache.  Scales with
    // min(threads, slices) even inside a single GOP — unlike GOP
    // batching, an all-inter stream parallelises fully.  v<3 packets
    // (single region, v0/1 in-band relayout headers) fall back to the
    // sequential path.
    int decode_frames_pipelined(const uint8_t* const* pkts,
                                const int64_t* sizes, int n_frames,
                                int32_t* const* outs, int n_planes,
                                int32_t* status) {
        auto layout = plane_layout();
        if ((int)layout.size() != n_planes) return -3;
        if (p.version < 3) {
            for (int t = 0; t < n_frames; t++)
                status[t] = decode_frame(pkts[t], sizes[t],
                                         outs + (size_t)t * n_planes);
            return 0;
        }
        const int n_slices = (int)slices.size();
        const int trailer = 3 + 5 * (p.ec ? 1 : 0);
        // sequential prologue: keyframe bit + slice region table walk
        // per frame (cheap — no entropy decode)
        std::vector<std::vector<Region>> regions(n_frames);
        std::vector<RangeDec> c0(n_frames);
        std::vector<int> keyf(n_frames), valid(n_frames, 1);
        for (int t = 0; t < n_frames; t++) {
            RangeDec c;
            c.tab = &default_tables();
            c.init(pkts[t], (size_t)sizes[t]);
            uint8_t key_state = 128;
            keyf[t] = c.get(&key_state);
            if (keyf[t]) key_frame_ok = true;
            else if (!key_frame_ok) valid[t] = 0;
            int64_t end = sizes[t];
            auto& rg = regions[t];
            const uint8_t* pkt = pkts[t];
            while ((int)rg.size() < 1024 && trailer < end) {
                int64_t sz = ((int64_t)pkt[end - trailer] << 16) |
                             ((int64_t)pkt[end - trailer + 1] << 8) |
                             pkt[end - trailer + 2];
                if (sz + trailer > end) break;
                rg.push_back({end - sz - trailer, sz + trailer});
                end -= sz + trailer;
            }
            std::reverse(rg.begin(), rg.end());
            if ((int)rg.size() != n_slices) valid[t] = 0;
            c0[t] = c;
        }
        std::vector<uint8_t> dmg((size_t)n_frames * n_slices, 0);
        auto run_column = [&](int si) {
            Rect r = slice_rect(p, si);
            for (int t = 0; t < n_frames; t++) {
                int32_t* const* out = outs + (size_t)t * n_planes;
                bool good = valid[t] &&
                    decode_slice_impl(si, pkts[t], regions[t][si],
                                      keyf[t], c0[t], out);
                if (good) continue;
                dmg[(size_t)t * n_slices + si] = 1;
                // conceal from the co-located slice of the previous
                // frame's output (already complete in this chain)
                auto dst = slice_views(r, nullptr, out);
                for (size_t pi = 0; pi < dst.size(); pi++) {
                    const int32_t* lp = nullptr;
                    if (t > 0)
                        lp = outs[(size_t)(t - 1) * n_planes + pi];
                    else if (pi < last_frame.size() &&
                             !last_frame[pi].empty())
                        lp = last_frame[pi].data();
                    if (!lp) continue;
                    for (int y = 0; y < dst[pi].h; y++)
                        std::memcpy(
                            dst[pi].dst_row(y),
                            lp + (size_t)(dst[pi].y0 + y) * dst[pi].stride +
                                dst[pi].x0,
                            sizeof(int32_t) * dst[pi].w);
                }
            }
        };
        if (n_threads > 1 && n_slices > 1 && n_frames > 0) {
            std::vector<std::thread> pool;
            std::atomic_int next{0};
            int nt = std::min(n_threads, n_slices);
            for (int t = 0; t < nt; t++)
                pool.emplace_back([&] {
                    for (;;) {
                        int si = next.fetch_add(1);
                        if (si >= n_slices) break;
                        run_column(si);
                    }
                });
            for (auto& th : pool) th.join();
        } else {
            for (int si = 0; si < n_slices; si++) run_column(si);
        }
        if (n_frames > 0) {
            for (int si = 0; si < n_slices; si++)
                slices[si].damaged =
                    dmg[(size_t)(n_frames - 1) * n_slices + si] != 0;
            int32_t* const* fin = outs + (size_t)(n_frames - 1) * n_planes;
            if (last_frame.size() != layout.size())
                last_frame.assign(layout.size(), {});
            for (size_t pi = 0; pi < layout.size(); pi++) {
                size_t n = (size_t)layout[pi].w * layout[pi].h;
                last_frame[pi].assign(fin[pi], fin[pi] + n);
            }
        }
        for (int t = 0; t < n_frames; t++) {
            if (!valid[t]) { status[t] = -2; continue; }
            int any = 0;
            for (int si = 0; si < n_slices; si++)
                any |= dmg[(size_t)t * n_slices + si];
            status[t] = any;
        }
        return 0;
    }
};

// 2-pass optimization (pass-2 open time): state-table sort and best-initial-
// state search (ffv1enc.c:sort_stt / find_best_state semantics)
// ---------------------------------------------------------------------------

static double cost_bits(uint64_t n0, uint64_t n1, int st) {
    return n0 * -std::log2((256.0 - st) / 256.0) +
           n1 * -std::log2(st / 256.0);
}

static int twopass_sort_stt(uint64_t rc_stat[256][2], uint8_t stt[256]) {
    int changed_any = 0;
    int changed;
    do {
        changed = 0;
        for (int i = 12; i < 244; i++) {
            for (int i2 = i + 1; i2 < 245 && i2 < i + 4; i2++) {
                auto cost2 = [&](int oldv, int newv) {
                    return cost_bits(rc_stat[oldv][0], rc_stat[oldv][1], newv)
                         + cost_bits(rc_stat[256 - oldv][0],
                                     rc_stat[256 - oldv][1], 256 - newv);
                };
                double size0 = cost2(i, i) + cost2(i2, i2);
                double sizeX = cost2(i, i2) + cost2(i2, i);
                if (size0 - sizeX > size0 * 1e-14 && i != 128 && i2 != 128) {
                    std::swap(stt[i], stt[i2]);
                    std::swap(rc_stat[i][0], rc_stat[i2][0]);
                    std::swap(rc_stat[i][1], rc_stat[i2][1]);
                    if (i != 256 - i2) {
                        std::swap(stt[256 - i], stt[256 - i2]);
                        std::swap(rc_stat[256 - i][0], rc_stat[256 - i2][0]);
                        std::swap(rc_stat[256 - i][1], rc_stat[256 - i2][1]);
                    }
                    for (int j = 1; j < 256; j++) {
                        if (stt[j] == i) stt[j] = (uint8_t)i2;
                        else if (stt[j] == i2) stt[j] = (uint8_t)i;
                        if (i != 256 - i2) {
                            if (stt[256 - j] == 256 - i)
                                stt[256 - j] = (uint8_t)(256 - i2);
                            else if (stt[256 - j] == 256 - i2)
                                stt[256 - j] = (uint8_t)(256 - i);
                        }
                    }
                    changed = changed_any = 1;
                }
            }
        }
    } while (changed);
    return changed_any;
}

static void twopass_find_best_state(uint8_t best_state[256][256],
                                    const uint8_t one_state[256]) {
    double l2tab[256];
    for (int i = 1; i < 256; i++) l2tab[i] = std::log2(i / 256.0);
    for (int i = 0; i < 256; i++) {
        double best_len[256];
        const double pr = i / 256.0;
        for (int j = 0; j < 256; j++) best_len[j] = 1 << 30;
        for (int j = std::max(i - 10, 1); j < std::min(i + 11, 256); j++) {
            if (!one_state[j]) continue;
            double occ[256] = {0};
            double len = 0;
            occ[j] = 1.0;
            for (int k = 0; k < 256; k++) {
                double newocc[256] = {0};
                for (int m = 1; m < 256; m++)
                    if (occ[m])
                        len -= occ[m] * (pr * l2tab[m]
                                         + (1 - pr) * l2tab[256 - m]);
                if (len < best_len[k]) {
                    best_len[k] = len;
                    best_state[i][k] = (uint8_t)j;
                }
                for (int m = 1; m < 256; m++)
                    if (occ[m]) {
                        newocc[one_state[m]] += occ[m] * pr;
                        newocc[256 - one_state[256 - m]] += occ[m] * (1 - pr);
                    }
                std::memcpy(occ, newocc, sizeof(occ));
            }
        }
    }
}

}  // namespace f2t

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct FFV1ParamsC {
    int32_t version, micro_version;
    int32_t width, height;
    int32_t colorspace, bits;
    int32_t chroma_planes, chroma_h_shift, chroma_v_shift, transparency;
    int32_t ac, ec, intra, context_model;
    int32_t num_h_slices, num_v_slices;
    int32_t plane_count, use32bit;
    int32_t quant_table_count;
    int32_t context_counts[8];
    int16_t quant_tables[8][5][256];
    uint8_t state_transition[256];
};

void* ffv1rt_create(const FFV1ParamsC* pc, int n_threads) {
    auto* ctx = new f2t::Codec();
    f2t::Params& p = ctx->p;
    p.version = pc->version;
    p.micro_version = pc->micro_version;
    p.width = pc->width;
    p.height = pc->height;
    p.colorspace = pc->colorspace;
    p.bits = pc->bits;
    p.chroma_planes = pc->chroma_planes;
    p.chroma_h_shift = pc->chroma_h_shift;
    p.chroma_v_shift = pc->chroma_v_shift;
    p.transparency = pc->transparency;
    p.ac = pc->ac;
    p.ec = pc->ec;
    p.intra = pc->intra;
    p.context_model = pc->context_model;
    p.num_h_slices = pc->num_h_slices;
    p.num_v_slices = pc->num_v_slices;
    p.plane_count = pc->plane_count;
    p.use32bit = pc->use32bit;
    p.quant_table_count = pc->quant_table_count;
    std::memcpy(p.context_counts, pc->context_counts,
                sizeof(p.context_counts));
    std::memcpy(p.quant_tables, pc->quant_tables, sizeof(p.quant_tables));
    std::memcpy(p.state_transition, pc->state_transition, 256);
    ctx->n_threads = n_threads > 0 ? n_threads : 1;
    ctx->init_slices();
    return ctx;
}

void ffv1rt_set_initial_states(void* h, int qt, const uint8_t* data,
                               int64_t size) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if ((int)ctx->p.initial_states.size() <= qt)
        ctx->p.initial_states.resize(qt + 1);
    ctx->p.initial_states[qt].assign(data, data + size);
}

void ffv1rt_destroy(void* h) { delete static_cast<f2t::Codec*>(h); }

int64_t ffv1rt_encode(void* h, const int32_t* const* planes, int keyframe,
                      uint8_t* out, int64_t cap) {
    return static_cast<f2t::Codec*>(h)->encode_frame(planes, keyframe, out,
                                                     cap);
}

int32_t ffv1rt_decode(void* h, const uint8_t* pkt, int64_t size,
                      int32_t* const* out_planes) {
    return static_cast<f2t::Codec*>(h)->decode_frame(pkt, size, out_planes);
}

// outs = n_frames * n_planes plane pointers (frame-major); status gets
// one entry per frame (0 clean, 1 concealed slices, -2 bad region table)
int32_t ffv1rt_decode_pipelined(void* h, const uint8_t* const* pkts,
                                const int64_t* sizes, int32_t n_frames,
                                int32_t* const* outs, int32_t n_planes,
                                int32_t* status) {
    return static_cast<f2t::Codec*>(h)->decode_frames_pipelined(
        pkts, sizes, n_frames, outs, n_planes, status);
}

int64_t ffv1rt_encode_sym(void* h, const int32_t* const* planes,
                          const int32_t* const* ctx_streams,
                          const int32_t* const* diff_streams, int n_streams,
                          int keyframe, uint8_t* out, int64_t cap) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    ctx->sym_ctx.assign(ctx_streams, ctx_streams + n_streams);
    ctx->sym_diff.assign(diff_streams, diff_streams + n_streams);
    int64_t r = ctx->encode_frame(planes, keyframe, out, cap);
    ctx->sym_ctx.clear();
    ctx->sym_diff.clear();
    return r;
}

int32_t ffv1rt_sort_stt(uint64_t* rc_stat, uint8_t* stt) {
    return f2t::twopass_sort_stt(
        reinterpret_cast<uint64_t(*)[2]>(rc_stat), stt);
}

void ffv1rt_find_best_state(const uint8_t* one_state, uint8_t* best) {
    f2t::twopass_find_best_state(
        reinterpret_cast<uint8_t(*)[256]>(best), one_state);
}

// Plan ops for one frame; returns max op count over slices, or -1.
int64_t ffv1rt_plan(void* h, const int32_t* const* planes, int keyframe) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (!ctx->plan_frame_ops(planes, keyframe, ctx->planned)) return -1;
    int64_t mx = 0;
    for (auto& o : ctx->planned) mx = std::max(mx, (int64_t)o.sv.size());
    return mx;
}

int64_t ffv1rt_get_plan_rows(void* h, int32_t si, int64_t* marks,
                             int32_t* widths, int64_t cap) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (si < 0 || si >= (int32_t)ctx->planned.size()) return -1;
    auto& o = ctx->planned[si];
    int64_t n = std::min((int64_t)o.row_marks.size(), cap);
    std::memcpy(marks, o.row_marks.data(), n * sizeof(int64_t));
    std::memcpy(widths, o.row_widths.data(), n * sizeof(int32_t));
    return (int64_t)o.row_marks.size();
}

int64_t ffv1rt_replan_pcm(void* h, int32_t si,
                          const int32_t* const* planes, int keyframe) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (si < 0 || si >= (int32_t)ctx->planned.size()) return -1;
    if (!ctx->plan_pcm_slice(si, planes, keyframe, ctx->planned)) return -1;
    return (int64_t)ctx->planned[si].sv.size();
}

int64_t ffv1rt_get_plan(void* h, int32_t si, uint8_t* sv, uint8_t* bit,
                        int64_t cap) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (si < 0 || si >= (int32_t)ctx->planned.size()) return -1;
    auto& o = ctx->planned[si];
    int64_t n = std::min((int64_t)o.sv.size(), cap);
    std::memcpy(sv, o.sv.data(), n);
    std::memcpy(bit, o.bit.data(), n);
    return (int64_t)o.sv.size();
}

// golomb-mode planning: range-coded header ops land in the regular plan
// (ffv1rt_get_plan), the Rice bitstream in (value, nbits) pairs
// (ffv1rt_get_plan_bits).  Returns max(bit ops) over slices, or -1.
int64_t ffv1rt_plan_golomb(void* h, const int32_t* const* planes,
                           int keyframe) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (!ctx->plan_frame_ops_golomb(planes, keyframe, ctx->planned,
                                    ctx->planned_bits))
        return -1;
    int64_t mx = 0;
    for (auto& b : ctx->planned_bits)
        mx = std::max(mx, (int64_t)b.nb.size());
    for (auto& o : ctx->planned)
        mx = std::max(mx, (int64_t)o.sv.size());
    return mx;
}

int64_t ffv1rt_get_plan_bits(void* h, int32_t si, uint32_t* val,
                             uint8_t* nb, int64_t cap) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (si < 0 || si >= (int32_t)ctx->planned_bits.size()) return -1;
    auto& b = ctx->planned_bits[si];
    int64_t n = std::min((int64_t)b.nb.size(), cap);
    std::memcpy(val, b.val.data(), n * sizeof(uint32_t));
    std::memcpy(nb, b.nb.data(), n);
    return (int64_t)b.nb.size();
}

void ffv1rt_set_budget_override(void* h, int64_t budget) {
    static_cast<f2t::Codec*>(h)->budget_override =
        budget > 0 ? (size_t)budget : 0;
}

void ffv1rt_set_stats_mode(void* h, int32_t enable) {
    static_cast<f2t::Codec*>(h)->stats_mode = enable != 0;
}

// Sums per-slice pass-1 tallies.  rc_stat: 256*2 u64; rc_stat2:
// nctx*32*2 u64 for the active quant table.  Returns gob count.
int32_t ffv1rt_get_stats(void* h, uint64_t* rc_stat, uint64_t* rc_stat2,
                         int64_t rc_stat2_len) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    std::memset(rc_stat, 0, 256 * 2 * sizeof(uint64_t));
    std::memset(rc_stat2, 0, rc_stat2_len * sizeof(uint64_t));
    for (auto& st : ctx->slice_stats) {
        for (size_t i = 0; i < st.stat.size(); i++) rc_stat[i] += st.stat[i];
        size_t n = std::min((size_t)rc_stat2_len, st.stat2.size());
        for (size_t i = 0; i < n; i++) rc_stat2[i] += st.stat2[i];
    }
    return ctx->gob_count;
}

int32_t ffv1rt_slice_damaged(void* h, int32_t si) {
    auto* ctx = static_cast<f2t::Codec*>(h);
    if (si < 0 || si >= (int)ctx->slices.size()) return -1;
    return ctx->slices[si].damaged ? 1 : 0;
}

}  // extern "C"
