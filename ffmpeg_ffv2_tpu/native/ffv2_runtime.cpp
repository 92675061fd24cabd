// ffv2_runtime.cpp — host-side FFV2 entropy coding and PVQ.
//
// The Daala entropy coder and the per-band PVQ quantization loops are the
// serial part of FFV2; this runtime executes them natively while the block
// transforms run batched on the device (ffv2/tpu.py).  Bit-exact with the
// Python implementation (ffv2/entropy.py, ffv2/codec.py), which is itself
// validated symbol-exact against the reference C coder.
//
// Coding layout per superblock (ffv2enc.c:encode_block_rec semantics with
// the flat-leaf RDO): split symbol (adaptive CDF), 4 tx-type bits, then per
// plane: DC exp-golomb + sign, and per frequency band: companded gain
// (integer cbrt), PVQ pulse magnitudes via the adaptive qp-ary CDF
// (reference alphabet; search capped at qp-1), sign bits.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <algorithm>

namespace f2v {

// ---------------------------------------------------------------------------
// Daala entropy coder (daala_entropy.c semantics)
// ---------------------------------------------------------------------------

static inline int log2p1(uint64_t x) {
    return x ? 64 - __builtin_clzll(x) : 0;
}
static inline uint64_t sat(uint64_t a, uint64_t b) {
    return a - std::min(a, b);
}

struct DaalaEnc {
    uint64_t low = 0;
    uint32_t range = 0x8000;
    int count = -9;
    std::vector<uint16_t> precarry;
    uint64_t end_window = 0;
    int nend_bits = 0;
    std::vector<uint8_t> rawbytes;  // reversed order

    void renorm(uint64_t l, uint32_t r) {
        int c = count;
        int d = 16 - log2p1(r);
        int s = c + d;
        if (s >= 0) {
            c += 16;
            uint64_t m = (1ull << c) - 1;
            if (s >= 8) {
                precarry.push_back((uint16_t)(l >> c));
                l &= m;
                c -= 8;
                m >>= 8;
            }
            precarry.push_back((uint16_t)(l >> c));
            s = c + d - 24;
            l &= m;
        }
        low = l << d;
        range = r << d;
        count = s;
    }

    void encode_bool(int val, uint32_t p, uint32_t p_tot) {
        uint64_t l = low;
        uint32_t r = range;
        int s = (r - p_tot) >= p_tot;
        p_tot <<= s;
        p <<= s;
        uint32_t d = r - p_tot;
        uint32_t g = sat(2ull * d, p_tot);
        uint32_t v = p + std::min(p, g) + std::min((uint32_t)(sat(p, g) >> 1), d);
        if (val) l += v;
        renorm(l, val ? r - v : v);
    }

    void encode_cdf(int sidx, const uint16_t* cdf, int nsyms, bool q15) {
        encode_cdf_acc([&](int i) { return (uint32_t)cdf[i]; }, sidx,
                       nsyms, q15);
    }

    template <class F>
    void encode_cdf_acc(F cdfat, int sidx, int nsyms, bool q15) {
        uint32_t fl = sidx > 0 ? cdfat(sidx - 1) : 0;
        uint32_t fh = cdfat(sidx);
        uint32_t ft;
        if (q15) {
            ft = 32768;
        } else {
            ft = cdfat(nsyms - 1);
            int scale = 15 - log2p1(ft - 1);
            fl <<= scale;
            fh <<= scale;
            ft <<= scale;
        }
        uint64_t l = low;
        uint32_t r = range;
        int scale2 = (r - ft) >= ft;
        ft <<= scale2;
        uint32_t d = r - ft;
        uint32_t g = sat(2ull * d, ft);
        fh <<= scale2;
        uint32_t v = fh + std::min(fh, g) + std::min((uint32_t)(sat(fh, g) >> 1), d);
        if (sidx == 0) {           // fl = 0 -> u = 0 (dominant symbol)
            renorm(l, v);
            return;
        }
        fl <<= scale2;
        uint32_t u = fl + std::min(fl, g) + std::min((uint32_t)(sat(fl, g) >> 1), d);
        renorm(l + u, v - u);
    }

    void encode_bits(uint32_t val, int n) {
        if (nend_bits + n > 64) {
            while (nend_bits >= 8) {
                rawbytes.push_back((uint8_t)end_window);
                end_window >>= 8;
                nend_bits -= 8;
            }
        }
        end_window |= (uint64_t)val << nend_bits;
        nend_bits += n;
    }

    void encode_golomb(uint32_t val) {
        val += 1;
        if (val != 1) {
            uint32_t topbit = 1, maxval = 1;
            while (val > maxval) {
                topbit <<= 1;
                maxval = (maxval << 1) | 1;
            }
            for (int i = log2p1(topbit) - 2; i >= 0; i--)
                encode_bits(((val >> i) & 1) << 1, 2);
        }
        encode_bits(1, 1);
    }

    std::vector<uint8_t> done() {
        uint64_t l = low;
        uint32_t r = range;
        int c = count;
        int s = 9;
        uint64_t m = 0x7FFF;
        uint64_t e = (l + m) & ~m;
        while ((e | m) >= l + r) {
            s++;
            m >>= 1;
            e = (l + m) & ~m;
        }
        s += c;
        std::vector<uint16_t> pc = precarry;
        if (s > 0) {
            uint64_t n = (1ull << (c + 16)) - 1;
            do {
                pc.push_back((uint16_t)(e >> (c + 16)));
                e &= n;
                s -= 8;
                c -= 8;
                n >>= 8;
            } while (s > 0);
        }
        std::vector<uint8_t> raw = rawbytes;
        uint64_t ew = end_window;
        int nend = nend_bits;
        int sneg = -s;
        while (nend > sneg) {
            raw.push_back((uint8_t)ew);
            ew >>= 8;
            nend -= 8;
        }
        std::vector<uint8_t> out(pc.size());
        uint32_t carry = 0;
        for (int i = (int)pc.size() - 1; i >= 0; i--) {
            uint32_t v = pc[i] + carry;
            out[i] = (uint8_t)v;
            carry = v >> 8;
        }
        size_t front = out.size();
        out.insert(out.end(), raw.rbegin(), raw.rend());
        if (nend > 0 && front > 0)
            out[front - 1] |= (uint8_t)ew;
        return out;
    }
};

struct DaalaDec {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    size_t rpos;
    uint64_t diff = 0;
    uint32_t range = 0x8000;
    int count = -15;
    uint64_t end_window = 0;
    int end_window_size = 0;

    void init(const uint8_t* d, size_t n) {
        data = d;
        size = n;
        rpos = n;
        fillup();
    }

    void fillup() {
        int i = 64 - 9 - (count + 15);
        while (i >= 0 && pos < size) {
            diff |= (uint64_t)data[pos++] << i;
            count += 8;
            i -= 8;
        }
        if (pos >= size) count = 16384;
    }

    void renorm(uint64_t d, uint32_t r) {
        int i = 16 - log2p1(r);
        diff = d << i;
        range = r << i;
        if ((count -= i) < 0) fillup();
    }

    int decode_bool(uint32_t p, uint32_t p_tot) {
        uint32_t dr = range - p_tot;
        int t = dr >= p_tot;
        p <<= t;
        p_tot <<= t;
        uint32_t g = sat(2ull * dr, p_tot);
        uint32_t v = p + std::min(p, g) + std::min((uint32_t)(sat(p, g) >> 1), dr);
        uint64_t split = (uint64_t)v << (64 - 16);
        int rval = diff >= split;
        renorm(diff - (rval ? split : 0), rval ? range - v : v);
        return rval;
    }

    int decode_cdf(const uint16_t* cdf, int cdf_size, bool q15) {
        return decode_cdf_acc([&](int i) { return (uint32_t)cdf[i]; },
                              cdf_size, q15);
    }

    template <class F>
    int decode_cdf_acc(F cdfat, int cdf_size, bool q15) {
        uint32_t rng = range;
        uint64_t d64 = diff;
        const uint64_t cval = d64 >> (64 - 16);
        uint32_t p_tot, d;
        int scale;
        if (q15) {
            d = rng - 32768;
            p_tot = 32768;
            scale = 0;
        } else {
            p_tot = cdfat(cdf_size - 1);
            scale = 15 - log2p1(p_tot - 1);
            p_tot <<= scale;
            if (rng - p_tot >= p_tot) {
                p_tot <<= 1;
                scale++;
            }
            d = rng - p_tot;
        }
        uint32_t g = sat(2ull * d, p_tot);
        // third bound computed SIGNED: when g > 2*cval+1 it goes negative
        // and must lose the max() to cval>>1 (>= 0), not wrap to huge
        int64_t t3 = 2 * (int64_t)cval + 1 - (int64_t)g;
        int64_t lim = std::max(std::max((int64_t)(cval >> 1),
                                        (int64_t)cval - (int64_t)d),
                               t3 >= 0 ? t3 / 3 : int64_t(-1)) >> scale;
        int ret = 0;
        uint64_t u = 0, v = cdfat(0);
        while (ret < cdf_size - 1 && (int64_t)v <= lim) {
            u = v;
            v = cdfat(++ret);
        }
        u <<= scale;
        v <<= scale;
        u = u + std::min(u, (uint64_t)g) + std::min(sat(u, g) >> 1, (uint64_t)d);
        v = v + std::min(v, (uint64_t)g) + std::min(sat(v, g) >> 1, (uint64_t)d);
        renorm(d64 - (u << (64 - 16)), (uint32_t)(v - u));
        return ret;
    }

    uint32_t decode_bits(int num) {
        int avail = end_window_size;
        uint64_t win = end_window;
        if (avail < num) {
            while (avail <= 64 - 8) {
                if (rpos <= 0) {
                    avail = 16384;
                    break;
                }
                win |= (uint64_t)data[--rpos] << avail;
                avail += 8;
            }
        }
        uint32_t ret = win & ((1u << num) - 1);
        end_window = win >> num;
        end_window_size = avail - num;
        return ret;
    }

    uint32_t decode_golomb() {
        uint32_t coeff = 1;
        while (!decode_bits(1))
            coeff = (coeff << 1) | decode_bits(1);
        return coeff - 1;
    }
};

// adaptive CDF bank — offset representation.
//
// The reference adapt (daala_entropy.c:413-425) adds `inc` to every
// entry >= the coded symbol, O(nsyms) per symbol; for the pulse CDFs
// the dominant symbol is 0 (every entry bumps).  Keeping a per-row
// additive `base` makes that common case O(1): logical[j] = v[j] +
// base, adapt(0) is just base += inc, adapt(val>0) also subtracts inc
// from the `val` skipped entries.  Pure representation change — the
// logical CDF values (and therefore the bitstream) are identical.
struct CDF {
    std::vector<int32_t> v;
    std::vector<uint32_t> base;
    int x, y, inc;

    void init(int x_, int y_, int inc_, int inc_shift) {
        x = x_;
        y = y_;
        inc = inc_;
        int inc_g = inc >> inc_shift;
        v.assign((size_t)x * y, 0);
        base.assign((size_t)x, 0);
        for (int i = 0; i < x; i++)
            for (int j = 0; j < y; j++)
                v[(size_t)i * y + j] = inc_g * j + inc_g;
    }

    inline uint32_t at(int off, int j) const {
        return (uint32_t)(v[(size_t)off * y + j] + (int32_t)base[off]);
    }

    void adapt(int off, int val, int n) {
        int32_t* r = v.data() + (size_t)off * y;
        uint32_t b = base[off];
        if ((uint32_t)(r[n - 1] + (int32_t)b) + inc > 32767) {
            for (int i = 0; i < n; i++)
                r[i] = (int32_t)(((uint32_t)(r[i] + (int32_t)b)) >> 1)
                       + i + 1;
            b = 0;
        }
        b += inc;
        for (int i = 0; i < val; i++) r[i] -= inc;
        base[off] = b;
    }
};

// ---------------------------------------------------------------------------
// PVQ + integer gain math (ffv2/pvq.py semantics)
// ---------------------------------------------------------------------------

static int64_t isqrt64(uint64_t v) {
    if (!v) return 0;
    uint64_t r = (uint64_t)std::sqrt((double)v);
    while (r * r > v) r--;
    while ((r + 1) * (r + 1) <= v) r++;
    return (int64_t)r;
}

static int64_t icbrt64(uint64_t v) {
    if (!v) return 0;
    uint64_t r = (uint64_t)std::llround(std::cbrt((double)v));
    while (r * r * r > v) r--;
    while ((r + 1) * (r + 1) * (r + 1) <= v) r++;
    return (int64_t)r;
}

// greedy pulse search; float64 scores with first-max argmax, matching the
// numpy implementation exactly.  max_abs caps each |y_i| (the wire's
// qp-ary pulse alphabet cannot represent |pulse| == qp).
// exact 32-bit scoring (ffv2/pvq.py pvq_search): magnitudes prescale
// to <= 8 bits, score a/b compares as (a/b, (a%b)*b_other) — identical
// selections in numpy, here, and the int32-only device path
static void pvq_search(const int64_t* x, int n, int k, int max_abs,
                       int64_t* y) {
    std::vector<int32_t> ax(n);
    int64_t mx = 0;
    for (int i = 0; i < n; i++) {
        int64_t a = std::llabs(x[i]);
        mx = std::max(mx, a);
        y[i] = 0;
    }
    if (k <= 0 || !mx) return;
    int shift = 0;
    while ((mx >> shift) > 255) shift++;
    for (int i = 0; i < n; i++)
        ax[i] = (int32_t)(std::llabs(x[i]) >> shift);
    int32_t xy = 0, yy = 0;
    for (int p = 0; p < k; p++) {
        int best = -1;
        int32_t bq = -1, br = 0, bb = 1;
        for (int i = 0; i < n; i++) {
            if (y[i] >= max_abs) continue;
            int32_t a = (xy + ax[i]) * (xy + ax[i]);
            int32_t b = yy + 2 * (int32_t)y[i] + 1;
            int32_t q = a / b, r = a - q * b;
            if (q > bq || (q == bq && r * bb > br * b)) {
                bq = q; br = r; bb = b; best = i;
            }
        }
        if (best < 0) break;   // every position at the cap
        y[best] += 1;
        xy += ax[best];
        yy += 2 * (int32_t)y[best] - 1;
    }
    for (int i = 0; i < n; i++)
        if (x[i] < 0) y[i] = -y[i];
}

static void band_reconstruct(const int64_t* pulses, int n, int64_t cg,
                             int64_t* out) {
    int64_t cnt = 0;
    for (int i = 0; i < n; i++) cnt += pulses[i] * pulses[i];
    if (!cnt || !cg) {
        std::memset(out, 0, n * sizeof(int64_t));
        return;
    }
    uint64_t c3 = (uint64_t)cg * cg * cg;
    for (int i = 0; i < n; i++) {
        uint64_t num = (uint64_t)(pulses[i] * pulses[i]) * c3 / (uint64_t)cnt;
        int64_t mag = isqrt64(num);
        out[i] = pulses[i] < 0 ? -mag : mag;
    }
}

// ---------------------------------------------------------------------------
// Frame-level coding sessions
// ---------------------------------------------------------------------------

static inline int size_idx(int n) {  // 4..64 -> 0..4
    int i = 0;
    while ((4 << i) < n) i++;
    return i;
}

struct Ffv2Enc {
    DaalaEnc ent;
    CDF subdiv;
    CDF pulse;
    int qp = 0;
    std::vector<int> bands_by_size[5];   // per block size 4..64

    void init(int qp_, const int32_t* bands, int n_bands) {
        qp = qp_;
        subdiv.init(1, 4, 128, 2);
        pulse.init(13, qp, 64, 6);   // reference qp-ary alphabet
        bands_by_size[4].assign(bands, bands + n_bands);
    }

    void set_bands(int n, const int32_t* bands, int n_bands) {
        bands_by_size[size_idx(n)].assign(bands, bands + n_bands);
    }

    // EC for pre-quantized data (device PVQ path): dc, per-band cg,
    // per-AC-position pulses (incl. the phantom tail position)
    void quant_block_q(int64_t dc, const int32_t* cg, const int8_t* pulses,
                       int n) {
        const std::vector<int>& band_starts = bands_by_size[size_idx(n)];
        ent.encode_golomb((uint32_t)std::llabs(dc));
        if (dc) ent.encode_bits(dc < 0, 1);
        for (size_t bi = 0; bi + 1 < band_starts.size(); bi++) {
            int lo = band_starts[bi], hi = band_starts[bi + 1];
            ent.encode_golomb((uint32_t)cg[bi]);
            int pcnt = 0;
            for (int j = lo; j < hi; j++) {
                if (pcnt >= qp) break;
                int av = pulses[j] < 0 ? -pulses[j] : pulses[j];
                ent.encode_cdf_acc([&](int i) { return pulse.at(bi % 13, i); },
                                   av, qp, false);
                pulse.adapt(bi % 13, av, qp);
                if (av) ent.encode_bits(pulses[j] < 0, 1);
                pcnt += av;
            }
        }
    }

    void quant_block(const int64_t* stream, int n) {
        const std::vector<int>& band_starts = bands_by_size[size_idx(n)];
        int64_t dc = stream[0];
        ent.encode_golomb((uint32_t)std::llabs(dc));
        if (dc) ent.encode_bits(dc < 0, 1);
        const int64_t* ac = stream + 1;
        const int n_ac = n * n - 1;
        std::vector<int64_t> pulses(4200);
        std::vector<int64_t> band(4200);
        for (size_t bi = 0; bi + 1 < band_starts.size(); bi++) {
            int lo = band_starts[bi], hi = band_starts[bi + 1];
            int len = hi - lo;
            // last band has one phantom position past the real
            // coefficients (ffv2_num_bands off-by-one); treat as 0
            for (int j = 0; j < len; j++)
                band[j] = (lo + j < n_ac) ? ac[lo + j] : 0;
            uint64_t igain = 0;
            for (int j = 0; j < len; j++)
                igain += (uint64_t)(band[j] * band[j]);
            int64_t cg = icbrt64(igain);
            ent.encode_golomb((uint32_t)cg);
            pvq_search(band.data(), len, qp, qp - 1, pulses.data());
            int pcnt = 0;
            for (int j = 0; j < len; j++) {
                if (pcnt >= qp) break;
                int av = (int)std::llabs(pulses[j]);
                ent.encode_cdf_acc([&](int i) { return pulse.at(bi % 13, i); },
                                   av, qp, false);
                pulse.adapt(bi % 13, av, qp);
                if (av) ent.encode_bits(pulses[j] < 0, 1);
                pcnt += av;
            }
        }
    }
};

struct Ffv2Dec {
    DaalaDec ent;
    CDF subdiv;
    CDF pulse;
    int qp = 0;
    std::vector<int> bands_by_size[5];
};

}  // namespace f2v

extern "C" {

void* ffv2rt_enc_create(int qp, const int32_t* band_starts, int n_bands) {
    auto* e = new f2v::Ffv2Enc();
    e->init(qp, band_starts, n_bands);
    return e;
}

void ffv2rt_enc_destroy(void* h) { delete static_cast<f2v::Ffv2Enc*>(h); }

void ffv2rt_enc_uint(void* h, uint32_t val, uint32_t num_unused) {
    // frame header uints are coded by the Python layer via triangle CDFs;
    // this entry remains for the golomb values
    (void)h; (void)val; (void)num_unused;
}

void ffv2rt_enc_golomb(void* h, uint32_t val) {
    static_cast<f2v::Ffv2Enc*>(h)->ent.encode_golomb(val);
}

void ffv2rt_enc_bits(void* h, uint32_t val, int n) {
    static_cast<f2v::Ffv2Enc*>(h)->ent.encode_bits(val, n);
}

void ffv2rt_enc_cdf_q15(void* h, int s, const uint16_t* cdf, int nsyms) {
    static_cast<f2v::Ffv2Enc*>(h)->ent.encode_cdf(s, cdf, nsyms, true);
}

// split-tree symbol (adaptive CDF): 0=END 1=XY 2=Y 3=X
void ffv2rt_enc_split(void* h, int split) {
    auto* e = static_cast<f2v::Ffv2Enc*>(h);
    e->ent.encode_cdf_acc([&](int i) { return e->subdiv.at(0, i); },
                          split, 4, false);
    e->subdiv.adapt(0, split, 4);
}

// one leaf block (no split symbol): tx bits + per-plane streams
void ffv2rt_enc_leaf(void* h, const int64_t* streams, int n_planes, int n,
                     int tx_type) {
    auto* e = static_cast<f2v::Ffv2Enc*>(h);
    e->ent.encode_bits(tx_type, 4);
    for (int p = 0; p < n_planes; p++)
        e->quant_block(streams + (size_t)p * n * n, n);
}

// code one superblock: split END + tx bits + per-plane quantized streams
void ffv2rt_enc_sb(void* h, const int64_t* streams, int n_planes, int n,
                   int tx_type) {
    ffv2rt_enc_split(h, 0);
    ffv2rt_enc_leaf(h, streams, n_planes, n, tx_type);
}

// pre-quantized frame (device PVQ): dc [n_sb*n_planes], cg
// [n_sb*n_planes][n_bands], pulses [n_sb*n_planes][ac_len]
void ffv2rt_enc_frame_q(void* h, const int64_t* dc, const int32_t* cg,
                        const int8_t* pulses, int64_t ac_len,
                        int64_t n_bands, int n_sb, int n_planes, int n,
                        int tx_type) {
    auto* e = static_cast<f2v::Ffv2Enc*>(h);
    for (int sb = 0; sb < n_sb; sb++) {
        ffv2rt_enc_split(h, 0);
        e->ent.encode_bits(tx_type, 4);
        for (int p = 0; p < n_planes; p++) {
            size_t k = (size_t)sb * n_planes + p;
            e->quant_block_q(dc[k], cg + k * n_bands, pulses + k * ac_len,
                             n);
        }
    }
}

// code all superblocks of a frame in one call (streams row-major per SB,
// planes innermost: [sb*n_planes + p][n*n])
void ffv2rt_enc_frame(void* h, const int64_t* streams, int n_sb,
                      int n_planes, int n, int tx_type) {
    for (int sb = 0; sb < n_sb; sb++)
        ffv2rt_enc_sb(h, streams + (size_t)sb * n_planes * n * n,
                      n_planes, n, tx_type);
}

int64_t ffv2rt_enc_done(void* h, uint8_t* out, int64_t cap) {
    auto* e = static_cast<f2v::Ffv2Enc*>(h);
    auto bytes = e->ent.done();
    if ((int64_t)bytes.size() > cap) return -1;
    std::memcpy(out, bytes.data(), bytes.size());
    return (int64_t)bytes.size();
}

void* ffv2rt_dec_create(const uint8_t* data, int64_t size) {
    auto* d = new f2v::Ffv2Dec();
    d->ent.init(data, (size_t)size);
    d->subdiv.init(1, 4, 128, 2);
    return d;
}

void ffv2rt_dec_destroy(void* h) { delete static_cast<f2v::Ffv2Dec*>(h); }

void ffv2rt_dec_set_qp(void* h, int qp, const int32_t* band_starts,
                       int n_bands) {
    auto* d = static_cast<f2v::Ffv2Dec*>(h);
    d->qp = qp;
    d->pulse.init(13, qp, 64, 6);
    d->bands_by_size[4].assign(band_starts, band_starts + n_bands);
}

void ffv2rt_enc_set_bands(void* h, int n, const int32_t* bands,
                          int n_bands) {
    static_cast<f2v::Ffv2Enc*>(h)->set_bands(n, bands, n_bands);
}

void ffv2rt_dec_set_bands(void* h, int n, const int32_t* bands,
                          int n_bands) {
    auto* d = static_cast<f2v::Ffv2Dec*>(h);
    d->bands_by_size[f2v::size_idx(n)].assign(bands, bands + n_bands);
}

uint32_t ffv2rt_dec_golomb(void* h) {
    return static_cast<f2v::Ffv2Dec*>(h)->ent.decode_golomb();
}

uint32_t ffv2rt_dec_bits(void* h, int n) {
    return static_cast<f2v::Ffv2Dec*>(h)->ent.decode_bits(n);
}

int ffv2rt_dec_cdf_q15(void* h, const uint16_t* cdf, int nsyms) {
    return static_cast<f2v::Ffv2Dec*>(h)->ent.decode_cdf(cdf, nsyms, true);
}

// decode one superblock into quantized streams; returns tx_type or -1
int ffv2rt_dec_split(void* h) {
    auto* d = static_cast<f2v::Ffv2Dec*>(h);
    int split = d->ent.decode_cdf_acc(
        [&](int i) { return d->subdiv.at(0, i); }, 4, false);
    d->subdiv.adapt(0, split, 4);
    return split;
}

// one leaf block (no split symbol); returns tx_type
int ffv2rt_dec_leaf(void* h, int64_t* streams, int n_planes, int n) {
    auto* d = static_cast<f2v::Ffv2Dec*>(h);
    int tx_type = d->ent.decode_bits(4);
    std::vector<int64_t> pulses(4096);
    for (int p = 0; p < n_planes; p++) {
        int64_t* stream = streams + (size_t)p * n * n;
        std::memset(stream, 0, (size_t)n * n * sizeof(int64_t));
        int64_t dc = d->ent.decode_golomb();
        if (dc && d->ent.decode_bits(1)) dc = -dc;
        stream[0] = dc;
        const int n_ac = n * n - 1;
        const std::vector<int>& band_starts =
            d->bands_by_size[f2v::size_idx(n)];
        std::vector<int64_t> recon(4200);
        for (size_t bi = 0; bi + 1 < band_starts.size(); bi++) {
            int lo = band_starts[bi], hi = band_starts[bi + 1];
            int len = hi - lo;
            int64_t cg = d->ent.decode_golomb();
            std::fill(pulses.begin(), pulses.begin() + len, 0);
            int pcnt = 0;
            for (int j = 0; j < len; j++) {
                if (pcnt >= d->qp) break;
                int v = d->ent.decode_cdf_acc(
                    [&](int i) { return d->pulse.at(bi % 13, i); },
                    d->qp, false);
                d->pulse.adapt(bi % 13, v, d->qp);
                int64_t sv = v;
                if (v && d->ent.decode_bits(1)) sv = -sv;
                pulses[j] = sv;
                pcnt += v;
            }
            // phantom tail position (beyond n*n-1 real ACs) is parsed
            // above but its reconstruction is dropped
            f2v::band_reconstruct(pulses.data(), len, cg, recon.data());
            for (int j = 0; j < len && lo + j < n_ac; j++)
                stream[1 + lo + j] = recon[j];
        }
    }
    return tx_type;
}

// decode one superblock; returns tx_type or -1 on a split (use
// ffv2rt_dec_split/ffv2rt_dec_leaf for tree-aware decoding)
int ffv2rt_dec_sb(void* h, int64_t* streams, int n_planes, int n) {
    if (ffv2rt_dec_split(h) != 0) return -1;
    return ffv2rt_dec_leaf(h, streams, n_planes, n);
}

// decode all superblocks; returns 0 or -1 if any SB uses split blocks
int ffv2rt_dec_frame(void* h, int64_t* streams, int n_sb, int n_planes,
                     int n) {
    for (int sb = 0; sb < n_sb; sb++) {
        int t = ffv2rt_dec_sb(h, streams + (size_t)sb * n_planes * n * n,
                              n_planes, n);
        if (t < 0) return -1;
    }
    return 0;
}

}  // extern "C"
