"""Daala entropy coder — multisymbol adaptive arithmetic coding.

Bit-exact implementation of the Daala/Opus-lineage range coder used by FFV2
(reference: libavcodec/daala_entropy.{c,h}): 15-bit probabilities with a
16-bit range, 64-bit shift window, carry-free encoding via a pre-carry
buffer, and raw bits packed *backwards* from the end of the packet.  The
final packet is [entropy-coded bytes ...][... raw bits, last byte first].

This scalar Python version is the oracle; the batched/device variants check
against it.
"""

from __future__ import annotations

import numpy as np

from .tables import DAALA_CDF_TAB, DAALA_CDF_EXP_TAB, DAALA_LAPLACE_OFFSET

WSIZE = 64              # window bits (ent_win is uint64)
UINT_BITS = 4
BIT_ABUNDANCE = 16384

CDF_NORM = 0
CDF_Q15 = 1
CDF_UNSCALED = 2
CDF_DYADIC = 3


def _log2p1(x: int) -> int:
    """daalaent_log2: 1 + floor(log2(x)); 0 for x=0."""
    return x.bit_length()


def _sat(a: int, b: int) -> int:
    return a - min(a, b)


def cdf_triangle(n: int) -> np.ndarray:
    """Q15 CDF slice for uniform uints (ff_daalaent_cdf_tab access)."""
    base = ((n * (n - 1)) >> 1) - 1
    return DAALA_CDF_TAB[base:base + n]


class DaalaCDF:
    """Adaptive CDF bank: x rows of y entries (daala_entropy.h:140-161)."""

    def __init__(self, x: int, y: int, inc: int, fir: int, inc_shift: int,
                 gen_mod: int):
        self.x = x
        self.y = y
        self.inc = inc
        self.gen_mod = gen_mod
        self.inc_g = inc >> inc_shift
        self.fir = fir if (fir or gen_mod) else self.inc_g
        self.cdf = np.zeros((x, y), dtype=np.int64)
        self.reset()

    def reset(self):
        j = np.arange(self.y)
        self.cdf[:] = self.inc_g * (j + self.gen_mod) + self.fir


class DaalaEncoder:
    def __init__(self):
        self.low = 0
        self.range = 0x8000
        self.count = -9
        self.precarry: list[int] = []      # uint16 entries
        self.end_window = 0
        self.nend_bits = 0
        self.rawbytes = bytearray()        # raw-bit bytes, reversed order

    # --- core renormalization (daalaent_enc_renormalize) ---

    def _renorm(self, low: int, rng: int):
        c = self.count
        d = 16 - _log2p1(rng)
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & ((1 << 64) - 1)
        self.range = rng << d
        self.count = s

    # --- symbols ---

    def encode_bool(self, val: int, p: int, p_tot: int):
        l = self.low
        r = self.range
        s = 1 if (r - p_tot) >= p_tot else 0
        p_tot <<= s
        p <<= s
        d = r - p_tot
        g = _sat(2 * d, p_tot)
        v = p + min(p, g) + min(_sat(p, g) >> 1, d)
        if val:
            l += v
        r = r - v if val else v
        self._renorm(l, r)

    def encode_cdf(self, s: int, cdf, nsyms: int, ctype: int):
        cdf = np.asarray(cdf)
        if ctype == CDF_UNSCALED:
            fl = int(cdf[s - 1]) if s > 0 else 0
            fh = int(cdf[s])
            ft = int(cdf[nsyms - 1])
            scale = 15 - _log2p1(ft - 1)
            fl <<= scale
            fh <<= scale
            ft <<= scale
        elif ctype == CDF_Q15:
            fl = int(cdf[s - 1]) if s > 0 else 0
            fh = int(cdf[s])
            ft = 32768
        else:
            raise ValueError("unsupported cdf type on encode")
        l = self.low
        r = self.range
        scale = 1 if (r - ft) >= ft else 0
        ft <<= scale
        fl <<= scale
        fh <<= scale
        d = r - ft
        g = _sat(2 * d, ft)
        u = fl + min(fl, g) + min(_sat(fl, g) >> 1, d)
        v = fh + min(fh, g) + min(_sat(fh, g) >> 1, d)
        self._renorm(l + u, v - u)

    def encode_bits(self, val: int, n: int):
        """Raw bits; packed into the tail of the packet."""
        assert n <= 25 and 0 <= val < (1 << n)
        if self.nend_bits + n > WSIZE:
            while self.nend_bits >= 8:
                self.rawbytes.append(self.end_window & 0xFF)
                self.end_window >>= 8
                self.nend_bits -= 8
        self.end_window |= val << self.nend_bits
        self.nend_bits += n

    def encode_uint(self, val: int, num: int):
        if num > (1 << UINT_BITS):
            bit = _log2p1(num - 1) - UINT_BITS
            num -= 1
            adr = (num >> bit) + 1
            self.encode_cdf(val >> bit, cdf_triangle(adr), adr, CDF_Q15)
            self.encode_bits(val & ((1 << bit) - 1), bit)
        else:
            self.encode_cdf(val, cdf_triangle(num), num, CDF_Q15)

    def encode_cdf_adapt(self, c: DaalaCDF, val: int, off: int, n: int):
        cdf = c.cdf[off]
        self.encode_cdf(val, cdf, n, CDF_UNSCALED)
        if cdf[n - 1] + c.inc > 32767:
            cdf[:n] = (cdf[:n] >> 1) + np.arange(1, n + 1)
        cdf[val:n] += c.inc

    def encode_laplace(self, x: int, decay: int, maxv: int):
        shift = 0
        if maxv == 0:
            return
        while ((maxv >> shift) >= 15 or maxv == -1) and decay > 235:
            decay = (decay * decay + 128) >> 8
            shift += 1
        decay = max(2, min(decay, 254))
        xs = x >> shift
        ms = maxv >> shift
        cdf = DAALA_CDF_EXP_TAB[(decay + 1) >> 1]
        while True:
            ctype = CDF_UNSCALED if (0 < ms < 15) else CDF_Q15
            ex = ms + 1 if (0 < ms < 15) else 16
            sym = min(xs, 15)
            self.encode_cdf(sym, cdf, ex, ctype)
            xs -= 15
            ms -= 15
            if not (sym >= 15 and ms != 0):
                break
        if shift:
            self.encode_bits(x & ((1 << shift) - 1), shift)

    def encode_golomb(self, val: int):
        """FFV2's exp-golomb over raw bit pairs (ffv2enc.c:encode_golomb)."""
        val += 1
        if val != 1:
            topbit = maxval = 1
            while val > maxval:
                topbit <<= 1
                maxval = (maxval << 1) | 1
            for i in range(topbit.bit_length() - 2, -1, -1):
                self.encode_bits((1 if val & (1 << i) else 0) << 1, 2)
        self.encode_bits(1, 1)

    # --- finalize (ff_daalaent_encode_done) ---

    def done(self) -> bytes:
        l = self.low
        r = self.range
        c = self.count
        s = 9
        m = 0x7FFF
        e = (l + m) & ~m
        while (e | m) >= l + r:
            s += 1
            m >>= 1
            e = (l + m) & ~m
        s += c
        precarry = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                precarry.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break

        # flush remaining raw-bit window bytes
        rawbytes = bytearray(self.rawbytes)
        ew = self.end_window
        nend = self.nend_bits
        sneg = -s
        while nend > sneg:
            rawbytes.append(ew & 0xFF)
            ew >>= 8
            nend -= 8

        # carry propagation over the precarry buffer (front part)
        front = bytearray(len(precarry))
        carry = 0
        for i in range(len(precarry) - 1, -1, -1):
            v = precarry[i] + carry
            front[i] = v & 0xFF
            carry = v >> 8

        out = bytearray(front)
        out.extend(reversed(rawbytes))
        # leftover raw bits merge into the last byte
        if nend > 0:
            out[len(front) - 1] |= ew & 0xFF
        return bytes(out)


class DaalaDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                 # front read position
        self.rpos = len(data)        # raw bits read backwards from the end
        self.diff = 0
        self.range = 0x8000
        self.count = -15
        self.eos_offset = 10 - (WSIZE - 8)
        self.end_window = 0
        self.end_window_size = 0
        self.err = 0
        self._fillup()

    def _fillup(self):
        i = WSIZE - 9 - (self.count + 15)
        while i >= 0 and self.pos < len(self.data):
            self.diff |= self.data[self.pos] << i
            self.pos += 1
            self.count += 8
            i -= 8
        if self.pos >= len(self.data):
            self.eos_offset += BIT_ABUNDANCE - self.count
            self.count = BIT_ABUNDANCE

    def _renorm(self, diff: int, rng: int):
        i = 16 - _log2p1(rng)
        self.diff = (diff << i) & ((1 << 64) - 1)
        self.range = rng << i
        self.count -= i
        if self.count < 0:
            self._fillup()

    def decode_bool(self, p: int, p_tot: int) -> int:
        diff_r = self.range - p_tot
        tmp = 1 if diff_r >= p_tot else 0
        p <<= tmp
        p_tot <<= tmp
        g = _sat(2 * diff_r, p_tot)
        v = p + min(p, g) + min(_sat(p, g) >> 1, diff_r)
        split = v << (WSIZE - 16)
        rval = 1 if self.diff >= split else 0
        diff = self.diff - (split if rval else 0)
        rng = (self.range - v) if rval else v
        self._renorm(diff, rng)
        return rval

    def decode_cdf(self, cdf, cdf_size: int, p_tot: int, ctype: int) -> int:
        cdf = np.asarray(cdf)
        rng = self.range
        diff = self.diff
        cshift = WSIZE - 16
        cval = diff >> cshift
        if ctype == CDF_UNSCALED:
            p_tot = int(cdf[cdf_size - 1])
            scale = 15 - _log2p1(p_tot - 1)
            p_tot <<= scale
            if rng - p_tot >= p_tot:
                p_tot <<= 1
                scale += 1
            d = rng - p_tot
        elif ctype == CDF_Q15:
            d = rng - 32768
            p_tot = 32768
            scale = 0
        elif ctype == CDF_DYADIC:
            scale = 15 - p_tot
            d = rng - 32768
            p_tot = 32768
        else:
            p_tot = int(cdf[cdf_size - 1])
            scale = 1 if rng - p_tot >= p_tot else 0
            p_tot <<= scale
            d = rng - p_tot
        g = _sat(2 * d, p_tot)
        lim = max(cval >> 1, cval - d, (2 * cval + 1 - g) // 3) >> scale
        ret = 0
        u = 0
        v = int(cdf[0])
        while v <= lim:
            u = v
            ret += 1
            v = int(cdf[ret])
        u <<= scale
        v <<= scale
        u = u + min(u, g) + min(_sat(u, g) >> 1, d)
        v = v + min(v, g) + min(_sat(v, g) >> 1, d)
        self._renorm(diff - (u << cshift), v - u)
        return ret

    def decode_bits(self, num: int) -> int:
        avail = self.end_window_size
        win = self.end_window
        if avail < num:
            while avail <= WSIZE - 8:
                if self.rpos <= self.pos_limit():
                    self.eos_offset += BIT_ABUNDANCE - avail
                    avail = BIT_ABUNDANCE
                    break
                self.rpos -= 1
                win |= self.data[self.rpos] << avail
                avail += 8
        ret = win & ((1 << num) - 1)
        self.end_window = win >> num
        self.end_window_size = avail - num
        return ret

    def pos_limit(self) -> int:
        # raw buffer start (reference keeps rbuf == buf start)
        return 0

    def decode_uint(self, num: int) -> int:
        if num > (1 << UINT_BITS):
            num -= 1
            bit = _log2p1(num) - UINT_BITS
            adr = (num >> bit) + 1
            t = self.decode_cdf(cdf_triangle(adr), adr, 0, CDF_Q15)
            t = (t << bit) | self.decode_bits(bit)
            if t <= num:
                return t
            self.err = 1
            return num
        return self.decode_cdf(cdf_triangle(num), num, 0, CDF_Q15)

    def decode_cdf_adapt(self, c: DaalaCDF, off: int, n: int) -> int:
        cdf = c.cdf[off]
        rval = self.decode_cdf(cdf, n, 0, CDF_UNSCALED)
        if cdf[n - 1] + c.inc > 32767:
            cdf[:n] = (cdf[:n] >> 1) + np.arange(1, n + 1)
        cdf[rval:n] += c.inc
        return rval

    def decode_laplace(self, decay: int, maxv: int) -> int:
        if maxv == 0:
            return 0
        shift = 0
        while ((maxv >> shift) >= 15 or maxv == -1) and decay > 235:
            decay = (decay * decay + 128) >> 8
            shift += 1
        max_shift = maxv >> shift
        decay = max(2, min(decay, 254))
        cdf = DAALA_CDF_EXP_TAB[(decay + 1) >> 1]
        p_shift = 0
        while True:
            bound = 0 < max_shift < 15
            size = max_shift + 1 if bound else 16
            ctype = CDF_UNSCALED if bound else CDF_Q15
            sym = self.decode_cdf(cdf, size, 0, ctype)
            p_shift += sym
            max_shift -= 15
            if not (sym >= 15 and max_shift):
                break
        pos = (p_shift << shift) + self.decode_bits(shift) if shift else p_shift
        if maxv != -1 and pos > maxv:
            pos = maxv
            self.err = 1
        return pos

    def decode_golomb(self) -> int:
        coeff = 1
        while not self.decode_bits(1):
            coeff = (coeff << 1) | self.decode_bits(1)
        return coeff - 1
