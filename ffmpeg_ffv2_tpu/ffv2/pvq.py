"""Pyramid vector quantization for FFV2 bands.

The shape search replaces the reference's AVX assembly
(libavcodec/x86/celt_pvq_search.asm, the encoder's only asm dependency,
ffv2enc.c:171) with an exact integer greedy search: place K pulses one at a
time at the position maximizing corr^2/energy, compared with exact int64
cross-multiplication — deterministic on every backend and vectorizable.

Gain coding uses integer companding: the reference computes
pow(gain, 1/1.5)=gain^(2/3) in floats (ffv2enc.c:gain_compand) and
pow(cg, 1.5) with a float 1/sqrt(cnt) renormalization on decode
(ffv2dec.c:gain_expand/dequant_block) — libm-dependent and not
reproducible across platforms.  We rationalize both sides to exact integer
roots (SURVEY.md section 7 step 7):
    encode:  cg    = floor(cbrt(sum x^2))              # == gain^(2/3)
    decode:  coeff = sign(p) * floor(sqrt(p^2 * cg^3 / sum p^2))
"""

from __future__ import annotations

import math

import numpy as np


def isqrt(v: int) -> int:
    return math.isqrt(int(v))


def icbrt(v: int) -> int:
    v = int(v)
    if v <= 0:
        return 0
    r = round(v ** (1 / 3))
    while r * r * r > v:
        r -= 1
    while (r + 1) ** 3 <= v:
        r += 1
    return r


def icbrt_array(v):
    """Exact integer cube root, vectorized (matches icbrt elementwise).
    float64 cbrt is a <1-ulp seed for any int64 input, so a +-1 fixup
    pass settles every element exactly."""
    import numpy as np
    v = np.asarray(v, dtype=np.int64)
    r = np.rint(np.cbrt(np.maximum(v, 0).astype(np.float64))).astype(
        np.int64)
    r = np.where(r * r * r > v, r - 1, r)
    r = np.where((r + 1) ** 3 <= v, r + 1, r)
    # one more round guards the rare 2-ulp seed
    r = np.where(r * r * r > v, r - 1, r)
    r = np.where((r + 1) ** 3 <= v, r + 1, r)
    return np.where(v > 0, r, 0).astype(np.int32)


def pvq_prescale_shift(max_ax: int) -> int:
    """Right-shift that brings band magnitudes to <= 8 bits for the
    search (an encoder-side choice; all three implementations — numpy,
    C++, device — apply the same shift so selections are identical)."""
    s = 0
    while (int(max_ax) >> s) > 255:
        s += 1
    return s


def pvq_search(x: np.ndarray, k: int, max_abs: int | None = None
               ) -> np.ndarray:
    """Greedy PVQ: y in Z^n with sum|y| == k maximizing (x.y)^2 / (y.y).

    The per-pulse argmax uses EXACT 32-bit integer comparison so numpy,
    the C++ runtime and the device path (int32 only) pick
    identical positions: magnitudes prescale to <= 8 bits, then score
    a/b (a = (xy+ax)^2 <= 2^28, b = yy+2y+1 <= (k+1)^2) compares as the
    lexicographic pair (a//b, (a%b)*b_other) — the cross terms stay
    under 2^24.

    ``max_abs`` caps each |y_i|.  The wire format codes |y_i| with a
    qp-ary CDF (ffv2enc.c:181, alphabet size == qp), so |y_i| == qp is
    not representable; the reference's float search can still produce it
    (an out-of-bounds CDF write in the reference encoder).  We cap at
    qp-1 instead, staying reference-decodable."""
    ax_full = np.abs(x.astype(np.int64))
    y = np.zeros(len(x), dtype=np.int64)
    if k <= 0 or not ax_full.any():
        return y
    ax = (ax_full >> pvq_prescale_shift(int(ax_full.max()))).astype(np.int64)
    xy = 0
    yy = 0
    for _ in range(k):
        a = (xy + ax) ** 2
        b = yy + 2 * y + 1
        q = a // b
        r = a - q * b
        if max_abs is not None:
            blocked = y >= max_abs
            q = np.where(blocked, -1, q)
            if not (q >= 0).any():
                break
        # argmax of a/b: lexicographic (q, r cross-compared); first wins
        m = int(q.max())
        sel = np.nonzero(q == m)[0]
        best = int(sel[0])
        for j in sel[1:]:
            if r[j] * b[best] > r[best] * b[j]:
                best = int(j)
        y[best] += 1
        xy += int(ax[best])
        yy += 2 * int(y[best]) - 1
    return y * np.sign(x.astype(np.int64))


def band_reconstruct(pulses: np.ndarray, cg: int) -> np.ndarray:
    """Integer-exact band reconstruction shared by encoder model and
    decoder: coeff_j = sign(p_j) * floor(sqrt(p_j^2 * cg^3 / sum p^2))."""
    p = pulses.astype(np.int64)
    cnt = int(np.sum(p * p))
    if cnt == 0 or cg == 0:
        return np.zeros_like(p)
    c3 = int(cg) ** 3
    out = np.array([isqrt((int(v) * int(v) * c3) // cnt) for v in p],
                   dtype=np.int64)
    return out * np.sign(p)
