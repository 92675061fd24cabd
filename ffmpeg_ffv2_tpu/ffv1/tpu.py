"""Device compute path for FFV1 — phase A: parallel context modeling.

The FFV1 encoder splits naturally into two phases:

* **Phase A (this module)** — for every pixel compute the coding context id
  and the folded residual.  On the *encoder* side there is no sequential
  dependency at all (the predictor reads original samples), so the whole
  plane is computed with pure shifts, table gathers and a median — pure
  elementwise work, one pass over device memory.  Runs under jit,
  shards over slices/frames with jax.sharding.
* **Phase B** — the adaptive coder consumes the (context, diff) stream.
  That part is serial per slice; it runs in the C++ host runtime
  (native/ffv1_runtime.cpp: encode_line over precomputed symbols) or on
  the device (device_coder.py).

Bit-exactness notes: samples are wrapped to int16 like the reference's
sample buffers (ffv1.c:145 int16 allocation); quant-table indexing uses the
C ``(a - b) & 0xFF`` semantics; the 5-input context model reads LL/TT with
the same guard-column rules as the row-ring implementation
(ffv1_template.c:32-52).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .params import FFV1Params, CONTEXT_SIZE


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _med3(a, b, c):
    # mid_pred(L, L+T-LT, T)
    mx = jnp.maximum(a, b)
    mn = jnp.minimum(a, b)
    return jnp.minimum(jnp.maximum(mn, c), mx)


def neighbours(s: jnp.ndarray):
    """All predictor taps for a plane with FFV1 border semantics.

    ``s`` is int32 [h, w] (already wrapped).  Returns dict of L, T, LT, RT,
    LL, TT (int32 [h, w]).
    """
    h, w = s.shape
    z_row = jnp.zeros((1, w), dtype=s.dtype)
    z_col = jnp.zeros((h, 1), dtype=s.dtype)

    T = jnp.concatenate([z_row, s[:-1]], axis=0)

    # L: s[y, x-1]; at x=0 the guard is prev[0] == T at x=0
    L = jnp.concatenate([T[:, :1], s[:, :-1]], axis=1)

    # LT: s[y-1, x-1]; at x=0 the guard carries s[y-2, 0]
    up2_col0 = jnp.concatenate([jnp.zeros((2, 1), dtype=s.dtype),
                                s[:-2, :1]], axis=0)
    LT = jnp.concatenate([up2_col0, T[:, :-1]], axis=1)

    # RT: s[y-1, x+1]; at x=w-1 the guard duplicates T
    RT = jnp.concatenate([T[:, 1:], T[:, -1:]], axis=1)

    # LL: s[y, x-2]; x==1 -> guard (-1) == T[y,0]; x==0 -> guard (-2) == 0
    LL = jnp.concatenate([z_col, T[:, :1], s[:, :-2]], axis=1)

    # TT: s[y-2, x]; rows 0,1 -> 0
    TT = jnp.concatenate([jnp.zeros((2, w), dtype=s.dtype), s[:-2]], axis=0)

    return {"L": L, "T": T, "LT": LT, "RT": RT, "LL": LL, "TT": TT}


def quant_lut(qt_row: np.ndarray):
    """Decompose one 256-entry quant table into (base, thresholds, deltas).

    The FFV1 quantizers are monotone step functions of the *signed* 8-bit
    difference (d8 = sign-extended low byte), so a table lookup becomes a
    handful of elementwise compares that fuse with the rest of phase A:
        qt(d8) = base + sum_t delta_t * (d8 >= t)
    """
    row = np.asarray(qt_row, dtype=np.int64)
    # reorder to signed domain: d8 in [-128, 127] maps to index d8 & 0xFF
    signed = np.concatenate([row[128:], row[:128]])  # d8=-128..-1, 0..127
    base = int(signed[0])
    deltas = np.diff(signed)
    nz = np.nonzero(deltas)[0]
    thr = (nz + 1 - 128).astype(np.int32)       # threshold in d8 domain
    dlt = deltas[nz].astype(np.int32)
    return base, thr, dlt


def build_quant_luts(qt: np.ndarray):
    """LUTs for all 5 rows, padded to a common threshold count.

    Returns (bases int32[5], thr int32[5, T], dlt int32[5, T]) — dlt=0
    padding keeps the compare-sum exact.
    """
    rows = [quant_lut(qt[k]) for k in range(5)]
    T = max(len(r[1]) for r in rows) or 1
    bases = np.array([r[0] for r in rows], dtype=np.int32)
    thr = np.zeros((5, T), dtype=np.int32)
    dlt = np.zeros((5, T), dtype=np.int32)
    for k, (b, t, d) in enumerate(rows):
        thr[k, :len(t)] = t
        dlt[k, :len(d)] = d
    return bases, thr, dlt


def _apply_quant(d, bases, thr, dlt, k, n_thr):
    """qt_k((d) & 0xFF as signed) via threshold compares."""
    d8 = ((d + 128) & 0xFF) - 128
    acc = jnp.full(d.shape, bases[k], dtype=jnp.int32)
    for t in range(n_thr):
        acc = acc + jnp.where(d8 >= thr[k, t], dlt[k, t], 0)
    return acc


def plane_context_diff(s: jnp.ndarray, qt, bits: int, five: bool):
    """(context >= 0, folded signed diff) for one plane.

    ``qt``: (bases, thr, dlt) from build_quant_luts (int32 arrays).
    ``five``: use the 5-input model (decided by qt[3][127]|qt[4][127] in
    the reference; static here).
    """
    n = neighbours(s)
    L, T, LT, RT, LL, TT = (n["L"], n["T"], n["LT"], n["RT"], n["LL"],
                            n["TT"])

    bases, thr, dlt = qt
    n_thr = thr.shape[1]
    ctx = (_apply_quant(L - LT, bases, thr, dlt, 0, n_thr)
           + _apply_quant(LT - T, bases, thr, dlt, 1, n_thr)
           + _apply_quant(T - RT, bases, thr, dlt, 2, n_thr))
    if five:
        ctx = (ctx + _apply_quant(LL - L, bases, thr, dlt, 3, n_thr)
               + _apply_quant(TT - T, bases, thr, dlt, 4, n_thr))

    pred = _med3(L, L + T - LT, T)
    diff = s - pred

    neg = ctx < 0
    ctx = jnp.where(neg, -ctx, ctx)
    diff = jnp.where(neg, -diff, diff)

    # fold to `bits`
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    diff = ((diff + half) & mask) - half

    return ctx.astype(jnp.int32), diff.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("bits", "five"))
def _phase_a_plane(s, qt, bits, five):
    s = _wrap16(s.astype(jnp.int32))
    return plane_context_diff(s, qt, bits, five)


def lut_for(p: FFV1Params, qt_index: int):
    bases, thr, dlt = build_quant_luts(p.quant_tables[qt_index])
    return (jnp.asarray(bases), jnp.asarray(thr), jnp.asarray(dlt))


class PhaseA:
    """Jitted phase-A for a parameter set.

    For YUV: call per plane with the full plane; slices are independent, so
    per-slice streams are produced by *cropping the input* per slice before
    the call (contexts depend on neighbours inside the slice only — FFV1
    resets the sample ring at slice borders).
    """

    def __init__(self, p: FFV1Params):
        self.p = p
        self.qts = [lut_for(p, i) for i in range(len(p.context_counts))]
        self.five = [bool(p.quant_tables[i][3][127]
                          or p.quant_tables[i][4][127])
                     for i in range(len(p.context_counts))]

    def plane(self, samples: np.ndarray, qt_index: int, bits: int):
        """samples: [h, w] ints; returns (ctx, diff) int32 [h, w]."""
        ctx, diff = _phase_a_plane(jnp.asarray(samples), self.qts[qt_index],
                                   bits, self.five[qt_index])
        return ctx, diff

    def rct(self, g, b, r, rct_by: int, rct_ry: int, bits: int):
        """Forward RCT (version-4 path) as jitted elementwise ops."""
        return _rct_fwd(jnp.asarray(g), jnp.asarray(b), jnp.asarray(r),
                        rct_by, rct_ry, bits)


@functools.partial(jax.jit, static_argnames=("bits",))
def _rct_fwd(g, b, r, rct_by, rct_ry, bits):
    offset = 1 << bits
    g = g.astype(jnp.int32)
    b = b.astype(jnp.int32)
    r = r.astype(jnp.int32)
    b2 = b - g
    r2 = r - g
    g2 = g + ((b2 * rct_by + r2 * rct_ry) >> 2)
    return _wrap16(g2), _wrap16(b2 + offset), _wrap16(r2 + offset)
