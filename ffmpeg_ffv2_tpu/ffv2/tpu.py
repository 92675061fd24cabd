"""FFV2 device compute path: batched block transforms and lapped filters.

The transform is a fixed-point matmul (dsp.py) — on the device all
superblocks of a frame run as one batched dot per pass. Bit-exact with the
numpy reference on all inputs: both sides use mod-2^32 (int32 wraparound)
accumulation semantics (dsp._wrap32).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import dsp


@functools.partial(jax.jit, static_argnames=("n", "tx_type", "inverse"))
def _tx_batch(blocks, n, tx_type, inverse):
    """blocks: int32 [B, n, n] -> transformed int32 [B, n, n].

    int32 accumulation: valid Q12 content keeps every pass's dot products
    within int32 (Parseval bound ~2^29 at B=11); hostile overflow wraps
    mod 2^32, matching the numpy reference's _wrap32 semantics exactly.
    """
    m = jnp.asarray(dsp._basis(n, tx_type), dtype=jnp.int32)
    r = dsp._ROUND
    b = dsp._FRAC_BITS
    ptype = jnp.int32
    if not inverse:
        # numpy ref: rows = (x @ m.T + R) >> B ; out = (m @ rows + R) >> B
        rows = (jnp.einsum("bij,kj->bik", blocks, m,
                           preferred_element_type=ptype) + r) >> b
        out = (jnp.einsum("ai,bik->bak", m, rows,
                          preferred_element_type=ptype) + r) >> b
        return out
    else:
        # numpy ref: cols = (m.T @ c + R) >> B ; out = (cols @ m + R) >> B
        cols = (jnp.einsum("ai,bak->bik", m, blocks,
                           preferred_element_type=ptype) + r) >> b
        out = (jnp.einsum("bik,kj->bij", cols, m,
                          preferred_element_type=ptype) + r) >> b
        return out


def fwd_tx_batch(blocks: np.ndarray, tx_type: int = dsp.TX_DCT) -> np.ndarray:
    """Batched forward transform, bit-identical to dsp.fwd_tx_2d."""
    n = blocks.shape[-1]
    return np.asarray(_tx_batch(jnp.asarray(blocks, dtype=jnp.int32), n,
                                tx_type, False))


def inv_tx_batch(coeffs: np.ndarray, tx_type: int = dsp.TX_DCT) -> np.ndarray:
    n = coeffs.shape[-1]
    return np.asarray(_tx_batch(jnp.asarray(coeffs, dtype=jnp.int32), n,
                                tx_type, True))


# ---------------------------------------------------------------------------
# lapped biorthogonal filters (jax port of dsp.lap_prefilter/postfilter —
# same exact integer lifting; int32 on device vs int64 in numpy, identical
# for all valid Q12 content, reference itself is int32: ffv2.h dctcoef)
# ---------------------------------------------------------------------------


def _jx_incr_pos(v):
    return v + (v > 0).astype(v.dtype)


def _jx_c_div(a, b: int):
    q = jnp.abs(a) // abs(b)
    return jnp.where((a >= 0) == (b >= 0), q, -q)


def _jx_lap_prefilter(x, size: int):
    """x: int32 [..., size] -> filtered; mirrors dsp.lap_prefilter."""
    p = [int(v) for v in dsp.LAP_PARAMS[size]]
    h = size // 2
    t = [None] * size
    for i in range(h):
        t[size - 1 - i] = x[..., i] - x[..., size - 1 - i]
    for i in range(h):
        t[h - 1 - i] = x[..., h - 1 - i] - (t[h + i] >> 1)
    for i in range(h, size):
        t[i] = _jx_incr_pos((t[i] * p[i - h]) >> 6)
    for i in range(size - 1, h, -1):
        t[i] = t[i] + ((t[i - 1] * p[i - 1] + 32) >> 6)
        t[i - 1] = t[i - 1] + ((t[i] * p[i + h - 2] + 32) >> 6)
    y = [None] * size
    for i in range(h):
        t[i] = t[i] + (t[size - 1 - i] >> 1)
        y[i] = t[i]
    for i in range(h):
        y[h + i] = t[h - 1 - i] - t[h + i]
    return jnp.stack(y, axis=-1)


def _jx_lap_postfilter(x, size: int):
    p = [int(v) for v in dsp.LAP_PARAMS[size]]
    h = size // 2
    t = [None] * size
    for i in range(h):
        t[size - 1 - i] = x[..., i] - x[..., size - 1 - i]
    for i in range(h):
        t[h - 1 - i] = x[..., h - 1 - i] - (t[h + i] >> 1)
    for i in range(h, size - 1):
        t[i] = t[i] - ((t[i + 1] * p[i + h - 1] + 32) >> 6)
        t[i + 1] = t[i + 1] - ((t[i] * p[i] + 32) >> 6)
    for i in range(size - 1, h - 1, -1):
        t[i] = _jx_c_div(t[i] << 6, p[i - h])
    out = [None] * size
    for i in range(h):
        t[i] = t[i] + (t[size - 1 - i] >> 1)
        out[i] = t[i]
    for i in range(h, size):
        out[i] = t[size - 1 - i] - t[i]
    return jnp.stack(out, axis=-1)


def _jx_frame_hor(plane, sb: int, radius: int, forward: bool):
    """Filter across vertical SB boundaries; plane [..., H, W]."""
    h = radius // 2
    W = plane.shape[-1]
    xs = list(range(sb, W, sb))
    if not xs:
        return plane
    fn = _jx_lap_prefilter if forward else _jx_lap_postfilter
    slabs = jnp.stack([plane[..., x0 - h:x0 + h] for x0 in xs])
    filt = fn(slabs, radius)
    for i, x0 in enumerate(xs):
        plane = plane.at[..., x0 - h:x0 + h].set(filt[i])
    return plane


def _jx_frame_ver(plane, sb: int, radius: int, forward: bool):
    h = radius // 2
    H = plane.shape[-2]
    ys = list(range(sb, H, sb))
    if not ys:
        return plane
    fn = _jx_lap_prefilter if forward else _jx_lap_postfilter
    slabs = jnp.stack([jnp.swapaxes(plane[..., y0 - h:y0 + h, :], -1, -2)
                       for y0 in ys])
    filt = fn(slabs, radius)
    for i, y0 in enumerate(ys):
        plane = plane.at[..., y0 - h:y0 + h, :].set(
            jnp.swapaxes(filt[i], -1, -2))
    return plane


# ---------------------------------------------------------------------------
# fused frame pipelines: everything between pixels and the entropy coder
# runs as ONE jitted program (sample->Q12, lapped prefilter, block split,
# batched matmul transform, zigzag gather — and the exact inverse)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("depth", "sb", "n"))
def _encode_front(planes, depth, sb, n):
    """planes: int32 [P, ph, pw] (already padded to the SB grid) ->
    scanned coefficient streams int32 [nby*nbx*P, n*n] in raster order of
    n-sized blocks (lapped filtering stays at SB boundaries)."""
    P, ph, pw = planes.shape
    nby, nbx = ph // n, pw // n
    c = (planes << (12 - depth)) - 2048        # dsp.ref_to_coeff
    c = _jx_frame_hor(c, sb, 32, True)
    c = _jx_frame_ver(c, sb, 32, True)
    blocks = c.reshape(P, nby, n, nbx, n).transpose(1, 3, 0, 2, 4)
    blocks = blocks.reshape(-1, n, n)
    txed = _tx_batch(blocks, n, dsp.TX_DCT, False)
    order = jnp.asarray(dsp.scan_order(n))
    return txed.reshape(txed.shape[0], -1)[:, order]


@functools.partial(jax.jit, static_argnames=("depth", "sb", "nplanes",
                                             "nby", "nbx", "n"))
def _decode_back(streams, depth, sb, nplanes, nby, nbx, n):
    """Inverse of _encode_front: streams int32 [nby*nbx*P, n*n] (raster
    order of n-blocks) -> pixel planes int32 [P, ph, pw] (unclipped,
    caller crops + clips)."""
    order = jnp.asarray(dsp.scan_order(n))
    blocks = jnp.zeros_like(streams).at[:, order].set(streams)
    inv = _tx_batch(blocks.reshape(-1, n, n), n, dsp.TX_DCT, True)
    c = inv.reshape(nby, nbx, nplanes, n, n).transpose(2, 0, 3, 1, 4)
    c = c.reshape(nplanes, nby * n, nbx * n)
    c = _jx_frame_ver(c, sb, 32, False)
    c = _jx_frame_hor(c, sb, 32, False)
    return (c + 2048) >> (12 - depth)          # dsp.coeff_to_ref


def encode_front(planes_padded: np.ndarray, depth: int,
                 sb: int = None, n: int = None) -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    n = n or sb
    return np.asarray(_encode_front(
        jnp.asarray(planes_padded, dtype=jnp.int32), depth, sb, n))


def decode_back(streams: np.ndarray, depth: int, nplanes: int,
                nby: int, nbx: int, sb: int = None,
                n: int = None) -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    n = n or sb
    return np.asarray(_decode_back(
        jnp.asarray(streams, dtype=jnp.int32), depth, sb, nplanes,
        nby, nbx, n))


@functools.partial(jax.jit, static_argnames=("depth", "sb"))
def _prefilter_frame(planes, depth, sb):
    """planes int32 [P, ph, pw] -> prefiltered Q12 coefficient planes
    (the common front of encode_front, before block split)."""
    c = (planes << (12 - depth)) - 2048
    c = _jx_frame_hor(c, sb, 32, True)
    c = _jx_frame_ver(c, sb, 32, True)
    return c


def prefilter_frame(planes_padded: np.ndarray, depth: int,
                    sb: int = None) -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    return np.asarray(_prefilter_frame(
        jnp.asarray(planes_padded, dtype=jnp.int32), depth, sb))


# ---------------------------------------------------------------------------
# device quantization: DC + per-band PVQ pulses + exact split gain sums
# ---------------------------------------------------------------------------


def _pvq_band_device(band_abs, qp):
    """Greedy PVQ pulses for one band across all blocks.

    band_abs: int32 [B, L] magnitudes.  Mirrors pvq.pvq_search exactly:
    8-bit prescale, per-pulse argmax by the exact integer pair
    (a//b, (a%b) cross-product), ties to the lowest index (tournament
    reduce keeping the left operand on equality).  All values fit int32.
    """
    B, L = band_abs.shape
    Lp = 1 << max(1, (L - 1).bit_length())
    pad = Lp - L
    mx = jnp.max(band_abs, axis=1, keepdims=True)
    f = jnp.maximum(mx, 1).astype(jnp.float32)
    bl = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 126  # bits
    shift = jnp.maximum(bl - 8, 0)
    ax = band_abs >> shift
    ax = jnp.pad(ax, ((0, 0), (0, pad)))
    valid = jnp.pad(jnp.ones((B, L), bool), ((0, 0), (0, pad)))

    def pulse_iter(carry, _):
        y, xy, yy = carry
        a = (xy[:, None] + ax) ** 2
        b = yy[:, None] + 2 * y + 1
        q = a // b
        r = a - q * b
        q = jnp.where(valid & (y < qp - 1), q, -1)

        idx = jnp.broadcast_to(jnp.arange(Lp, dtype=jnp.int32), (B, Lp))
        tq, tr, tb, ti = q, r, b, idx
        length = Lp
        while length > 1:
            h = length // 2
            ql, qr = tq[:, :h], tq[:, h:length]
            rl, rr = tr[:, :h], tr[:, h:length]
            bb_l, bb_r = tb[:, :h], tb[:, h:length]
            il, ir = ti[:, :h], ti[:, h:length]
            cl = rl * bb_r
            cr = rr * bb_l
            left = (ql > qr) | ((ql == qr)
                               & ((cl > cr) | ((cl == cr) & (il < ir))))
            tq = jnp.where(left, ql, qr)
            tr = jnp.where(left, rl, rr)
            tb = jnp.where(left, bb_l, bb_r)
            ti = jnp.where(left, il, ir)
            length = h
        best = ti[:, 0]
        ok = tq[:, 0] >= 0
        onehot = (jnp.arange(Lp, dtype=jnp.int32)[None, :]
                  == best[:, None]) & ok[:, None]
        y2 = y + onehot.astype(jnp.int32)
        xy2 = xy + jnp.sum(jnp.where(onehot, ax, 0), axis=1)
        yy2 = yy + jnp.sum(jnp.where(onehot, 2 * y2 - 1, 0), axis=1)
        return (y2, xy2, yy2), 0

    y0 = jnp.zeros((B, Lp), jnp.int32)
    z0 = jnp.zeros((B,), jnp.int32)
    (y, _, _), _ = jax.lax.scan(pulse_iter, (y0, z0, z0), None, length=qp)
    return y[:, :L]


@functools.partial(jax.jit, static_argnames=("qp", "bands", "n"))
def _quantize_streams(streams, qp, bands, n):
    """streams int32 [NB, n*n] in coding order -> (dc int32 [NB],
    pulses int8 [NB, n*n-1 (+phantom)], gain split-sums int32
    [NB, n_bands, 3]): igain = s0*2^18 + 2*s1*2^9 + s2, exact
    (|coeff| < 2^18, band length <= 4096)."""
    dc = streams[:, 0]
    n_ac = n * n - 1
    ac = streams[:, 1:]
    last = bands[-1]
    if last > n_ac:                      # the phantom position
        ac = jnp.pad(ac, ((0, 0), (0, last - n_ac)))
    pulses = []
    sums = []
    for bi in range(len(bands) - 1):
        lo, hi = bands[bi], bands[bi + 1]
        band = ac[:, lo:hi]
        aa = jnp.abs(band)
        h = aa >> 9
        l = aa & 511
        sums.append(jnp.stack([jnp.sum(h * h, axis=1),
                               jnp.sum(h * l, axis=1),
                               jnp.sum(l * l, axis=1)], axis=1))
        y = _pvq_band_device(aa, qp)
        pulses.append((y * jnp.sign(band)).astype(jnp.int8))
    return dc, jnp.concatenate(pulses, axis=1), jnp.stack(sums, axis=1)


def quantize_streams(streams, qp: int, band_starts, n: int):
    """Host wrapper: returns numpy (dc, pulses, igain) with igain the
    exact int64 per-band energy (combined from the int32 split sums)."""
    dc, pulses, sums = _quantize_streams(
        jnp.asarray(streams, jnp.int32), qp, tuple(band_starts), n)
    s = np.asarray(sums).astype(np.int64)
    igain = (s[..., 0] << 18) + (s[..., 1] << 10) + s[..., 2]
    return np.asarray(dc), np.asarray(pulses), igain


@functools.partial(jax.jit, static_argnames=("depth", "sb", "n", "qp",
                                             "bands"))
def _encode_front_q(planes, depth, sb, n, qp, bands):
    streams = _encode_front(planes.astype(jnp.int32), depth, sb, n)
    dc, pulses, sums = _quantize_streams(streams, qp, bands, n)
    # pack everything into one uint8 buffer: a single device->host fetch
    nb = dc.shape[0]
    head = jnp.concatenate(
        [jax.lax.bitcast_convert_type(dc, jnp.uint8).reshape(nb, -1),
         jax.lax.bitcast_convert_type(sums, jnp.uint8).reshape(nb, -1)],
        axis=1)
    return jnp.concatenate(
        [head, pulses.astype(jnp.uint8)], axis=1), sums.shape[1]


def encode_front_q(planes_padded: np.ndarray, depth: int, qp: int,
                   band_starts, sb: int = None, n: int = None):
    """Fused device front: Q12 + lapped prefilter + DCT + zigzag +
    quantization; only the quantized data (dc, int8 pulses, gain split
    sums) leaves the device, in one packed fetch.  Uploads stay at the
    source bit depth (uint8/uint16) to spare the link."""
    sb = sb or dsp.SB_SIZE
    n = n or sb
    dt = np.uint8 if depth <= 8 else np.uint16
    packed, nbands = _encode_front_q(
        jnp.asarray(planes_padded.astype(dt)), depth, sb, n, qp,
        tuple(band_starts))
    buf = np.asarray(packed)
    nb = buf.shape[0]
    dc = buf[:, :4].copy().view(np.int32).reshape(nb)
    sums = buf[:, 4:4 + nbands * 12].copy().view(np.int32)         .reshape(nb, nbands, 3).astype(np.int64)
    pulses = buf[:, 4 + nbands * 12:].view(np.int8)
    igain = (sums[..., 0] << 18) + (sums[..., 1] << 10) + sums[..., 2]
    return dc, pulses, igain
