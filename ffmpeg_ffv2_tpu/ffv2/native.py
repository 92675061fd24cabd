"""Native (C++) FFV2 sessions: device batched transforms + host entropy.

Packets are byte-identical to the pure-Python codec (ffv2/codec.py); the
Daala EC, PVQ and band loops run in native code, the transforms and lapped
filters run batched on the device (jax).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.pixfmt import get_pix_fmt, PixelFormat
from ..ffv1.native import get_lib
from . import dsp
from .codec import (FFV2Config, PIXFMT_WIRE_IDS, PIXFMT_WIRE_NB,
                    _WIRE_TO_NAME, SPLIT_END)
from .entropy import cdf_triangle, _log2p1, UINT_BITS

SB = dsp.SB_SIZE


def _bind(lib):
    if getattr(lib, "_ffv2_bound", False):
        return lib
    lib.ffv2rt_enc_create.restype = ctypes.c_void_p
    lib.ffv2rt_enc_create.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
    lib.ffv2rt_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_enc_golomb.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ffv2rt_enc_bits.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_int]
    lib.ffv2rt_enc_cdf_q15.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_int]
    lib.ffv2rt_enc_sb.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_frame.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_frame_q.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffv2rt_enc_leaf.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
    lib.ffv2rt_enc_set_bands.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int]
    lib.ffv2rt_dec_set_bands.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int]
    lib.ffv2rt_dec_split.restype = ctypes.c_int
    lib.ffv2rt_dec_split.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_leaf.restype = ctypes.c_int
    lib.ffv2rt_dec_leaf.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_done.restype = ctypes.c_int64
    lib.ffv2rt_enc_done.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.ffv2rt_dec_create.restype = ctypes.c_void_p
    lib.ffv2rt_dec_create.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
    lib.ffv2rt_dec_destroy.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_set_qp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
    lib.ffv2rt_dec_golomb.restype = ctypes.c_uint32
    lib.ffv2rt_dec_golomb.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_bits.restype = ctypes.c_uint32
    lib.ffv2rt_dec_bits.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffv2rt_dec_cdf_q15.restype = ctypes.c_int
    lib.ffv2rt_dec_cdf_q15.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_int]
    lib.ffv2rt_dec_sb.restype = ctypes.c_int
    lib.ffv2rt_dec_sb.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_dec_frame.restype = ctypes.c_int
    lib.ffv2rt_dec_frame.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib._ffv2_bound = True
    return lib


def _enc_uint(lib, h, val, num):
    """ff_daalaent_encode_uint via the Q15 triangle CDFs."""
    if num > (1 << UINT_BITS):
        bit = _log2p1(num - 1) - UINT_BITS
        num -= 1
        adr = (num >> bit) + 1
        cdf = np.ascontiguousarray(cdf_triangle(adr), dtype=np.uint16)
        lib.ffv2rt_enc_cdf_q15(
            h, val >> bit,
            cdf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), adr)
        lib.ffv2rt_enc_bits(h, val & ((1 << bit) - 1), bit)
    else:
        cdf = np.ascontiguousarray(cdf_triangle(num), dtype=np.uint16)
        lib.ffv2rt_enc_cdf_q15(
            h, val, cdf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), num)


def _dec_uint(lib, h, num):
    if num > (1 << UINT_BITS):
        num -= 1
        bit = _log2p1(num) - UINT_BITS
        adr = (num >> bit) + 1
        cdf = np.ascontiguousarray(cdf_triangle(adr), dtype=np.uint16)
        t = lib.ffv2rt_dec_cdf_q15(
            h, cdf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), adr)
        t = (t << bit) | lib.ffv2rt_dec_bits(h, bit)
        return min(t, num)
    cdf = np.ascontiguousarray(cdf_triangle(num), dtype=np.uint16)
    return lib.ffv2rt_dec_cdf_q15(
        h, cdf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), num)


def _batched_tx(blocks, inverse):
    from .tpu import fwd_tx_batch, inv_tx_batch
    return (inv_tx_batch if inverse else fwd_tx_batch)(blocks)


class NativeFFV2Encoder:
    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV2Config | None = None):
        self.cfg = config or FFV2Config()
        if pix_fmt not in PIXFMT_WIRE_IDS:
            raise ValueError(f"unsupported ffv2 pix_fmt {pix_fmt}")
        self.fmt = get_pix_fmt(pix_fmt)
        self.pix_fmt_name = pix_fmt
        self.width = width
        self.height = height
        self.planes = self.fmt.nb_planes
        self.lib = _bind(get_lib())

    def encode(self, planes, front_q=None) -> bytes:
        """front_q optionally replaces the device front
        (tpu.encode_front_q) with a drop-in — e.g. the mesh-sharded
        parallel.ffv2.encode_front_q_sharded; same (dc, pulses, igain)
        contract, so the packet stays byte-identical."""
        qp = self.cfg.qp
        lib = self.lib
        bands = np.asarray(dsp.band_starts(SB), dtype=np.int32)
        h = lib.ffv2rt_enc_create(
            qp, bands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(bands))
        try:
            depth = self.fmt.bits
            _enc_uint(lib, h, PIXFMT_WIRE_IDS[self.pix_fmt_name],
                      PIXFMT_WIRE_NB)
            lib.ffv2rt_enc_golomb(h, qp)

            padded = np.stack([_pad_px(np.asarray(p), depth)
                               for p in planes])
            bs = self.cfg.block_size
            if bs != SB:
                self._encode_split_tree(lib, h, padded, depth, bs)
                return self._done(h)
            # one jitted program through quantization: Q12, lapped
            # prefilter, transform, zigzag, PVQ pulses and exact gain
            # split-sums — only ~1 byte/coeff leaves the device
            self._code_stage_into(h, self._front_stage(padded, front_q))
            return self._done(h)
        finally:
            lib.ffv2rt_enc_destroy(h)

    def _front_stage(self, padded, front_q=None):
        """Device stage of the q-path: Q12/lapping/transform/PVQ on the
        chip plus the tiny integer-cbrt gain fold — everything UP TO the
        serial Daala EC.  Returns the (dc, cg, pulses, geometry) tuple
        `_code_stage_into` consumes; pure function of the frame, so
        frames can be staged ahead of the entropy coder (pipelining)."""
        from .tpu import encode_front_q
        from .pvq import icbrt_array
        ph, pw = padded.shape[1:]
        nby, nbx = ph // SB, pw // SB
        bands_l = list(dsp.band_starts(SB))
        dc, pulses, igain = (front_q or encode_front_q)(
            padded, self.fmt.bits, self.cfg.qp, bands_l)
        cg = icbrt_array(np.asarray(igain))
        return (np.ascontiguousarray(dc, dtype=np.int64),
                np.ascontiguousarray(cg),
                np.ascontiguousarray(pulses),
                int(igain.shape[1]), nby * nbx)

    def _code_stage_into(self, h, fr):
        """Serial Daala EC over a staged front (C++; the ctypes call
        releases the GIL, so EC of frame t can overlap frame t+1's
        front on another thread)."""
        lib = self.lib
        dc64, cg, pulses, nbands, nblocks = fr
        lib.ffv2rt_enc_frame_q(
            h, dc64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pulses.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            pulses.shape[1], nbands, nblocks, self.planes, SB,
            dsp.TX_DCT)

    def _encode_split_tree(self, lib, h, padded, depth, bs):
        """Quad-tree leaves (uniform bs or activity-adaptive when bs==0)
        under the XY split syntax (ffv2enc.c:encode_block_rec order:
        TL, TR, BL, BR).  Transforms batch per leaf size on device."""
        from .codec import split_tree, uniform_tree
        ph, pw = padded.shape[1:]
        from .tpu import prefilter_frame
        coeff = np.asarray(prefilter_frame(padded, depth), dtype=np.int64)

        # per-SB trees + leaf list in walk order
        trees = {}
        leaves = []              # (y0, x0, n)
        def collect(tree, y0, x0, n):
            if tree[0] == "leaf":
                leaves.append((y0, x0, n))
                return
            half = n // 2
            collect(tree[1], y0, x0, half)
            collect(tree[2], y0, x0 + half, half)
            collect(tree[3], y0 + half, x0, half)
            collect(tree[4], y0 + half, x0 + half, half)

        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                if bs == 0:
                    t = split_tree(coeff, y0, x0, SB,
                                   self.cfg.split_threshold,
                                   self.cfg.min_block_size)
                else:
                    t = uniform_tree(SB, bs)
                trees[(y0, x0)] = t
                collect(t, y0, x0, SB)

        # batch transforms per leaf size; scatter scanned streams per leaf
        sizes = sorted({n for (_, _, n) in leaves})
        streams_by_leaf = {}
        for n in sizes:
            bands = np.asarray(dsp.band_starts(n), dtype=np.int32)
            lib.ffv2rt_enc_set_bands(
                h, n,
                bands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(bands))
            idxs = [i for i, lf in enumerate(leaves) if lf[2] == n]
            blocks = np.stack([
                coeff[p, leaves[i][0]:leaves[i][0] + n,
                      leaves[i][1]:leaves[i][1] + n]
                for i in idxs for p in range(self.planes)]).astype(np.int32)
            txed = _batched_tx(blocks, inverse=False)
            order = dsp.scan_order(n)
            scanned = np.ascontiguousarray(
                np.asarray(txed).reshape(len(blocks), -1)[:, order]
                .astype(np.int64))
            for k, i in enumerate(idxs):
                streams_by_leaf[i] = scanned[k * self.planes:
                                             (k + 1) * self.planes]

        li = iter(range(len(leaves)))
        def walk(tree, y0, x0, n):
            if tree[0] == "leaf":
                if n > 4:
                    lib.ffv2rt_enc_split(h, SPLIT_END)
                sub = np.ascontiguousarray(streams_by_leaf[next(li)])
                lib.ffv2rt_enc_leaf(
                    h, sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self.planes, n, dsp.TX_DCT)
                return
            lib.ffv2rt_enc_split(h, 1)          # SPLIT_XY
            half = n // 2
            walk(tree[1], y0, x0, half)
            walk(tree[2], y0, x0 + half, half)
            walk(tree[3], y0 + half, x0, half)
            walk(tree[4], y0 + half, x0 + half, half)

        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                walk(trees[(y0, x0)], y0, x0, SB)

    def _done(self, h) -> bytes:
        lib = self.lib
        cap = 1 << 24
        out = np.empty(cap, dtype=np.uint8)
        n = lib.ffv2rt_enc_done(
            h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("ffv2 native encode overflow")
        return out[:n].tobytes()


class PipelinedFFV2Encoder:
    """Frame-pipelined FFV2 encoder.

    The Daala entropy coder is ONE serial chain per frame by format
    design (reference: libavcodec/daala_entropy.c — a single adaptive
    CDF state threads every symbol), so it cannot be split within a
    frame.  Parallelism therefore comes from pipelining FRAMES: the C++
    EC of frame t runs on a worker thread (ctypes releases the GIL for
    the whole call) while the device computes frame t+1's front
    (Q12/lapping/transform/PVQ).  On an n-core host with EC the
    bottleneck this approaches depth-x throughput; packets are
    byte-identical to ``NativeFFV2Encoder`` because the EC is a pure
    function of the staged (dc, cg, pulses).

    Monolithic-SB (block_size=64) q-path only; other configs fall back
    to the sequential encoder per frame.
    """

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV2Config | None = None, depth: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self.enc = NativeFFV2Encoder(width, height, pix_fmt, config)
        self.depth = max(1, depth)
        self.pool = ThreadPoolExecutor(max_workers=self.depth)

    def _code_one(self, fr) -> bytes:
        enc = self.enc
        lib = enc.lib
        bands = np.asarray(dsp.band_starts(SB), dtype=np.int32)
        h = lib.ffv2rt_enc_create(
            enc.cfg.qp,
            bands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(bands))
        try:
            _enc_uint(lib, h, PIXFMT_WIRE_IDS[enc.pix_fmt_name],
                      PIXFMT_WIRE_NB)
            lib.ffv2rt_enc_golomb(h, enc.cfg.qp)
            enc._code_stage_into(h, fr)
            return enc._done(h)
        finally:
            lib.ffv2rt_enc_destroy(h)

    def encode_stream(self, frames, front_q=None):
        """Encode an iterable of frames; returns packets in order.
        Keeps at most ``depth`` frames in flight: frame t's EC overlaps
        frame t+1's device front."""
        import collections
        enc = self.enc
        if enc.cfg.block_size != SB:
            return [enc.encode(f) for f in frames]
        pend = collections.deque()
        out = []
        for planes in frames:
            padded = np.stack([_pad_px(np.asarray(p), enc.fmt.bits)
                               for p in planes])
            fr = enc._front_stage(padded, front_q)
            pend.append(self.pool.submit(self._code_one, fr))
            while len(pend) >= self.depth:
                out.append(pend.popleft().result())
        while pend:
            out.append(pend.popleft().result())
        return out

    def close(self):
        self.pool.shutdown(wait=True)


def _pad(plane):
    h, w = plane.shape
    ph = -(-h // SB) * SB
    pw = -(-w // SB) * SB
    out = np.zeros((ph, pw), dtype=np.int32)
    out[:h, :w] = plane
    return out


def _pad_px(plane, depth):
    """Pad a PIXEL plane to the SB grid with mid-grey (the pixel value
    whose Q12 coefficient is 0 — matches padding the coeff plane with 0)."""
    h, w = plane.shape
    ph = -(-h // SB) * SB
    pw = -(-w // SB) * SB
    out = np.full((ph, pw), 1 << (depth - 1), dtype=np.int32)
    out[:h, :w] = plane
    return out


class NativeFFV2Decoder:
    def __init__(self, width: int, height: int, osd: bool = False):
        self.width = width
        self.height = height
        self.fmt: PixelFormat | None = None
        self.lib = _bind(get_lib())
        self.osd = osd
        self.last_qp = 0
        self._frame_no = 0

    def decode(self, packet: bytes):
        """Decode one packet; with osd=True, stamp the reference's debug
        overlay into 8-bit luma (ffv2dec.c:357-371)."""
        from .osd import OsdTimer, osd_lines, stamp_osd
        with OsdTimer() as t:
            out = self._decode(packet)
        if self.osd:
            from .. import __version__
            ph = -(-self.height // SB) * SB
            pw = -(-self.width // SB) * SB
            out = [np.ascontiguousarray(pl) for pl in out]
            stamp_osd(out[0], self.fmt.bits, osd_lines(
                __version__, self.width, self.height, pw // SB, ph // SB,
                self.fmt.name, self._frame_no, self._frame_no, len(packet),
                t.ms, self.last_qp))
        self._frame_no += 1
        return out

    def _decode(self, packet: bytes):
        lib = self.lib
        buf = np.frombuffer(packet, dtype=np.uint8)
        h = lib.ffv2rt_dec_create(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(packet))
        try:
            wire = _dec_uint(lib, h, PIXFMT_WIRE_NB)
            name = _WIRE_TO_NAME.get(int(wire))
            if name is None:
                raise ValueError(f"unknown pix_fmt id {wire} in stream")
            self.fmt = get_pix_fmt(name)
            qp = self.last_qp = int(lib.ffv2rt_dec_golomb(h))
            bands = np.asarray(dsp.band_starts(SB), dtype=np.int32)
            lib.ffv2rt_dec_set_qp(
                h, qp, bands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(bands))

            nplanes = self.fmt.nb_planes
            depth = self.fmt.bits
            ph = -(-self.height // SB) * SB
            pw = -(-self.width // SB) * SB
            nby, nbx = ph // SB, pw // SB
            mx = (1 << depth) - 1

            for n in (4, 8, 16, 32):
                b = np.asarray(dsp.band_starts(n), dtype=np.int32)
                lib.ffv2rt_dec_set_bands(
                    h, n, b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    len(b))

            # walk the split tree (ffv2dec.c:decode_block_rec) collecting
            # leaves; inverse transforms batch afterwards
            leaves = []       # (y0, x0, n, streams [nplanes, n*n])

            def walk(y0, x0, n):
                if n > 4:
                    split = lib.ffv2rt_dec_split(h)
                    if split == 1:                       # SPLIT_XY
                        half = n // 2
                        walk(y0, x0, half)
                        walk(y0, x0 + half, half)
                        walk(y0 + half, x0, half)
                        walk(y0 + half, x0 + half, half)
                        return
                    if split != SPLIT_END:
                        raise NotImplementedError(
                            "non-square X/Y splits have no frequency "
                            "layout (NULL in the reference layout table)")
                sub = np.zeros((nplanes, n * n), dtype=np.int64)
                lib.ffv2rt_dec_leaf(
                    h, sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    nplanes, n)
                leaves.append((y0, x0, n, sub))

            for y0 in range(0, ph, SB):
                for x0 in range(0, pw, SB):
                    walk(y0, x0, SB)

            if all(lf[2] == SB for lf in leaves):
                streams = np.concatenate([lf[3] for lf in leaves])
            else:
                return self._reconstruct_leaves(leaves, nplanes, depth,
                                                ph, pw)
            from .tpu import decode_back
            pix = decode_back(streams.astype(np.int32), depth, nplanes,
                              nby, nbx)
            return [np.clip(pix[p, :self.height, :self.width]
                            .astype(np.int64), 0, mx)
                    for p in range(nplanes)]
        finally:
            lib.ffv2rt_dec_destroy(h)

    def _reconstruct_leaves(self, leaves, nplanes, depth, ph, pw):
        """General (mixed leaf size) reconstruction: batch the inverse
        transforms per size, place into the coeff frame, postfilter."""
        mx = (1 << depth) - 1
        coeff = np.zeros((nplanes, ph, pw), dtype=np.int64)
        from collections import defaultdict
        by_size = defaultdict(list)
        for i, (y0, x0, n, sub) in enumerate(leaves):
            by_size[n].append(i)
        for n, idxs in by_size.items():
            order = dsp.scan_order(n)
            stack = np.concatenate([leaves[i][3] for i in idxs])
            blocks = np.zeros((len(stack), n * n), dtype=np.int64)
            blocks[:, order] = stack
            inv = _batched_tx(blocks.reshape(-1, n, n).astype(np.int32),
                              inverse=True)
            inv = np.asarray(inv).reshape(len(idxs), nplanes, n, n)
            for k, i in enumerate(idxs):
                y0, x0, _, _ = leaves[i]
                coeff[:, y0:y0 + n, x0:x0 + n] = inv[k]
        out = []
        for p in range(nplanes):
            c = dsp.lap_filter_frame_hor(
                dsp.lap_filter_frame_ver(coeff[p], SB, 32, False),
                SB, 32, False)
            pix = dsp.coeff_to_ref(c.astype(np.int32), depth)
            out.append(np.clip(pix[:self.height, :self.width], 0, mx))
        return out
