"""Hybrid FFV1 encoder: phase A (context modeling) on the device, phase B
(adaptive entropy coding) in the slice-threaded C++ host runtime.

Slices are independent coding units — the sample ring resets at slice
borders (ffv1enc.c:282) — so phase A runs per slice crop.  Same-shaped
slice crops are stacked and processed in one vmapped jit call, which is
also the unit that shards across devices (parallel/slices.py).

Produces packets byte-identical to the pure host encoder (tested in
tests/test_tpu_phase_a.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .params import FFV1Params, FFV1Config, params_from_config, CODER_GOLOMB
from .native import NativeFFV1Codec
from .tpu import plane_context_diff, _wrap16, lut_for
from . import headers as H


@functools.partial(jax.jit, static_argnames=("bits", "five"))
def _phase_a_batch(crops, qt, bits, five):
    """crops: int32 [n, h, w] (already wrapped) -> (ctx, diff) each [n,h,w].

    Outputs are narrowed to int16 on device (ctx < 32768 by the format's
    context-count cap; |diff| < 2^15 for bits <= 16) — the hybrid
    pipeline copies them to the host, so halve the bytes."""
    fn = functools.partial(plane_context_diff, qt=qt, bits=bits, five=five)
    ctx, diff = jax.vmap(lambda s: fn(s))(crops)
    return ctx.astype(jnp.int16), diff.astype(jnp.int16)


def ceil_rshift(v, s):
    return -(-v >> s) if s else v


@functools.partial(jax.jit,
                   static_argnames=("bits", "rb", "five", "alpha"))
def _phase_a_rgb_batch(crops, qt, bits, rb, five, alpha):
    """crops: (g, b, r, [a]) int32 [n_slices, h, w] -> per-plane
    (ctx, diff) lists at coding depth rb = max(bits, 8) + 1."""
    g, b, r = crops[0], crops[1], crops[2]
    offset = 1 << max(bits, 8)
    b2 = b - g
    r2 = r - g
    g2 = g + ((b2 + r2) >> 2)          # rct_by = rct_ry = 1 (version <= 3)
    b2 = b2 + offset
    r2 = r2 + offset
    coded = [g2, b2, r2] + ([crops[3]] if alpha else [])
    fn = functools.partial(plane_context_diff, qt=qt, bits=rb, five=five)
    outs = [jax.vmap(lambda s: fn(_wrap16(s)))(pl.astype(jnp.int32))
            for pl in coded]
    return ([c.astype(jnp.int16) for c, _ in outs],
            [d.astype(jnp.int16) for _, d in outs])


class TPUFFV1Encoder:
    """Encoder session; device for modeling, native host runtime for coding."""

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None, n_threads: int = 0):
        self.cfg = config or FFV1Config()
        self.p = params_from_config(self.cfg, pix_fmt, width, height)
        if self.p.colorspace == 1 and self.p.version > 3:
            raise NotImplementedError(
                "device phase-A RGB covers fixed RCT (version <= 3); the v4 "
                "per-slice coefficient search uses the host path")
        if self.p.colorspace == 1 and self.p.use32bit:
            raise NotImplementedError(
                "device phase-A RGB covers the int16 sample ring (<= 14 bpc)")
        self.native = NativeFFV1Codec(self.p, n_threads)
        self.extradata = (H.write_extradata(self.p)
                          if self.p.version > 1 else b"")
        self.picture_number = 0
        p = self.p
        self.qt = lut_for(p, p.context_model)
        self.five = bool(p.quant_tables[p.context_model][3][127]
                         or p.quant_tables[p.context_model][4][127])
        self._plan = self._build_plan()

    # -- slice crop planning ------------------------------------------------

    def _build_plan(self):
        """Per coded plane: list of (slice rect in plane resolution)."""
        p = self.p
        plan = []
        if p.colorspace == 1:
            plane_dims = [(p.width, p.height, 0, 0)] * (3 + p.transparency)
        else:
            plane_dims = [(p.width, p.height, 0, 0)]
            if p.chroma_planes:
                hs, vs = p.chroma_h_shift, p.chroma_v_shift
                cw, ch = ceil_rshift(p.width, hs), ceil_rshift(p.height, vs)
                plane_dims += [(cw, ch, hs, vs)] * 2
            if p.transparency:
                plane_dims.append((p.width, p.height, 0, 0))
        rects = p.rects()
        for (pw, ph, hs, vs) in plane_dims:
            prects = []
            for (x, y, w, h) in rects:
                px, py = x >> hs, y >> vs
                pw2, ph2 = ceil_rshift(w, hs), ceil_rshift(h, vs)
                prects.append((px, py, pw2, ph2))
            plan.append(prects)
        return plan

    def phase_a(self, planes):
        """Run device phase A.

        Returns (ctx, diff) crop arrays indexed [slice * n_planes + plane].
        Crops are per slice because chroma slices of odd-sized frames
        overlap by a row/column (each slice codes its ceil-rounded chroma
        rect independently) — a full-frame array cannot hold both.
        """
        p = self.p
        if p.colorspace == 1:
            return self._phase_a_rgb(planes)
        n_slices = p.slice_count
        n_planes = len(self._plan)
        ctx_streams = [None] * (n_slices * n_planes)
        diff_streams = [None] * (n_slices * n_planes)
        for li, prects in enumerate(self._plan):
            plane = np.asarray(planes[li])
            # group slices by crop shape -> one batched call per shape
            groups = {}
            for si, (x, y, w, h) in enumerate(prects):
                groups.setdefault((h, w), []).append(si)
            for (h, w), sis in groups.items():
                crops = np.stack([
                    plane[prects[si][1]:prects[si][1] + h,
                          prects[si][0]:prects[si][0] + w]
                    for si in sis]).astype(np.int32)
                crops = np.asarray(_wrap16(crops), dtype=np.int32)
                ctx, diff = _phase_a_batch(jnp.asarray(crops), self.qt,
                                           p.bits, self.five)
                ctx = np.asarray(ctx)
                diff = np.asarray(diff)
                for k, si in enumerate(sis):
                    ctx_streams[si * n_planes + li] = ctx[k]
                    diff_streams[si * n_planes + li] = diff[k]
        return ctx_streams, diff_streams

    def _phase_a_rgb(self, planes):
        """RGB phase A: per-slice RCT (JPEG2000-style, fixed 1,1
        coefficients for version <= 3; ffv1enc_template.c:175-181) then
        context modeling at bits+1 on the transformed g,b,r,(a) planes."""
        p = self.p
        rects = self._plan[0]
        n_planes = len(self._plan)
        # 9..14-bit planar RGB without alpha reads G<->B swapped
        # (ffv1enc_template.c:170-172)
        swap = (not p.use32bit and not p.transparency and p.bits > 8)
        gi, bi = (1, 0) if swap else (0, 1)
        src = [np.asarray(pl) for pl in planes]
        crops = [np.stack([src[k][y:y + h, x:x + w]
                           for (x, y, w, h) in rects]).astype(np.int32)
                 for k in (gi, bi, 2) + ((3,) if p.transparency else ())]
        rb = (max(p.bits, 8) + 1)
        ctx, diff = _phase_a_rgb_batch(
            tuple(jnp.asarray(c) for c in crops), self.qt, p.bits, rb,
            self.five, bool(p.transparency))
        ctx = [np.asarray(c) for c in ctx]
        diff = [np.asarray(d) for d in diff]
        n_slices = p.slice_count
        ctx_streams = [None] * (n_slices * n_planes)
        diff_streams = [None] * (n_slices * n_planes)
        for li in range(n_planes):
            for si in range(n_slices):
                ctx_streams[si * n_planes + li] = ctx[li][si]
                diff_streams[si * n_planes + li] = diff[li][si]
        return ctx_streams, diff_streams

    # -- public API ---------------------------------------------------------

    def encode(self, planes, force_keyframe=None) -> bytes:
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        ctx_streams, diff_streams = self.phase_a(planes)
        pkt = self.native.encode_sym(planes, ctx_streams, diff_streams,
                                     keyframe)
        self.picture_number += 1
        return pkt
