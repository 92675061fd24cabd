"""Public multi-chip FFV1 encoder: frames in -> packets out.

``ParallelFFV1Encoder`` runs the full device FFV1 pipeline under a
``jax.shard_map`` over a ("data", "slice") mesh:

* the **slice axis** shards FFV1 slices — independent coding units by
  format design (own predictor ring, context table, range coder;
  ffv1enc.c:1045-1102), so phase A + phase B need no communication at
  all; the per-slice byte buffers and exact lengths ride ONE
  ``all_gather`` over the slice axis (the collective analogue of the
  reference's sequential slice-trailer walk, ffv1enc.c:1236-1262) and
  the host lays out the 3-byte size + CRC trailers.
* the **data axis** carries independent streams (GOP-parallel: the
  device analogue of frame threading, pthread_frame.c:473): lane b
  encodes its own frame sequence, with the adaptive context state
  (``canonical``) carried device-resident between calls, exactly like
  the single-device session carries SliceState between frames.

Non-uniform slice geometries (odd frame sizes where the floor/ceil
slice boundaries differ, ff_ffv1_init_slice_contexts ffv1.c:117 — e.g.
FATE's 34x34) shard too: the single-device encoder already partitions
such frames into uniform-shape BANKS (device_coder.py slice_subset);
here each bank runs its own shard_map program over the same mesh (its
slice subset spread over the slice axis) and the host assembles the
per-bank gathers in global slice order.  Each bank's slice count must
divide the slice-axis size.

Byte-exactness contract: every packet is identical to the single-device
``DeviceFFV1Encoder``/host encoder output for the same frame sequence —
asserted by `__graft_entry__.dryrun_multichip` and tests.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core.crc import crc32_trailer
from ..ffv1.params import FFV1Config, CODER_GOLOMB
from ..ffv1.device_coder import (DeviceFFV1Encoder, GCAP, OP_GRAN,
                                 render_bytes, quantize_cap)
from ..ffv1.tpu import plane_context_diff, _wrap16
from .slices import gather_slice_bytes, uniform_slice_stack


class _BankUnit:
    """One uniform-geometry slice bank under the mesh: its own caps,
    carried coder state, and compiled shard_map programs.  For uniform
    frames there is exactly one unit covering every slice."""

    def __init__(self, enc: DeviceFFV1Encoder, mesh, data: int,
                 n_shards: int):
        if len(enc.slice_ids) % n_shards:
            raise ValueError(
                f"bank of {len(enc.slice_ids)} slices not divisible by "
                f"slice-axis size {n_shards} (slice shapes "
                f"{[pr[0][2:] for pr in enc.crop_plan]})")
        self.enc = enc
        self.mesh = mesh
        self.data = data
        self.n_shards = n_shards
        self.golomb = enc.golomb
        p = self.p = enc.p
        self.S_local = len(enc.slice_ids) // n_shards
        self.n_local = self.S_local * enc.npix
        self.chain_rows = self.S_local * enc.rows_per_slice
        # per-shard adaptive working domains, on quantize_cap rungs (the
        # same validate-and-grow contract as DeviceFFV1Encoder.encode;
        # sizes are pmax-ed over the slice axis so every shard agrees)
        nl = self.n_local
        self.tiles_max = (nl // GCAP + 2 * (enc.npix // GCAP + 2)
                          + self.chain_rows // 128 + 8)
        self.cellrows_max = (nl // 128 + (enc.npix // GCAP + 4) * GCAP
                             + self.tiles_max + 128)
        self.caps = {
            "tiles": quantize_cap(nl // GCAP + self.chain_rows // 128 + 72,
                                  self.tiles_max),
            "cellrows": quantize_cap(nl // 128 * 5 // 4 + 2 * GCAP + 256,
                                     self.cellrows_max),
            "sortrows": quantize_cap(nl // 128 * 9 // 8 + 1024,
                                     self.cellrows_max),
            "op": enc.op_cap,
            "render": enc.render_cap,
            "ev": enc.ev_cap if self.golomb else 0,
            "nwords": enc.nwords if self.golomb else 0,
        }
        self.caps["sortrows"] = min(self.caps["sortrows"],
                                    self.caps["cellrows"])
        # carried per-lane coder state, device-resident: [data, n_shards,
        # rows_local+1, k].  Rebuilt host-side only at init.
        if self.golomb:
            from ..ffv1.device_rice import VLC_INIT
            v0 = np.tile(np.asarray(VLC_INIT, np.int32),
                         (data, n_shards, self.chain_rows + 1, 1))
            self._state = jax.device_put(
                jnp.asarray(v0), jax.sharding.NamedSharding(
                    mesh, P("data", "slice", None, None)))
        else:
            c0 = np.full((data, n_shards, self.chain_rows + 1, 32), 128,
                         np.uint8)
            self._state = jax.device_put(
                jnp.asarray(c0), jax.sharding.NamedSharding(
                    mesh, P("data", "slice", None, None)))
        self._progs = {}

    # -- frame -> stacked slice crops (host) --------------------------------

    def crop_stacks(self, frames):
        enc = self.enc
        stacks = []
        for li, prects in enumerate(enc.crop_plan):
            st = np.stack([
                uniform_slice_stack(np.asarray(fr[li], np.int32), prects)
                for fr in frames])               # [data, S, hp, wp]
            stacks.append(st)
        return stacks

    # -- sharded program -----------------------------------------------------

    def _phase_a_local(self, crops):
        """Local slice crops (list of [S_local, hp, wp]) -> streams,
        mirroring DeviceFFV1Encoder._phase_a / _phase_a_rice."""
        enc, p = self.enc, self.p
        S_local = crops[0].shape[0]
        if p.colorspace == 1:
            # use32bit (RGB 16 bpc): int32 sample ring, no int16 wrap
            wr = (lambda x: x) if p.use32bit else _wrap16
            # 9..14-bit planar RGB without alpha reads G<->B swapped
            # (ffv1enc_template.c:170-172) — mirror DeviceFFV1Encoder
            swap = (not p.use32bit and not p.transparency and p.bits > 8)
            gi, bi = (1, 0) if swap else (0, 1)
            g, b, r = (crops[k].astype(jnp.int32) for k in (gi, bi, 2))
            offset = 1 << max(p.bits, 8)
            b2 = b - g
            r2 = r - g
            g2 = g + ((b2 + r2) >> 2)
            coded = [g2, b2 + offset, r2 + offset]
            if p.transparency:
                coded.append(crops[3].astype(jnp.int32))
            fn = functools.partial(plane_context_diff, qt=enc.qt,
                                   bits=enc.code_bits, five=enc.five)
            outs = [jax.vmap(fn)(wr(c)) for c in coded]
            if self.golomb:
                from ..ffv1.device_rice import build_rice_streams
                ctx_pl = [c for c, _ in outs]
                streams = build_rice_streams(
                    ctx_pl, [d for _, d in outs], pb=enc._rice_pb,
                    interleave=True)
                ctx = jnp.stack(ctx_pl, axis=2).reshape(S_local, -1)
                return ctx, None, streams
            ctx = jnp.stack([c for c, _ in outs], axis=2)
            diff = jnp.stack([d for _, d in outs], axis=2)
            return (ctx.reshape(S_local, -1),
                    diff.reshape(S_local, -1), None)
        fn = functools.partial(plane_context_diff, qt=enc.qt,
                               bits=p.bits, five=enc.five)
        ctx_pl, diff_pl = [], []
        for cr in crops:
            cr = _wrap16(cr.astype(jnp.int32))
            ctx, diff = jax.vmap(fn)(cr)
            ctx_pl.append(ctx)
            diff_pl.append(diff)
        ctx = jnp.concatenate(
            [c.reshape(S_local, -1) for c in ctx_pl], axis=1)
        if self.golomb:
            from ..ffv1.device_rice import build_rice_streams
            return ctx, None, build_rice_streams(ctx_pl, diff_pl,
                                                 pb=enc._rice_pb)
        diff = jnp.concatenate(
            [d.reshape(S_local, -1) for d in diff_pl], axis=1)
        return ctx, diff, None

    def _program(self, keyframe: bool, caps_key):
        """Compile (lazily) the sharded encode step for the current
        caps.  Returns a jitted fn(state, [*prefix,] *crop_stacks) ->
        (by_all, ln_all, sizes, new_state)."""
        key = (keyframe, caps_key)
        if key in self._progs:
            return self._progs[key]
        enc, p = self.enc, self.p
        caps = dict(self.caps)
        S_local = self.S_local
        golomb = self.golomb
        n_pl = len(enc.crop_plan)
        spec_in = P("data", "slice", None, None)
        spec_st = P("data", "slice", None, None)

        if golomb:
            def shard_body(state, *crops):
                crops = [c[0] for c in crops]
                vcanon = state[0, 0]
                ctx, _, streams = self._phase_a_local(crops)
                if keyframe:
                    from ..ffv1.device_rice import VLC_INIT
                    vcanon = jnp.broadcast_to(
                        jnp.asarray(VLC_INIT)[None, :],
                        vcanon.shape).astype(jnp.int32)
                plan = enc._s_rice_layout_impl(
                    ctx, streams["payload"], caps["tiles"],
                    caps["cellrows"])
                ch1c, ch2c = enc._s_scatter(plan, caps["cellrows"])
                from ..ffv1.device_rice import (build_vlc_s0,
                                                vlc_adapt_reference,
                                                writeback_vlc)
                s0 = build_vlc_s0(plan, vcanon, caps["tiles"])
                if enc.plan.impl("vlc") == "kernel":
                    from ..ffv1.device_rice import vlc_adapt_pallas
                    code_cells, ends = vlc_adapt_pallas(
                        ch1c, plan["tile_caps"], plan["tile_bases"],
                        plan["tile_pred"], s0, caps["tiles"],
                        int(ch1c.shape[0]), enc.code_bits)
                else:
                    code_cells, ends = vlc_adapt_reference(
                        ch1c, plan["tile_caps"], plan["tile_bases"],
                        plan["tile_pred"], s0, caps["tiles"],
                        enc.code_bits)
                vcanon = writeback_vlc(plan, vcanon, ends, caps["tiles"])
                vlc_codes = enc._s_rice_unsort_impl(
                    code_cells, ch2c, S_local, caps["sortrows"])
                by, nbits, n_lad = enc._s_rice_bits_impl(
                    streams, vlc_codes, caps["ev"], caps["nwords"])
                psizes = jnp.stack([plan["n_rows"], plan["n_tiles"],
                                    plan["n_slots"]])
                sz = jnp.concatenate([
                    psizes, jnp.max(n_lad)[None], jnp.max(nbits)[None]])
                by_all, nb_all = gather_slice_bytes(by, nbits)
                szm = jax.lax.pmax(jax.lax.pmax(sz, "slice"), "data")
                return (by_all[None], nb_all[None], szm[None],
                        vcanon[None, None])

            fn = jax.jit(jax.shard_map(
                shard_body, mesh=self.mesh, check_vma=False,
                in_specs=(spec_st,) + (spec_in,) * n_pl,
                out_specs=(P("data", None, None, None),
                           P("data", None, None), P("data", None),
                           spec_st)))
        else:
            def shard_body(state, svp, btp, hlen, *crops):
                crops = [c[0] for c in crops]
                canonical = state[0, 0]
                ctx, diff, _ = self._phase_a_local(crops)
                opw, n_ops, canonical, sizes = enc.ops_from_streams(
                    ctx, diff, canonical, svp[0], btp[0], hlen[0],
                    keyframe,
                    caps=(caps["tiles"], caps["cellrows"], caps["op"],
                          caps["sortrows"]),
                    ev_words=enc.unsort_words)
                f, c, v = enc._coder_impl(opw, int(opw.shape[1]))
                by, ln = render_bytes(f.T[:S_local], c.T[:S_local],
                                      v.T[:S_local], caps["render"])
                by_all, ln_all = gather_slice_bytes(by, ln)
                szm = jax.lax.pmax(jax.lax.pmax(sizes, "slice"), "data")
                return (by_all[None], ln_all[None], szm[None],
                        canonical[None, None])

            fn = jax.jit(jax.shard_map(
                shard_body, mesh=self.mesh, check_vma=False,
                in_specs=(spec_st, P("data", "slice", None),
                          P("data", "slice", None), P("data", "slice"))
                + (spec_in,) * n_pl,
                out_specs=(P("data", None, None, None),
                           P("data", None, None), P("data", None),
                           spec_st)))
        self._progs[key] = fn
        return fn

    def encode(self, frames, keyframe: bool):
        """Run this bank's sharded step (with the validate-and-grow cap
        retry) on one frame per data lane; returns host (by, ln) shaped
        [data, S_bank, cap] / [data, S_bank]."""
        enc = self.enc
        stacks = self.crop_stacks(frames)
        if not self.golomb:
            svp, btp, hlen = (np.asarray(a) for a in enc.prefix[keyframe])
            pref = (svp[None].repeat(self.data, 0),
                    btp[None].repeat(self.data, 0),
                    hlen[None].repeat(self.data, 0))
        for _ in range(8):
            caps_key = (tuple(sorted(self.caps.items())),
                        enc.unsort_words)
            fn = self._program(keyframe, caps_key)
            if self.golomb:
                by, ln, sz, new_state = fn(self._state, *stacks)
                szv = np.asarray(sz).max(axis=0)
                rows, tiles, slots = (int(v) for v in szv[:3])
                nl, nbmax = int(szv[3]), int(szv[4])
                ok = (rows + 1024 <= self.caps["cellrows"]
                      and rows <= self.caps["sortrows"]
                      and tiles <= self.caps["tiles"]
                      and slots <= self.caps["tiles"] * 128
                      and nl <= self.caps["ev"]
                      and nbmax <= self.caps["nwords"] * 32)
            else:
                by, ln, sz, new_state = fn(self._state, *pref, *stacks)
                szv = np.asarray(sz).max(axis=0)
                rows, tiles, slots, opmax = (int(v) for v in szv[:4])
                ln_h = np.asarray(ln)
                ok = (rows + 1024 <= self.caps["cellrows"]
                      and rows <= self.caps["sortrows"]
                      and tiles <= self.caps["tiles"]
                      and slots <= self.caps["tiles"] * 128
                      and opmax <= self.caps["op"]
                      and int(szv[4]) <= 4 * enc.unsort_words
                      and int(ln_h.max()) <= self.caps["render"])
            if ok:
                break
            self._grow(szv)
            if (not self.golomb
                    and int(np.asarray(ln).max()) > self.caps["render"]):
                self.caps["render"] = quantize_cap(
                    max(int(np.asarray(ln).max()) + 4096,
                        self.caps["render"] + 1),
                    self.enc.render_cap_max, 4096)
        else:
            raise RuntimeError("parallel encode exceeded worst-case caps")
        self._state = new_state
        S_bank = len(enc.slice_ids)
        by_h = np.asarray(by).reshape(self.data, S_bank, -1)
        ln_h = np.asarray(ln).reshape(self.data, S_bank)
        return by_h, ln_h

    def _grow(self, szv):
        caps = self.caps
        rows, tiles, slots = (int(v) for v in szv[:3])
        if rows + 1024 > caps["cellrows"] or tiles > caps["tiles"] \
                or slots > caps["tiles"] * 128:
            caps["tiles"] = quantize_cap(
                max(tiles + 64, caps["tiles"] + 1), self.tiles_max)
            caps["cellrows"] = quantize_cap(
                max(rows + 2048, caps["cellrows"] + 1), self.cellrows_max)
        if rows > caps["sortrows"]:
            caps["sortrows"] = quantize_cap(rows + 512, self.cellrows_max)
        caps["sortrows"] = min(caps["sortrows"], caps["cellrows"])
        if self.golomb:
            nl, nbmax = int(szv[3]), int(szv[4])
            if nl > caps["ev"]:
                caps["ev"] = quantize_cap(nl + 512, self.enc.ev_cap_max)
            if nbmax > caps["nwords"] * 32:
                caps["nwords"] = quantize_cap(nbmax // 32 + 256,
                                              self.enc.nwords_max, 8)
        else:
            opmax, maxc = int(szv[3]), int(szv[4])
            if opmax > caps["op"]:
                caps["op"] = quantize_cap(opmax + 512, self.enc.op_cap_max,
                                          OP_GRAN)
                caps["render"] = max(caps["render"],
                                     quantize_cap(opmax + 512,
                                                  self.enc.render_cap_max,
                                                  4096))
            if maxc > 4 * self.enc.unsort_words:
                from ..ffv1.device_coder import n_ev_words
                self.enc.unsort_words = min(
                    n_ev_words(self.enc.code_bits), (maxc + 3) // 4)


class ParallelFFV1Encoder:
    """Sharded FFV1 encode over a ("data", "slice") mesh.

    Parameters
    ----------
    width, height, pix_fmt, cfg : like ``DeviceFFV1Encoder``.
    mesh : ``jax.sharding.Mesh`` with axes ("data", "slice");
        every slice bank's count must be divisible by the slice-axis
        size (uniform frames have one bank of cfg.slices).

    ``encode_batch(frames)`` consumes one frame per data lane per call;
    lane b's frames form an independent stream (GOP-parallel).  All
    lanes share the keyframe flag per call (aligned GOPs), matching the
    GOP-parallel host decoder (ffv1/batched.py).
    """

    def __init__(self, width, height, pix_fmt, cfg: FFV1Config, mesh):
        if "data" not in mesh.shape or "slice" not in mesh.shape:
            raise ValueError('mesh must have axes ("data", "slice")')
        self.mesh = mesh
        self.data = int(mesh.shape["data"])
        self.n_shards = int(mesh.shape["slice"])
        if cfg.slices % self.n_shards:
            raise ValueError(
                f"slices={cfg.slices} not divisible by slice-axis size "
                f"{self.n_shards}")
        self.enc = DeviceFFV1Encoder(width, height, pix_fmt, cfg)
        self.p = self.enc.p
        self.cfg = cfg
        self.golomb = self.enc.golomb
        self.extradata = self.enc.extradata
        if self.enc._banks is not None:
            # non-uniform geometry: one sharded program per shape bank,
            # each bank's slice subset spread over the slice axis
            self.units = [_BankUnit(b, mesh, self.data, self.n_shards)
                          for b in self.enc._banks]
        else:
            self.units = [_BankUnit(self.enc, mesh, self.data,
                                    self.n_shards)]
        self.picture_number = 0

    # -- public API ----------------------------------------------------------

    def encode_batch(self, frames, force_keyframe=None):
        """Encode one frame per data lane (len(frames) == mesh data
        size); returns the list of assembled packets, byte-identical to
        the single-device encoder run per lane."""
        if len(frames) != self.data:
            raise ValueError(
                f"need {self.data} frames (one per data lane), got "
                f"{len(frames)}")
        p = self.p
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        S = p.slice_count
        chunks = [[None] * S for _ in range(self.data)]
        for unit in self.units:
            by_h, ln_h = unit.encode(frames, keyframe)
            enc = unit.enc
            for b in range(self.data):
                for li, si in enumerate(enc.slice_ids):
                    if self.golomb:
                        nby = (int(ln_h[b, li]) + 7) // 8
                        chunks[b][si] = (enc.rice_headers[keyframe][li]
                                         + by_h[b, li, :nby].tobytes())
                    else:
                        chunks[b][si] = \
                            by_h[b, li, :int(ln_h[b, li])].tobytes()
        self.picture_number += 1
        pkts = []
        for b in range(self.data):
            out = []
            for si in range(S):
                data = chunks[b][si]
                if si > 0 or p.version > 2:
                    assert len(data) < (1 << 24)
                    data += len(data).to_bytes(3, "big")
                    if p.ec:
                        data += b"\x00"
                        data += crc32_trailer(data)
                out.append(data)
            pkts.append(b"".join(out))
        return pkts
