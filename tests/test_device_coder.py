"""Device phase-B coder: stage oracles against the native planner."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import device_coder as dc
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu.ffv1.codec_py import SliceState


def ref_put_symbol_ops(v, bits):
    """Slot/bit sequence of put_symbol_inline for one value (no states),
    incl. the e > 9 FFMIN slot caps (ffv1enc.c:203-230)."""
    ops = []
    if v:
        a = abs(v)
        e = a.bit_length() - 1
        ops.append((0, 0))
        for i in range(e):
            ops.append((1 + min(i, 9), 1))
        ops.append((1 + min(e, 9), 0))
        for i in range(e - 1, -1, -1):
            ops.append((22 + min(i, 9), (a >> i) & 1))
        ops.append((11 + min(e, 10), 1 if v < 0 else 0))
    else:
        ops.append((0, 1))
    return ops


@pytest.mark.parametrize("bits", [8, 9, 10, 12, 16])
def test_emission_slots_match_reference(bits):
    import jax.numpy as jnp
    half = 1 << (bits - 1)
    diffs = np.concatenate([
        np.arange(-half, half, max(1, half // 64)), [-half, half - 1, 0, 1, -1]])
    K = dc.k_max_for_bits(bits)
    slot, bit, valid = dc.emission_slots(jnp.asarray(diffs, jnp.int32), K)
    slot, bit, valid = map(np.asarray, (slot, bit, valid))
    for j, v in enumerate(diffs):
        ref = ref_put_symbol_ops(int(v), bits)
        assert valid[j].sum() == len(ref)
        got = list(zip(slot[j][valid[j]], bit[j][valid[j]]))
        assert got == ref, f"v={v}"


@pytest.mark.parametrize("bits", [8, 10])
def test_slot_grid_matches_reference(bits):
    import jax.numpy as jnp
    half = 1 << (bits - 1)
    diffs = np.concatenate([
        np.arange(-half, half, max(1, half // 100)), [-half, half - 1, 0]])
    valid, bit = dc.slot_bit_grid(jnp.asarray(diffs, jnp.int32))
    valid, bit = np.asarray(valid), np.asarray(bit)
    for j, v in enumerate(diffs):
        ref = dict(ref_put_symbol_ops(int(v), bits))
        assert set(np.nonzero(valid[j])[0]) == set(ref)
        for s, b in ref.items():
            assert bit[j, s] == b, f"v={v} slot={s}"


def test_lookup_packed():
    import jax.numpy as jnp
    p = params_from_config(FFV1Config(level=3, coder=1), "yuv420p", 32, 32)
    zero, one = dc.transition_tables(p)
    tab = jnp.asarray(np.broadcast_to(dc.packed_transition_table(p), (4, 128)))
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 512, (4, 128)).astype(np.int32)
    got = np.asarray(dc.lookup_packed(tab, jnp.asarray(idx)))
    t2 = np.concatenate([zero, one]).astype(np.int32)
    assert np.array_equal(got, t2[idx])


def _native_plans(p, planes, keyframe=True):
    """Per-slice (sv, bit) streams from the native planner (the oracle)."""
    import ctypes
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec, get_lib
    codec = NativeFFV1Codec(p)
    lib = get_lib()
    lib.ffv1rt_plan.restype = ctypes.c_int64
    lib.ffv1rt_plan.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    lib.ffv1rt_get_plan.restype = ctypes.c_int64
    lib.ffv1rt_get_plan.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    arrs = [np.ascontiguousarray(pl, dtype=np.int32) for pl in planes]
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
    mx = lib.ffv1rt_plan(codec.handle, ptrs, 1 if keyframe else 0)
    assert mx > 0
    plans = []
    for si in range(p.slice_count):
        sv = np.empty(mx, dtype=np.uint8)
        bt = np.empty(mx, dtype=np.uint8)
        ln = lib.ffv1rt_get_plan(
            codec.handle, si,
            sv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), mx)
        plans.append((sv[:ln].copy(), bt[:ln].copy()))
    return plans


def _phase_a_streams(p, planes):
    """Per-slice (ctx, pclass, diff) streams in coding order via the
    device phase A."""
    from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder
    import jax.numpy as jnp
    enc = TPUFFV1Encoder.__new__(TPUFFV1Encoder)   # reuse crop planner only
    enc.p = p
    plan = TPUFFV1Encoder._build_plan(enc)
    from ffmpeg_ffv2_tpu.ffv1.tpu import lut_for, _wrap16, plane_context_diff
    out = []
    for si in range(p.slice_count):
        ctxs, pcs, diffs = [], [], []
        for li, prects in enumerate(plan):
            pc = (li + 1) // 2
            qt = lut_for(p, p.context_model)
            five = bool(p.quant_tables[p.context_model][3][127]
                        or p.quant_tables[p.context_model][4][127])
            x, y, w, h = prects[si]
            crop = np.asarray(planes[li])[y:y + h, x:x + w].astype(np.int32)
            crop = np.asarray(_wrap16(jnp.asarray(crop)), dtype=np.int32)
            ctx, diff = plane_context_diff(jnp.asarray(crop), qt, p.bits,
                                           five)
            ctxs.append(np.asarray(ctx).ravel())
            pcs.append(np.full(w * h, pc, dtype=np.int32))
            diffs.append(np.asarray(diff).ravel())
        out.append((np.concatenate(ctxs), np.concatenate(pcs),
                    np.concatenate(diffs)))
    return out


def test_oracle_stream_matches_native_plan():
    rng = np.random.RandomState(7)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    planes = [rng.randint(0, 256, (h, w)).astype(np.int32),
              rng.randint(0, 256, (h // 2, w // 2)).astype(np.int32),
              rng.randint(0, 256, (h // 2, w // 2)).astype(np.int32)]
    plans = _native_plans(p, planes, keyframe=True)
    streams = _phase_a_streams(p, planes)
    rects = p.rects()
    for si in range(p.slice_count):
        ss = SliceState(p)
        pre_sv, pre_bit = dc.plan_slice_prefix(p, ss, si, rects[si], True)
        ctx, pc, diff = streams[si]
        states = [np.full((n, 32), 128, dtype=np.uint8)
                  for n in ss.plane_ctx_count]
        body_sv, body_bit = dc.oracle_plane_ops(p, ctx, pc, diff, states)
        sv = np.concatenate([pre_sv, body_sv, [dc.TERMINATOR_SV]])
        bit = np.concatenate([pre_bit, body_bit, [0]])
        nsv, nbit = plans[si]
        assert len(sv) == len(nsv), f"slice {si}: {len(sv)} vs {len(nsv)}"
        assert np.array_equal(sv, nsv), f"slice {si} sv mismatch"
        assert np.array_equal(bit, nbit), f"slice {si} bit mismatch"


@pytest.mark.parametrize("pix,wh,coder", [
    ("yuv420p", (64, 48), 1),
    ("yuv420p", (64, 48), -2),          # default-table range coder
    ("gray", (48, 32), 1),
    ("yuv422p10", (32, 32), 1),
    ("bgr0", (48, 32), 1),              # RGB: RCT + line-interleaved stream
    ("yuv444p16", (32, 24), 1),         # wide: slot 10/31 repeat sub-steps
    ("gray16", (40, 24), 1),
])
def test_device_encoder_byte_exact(pix, wh, coder):
    """Full XLA device pipeline == native packets, key + inter frames."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(11)
    w, h = wh
    cfg = FFV1Config(level=3, coder=coder, slices=4)
    p = params_from_config(cfg, pix, w, h)
    dev = DeviceFFV1Encoder(w, h, pix, cfg)
    nat = NativeFFV1Codec(p)
    mx = (1 << p.bits) - 1
    shapes = [(h, w)]
    if p.chroma_planes:
        shapes += [(h >> p.chroma_v_shift, w >> p.chroma_h_shift)] * 2
    for t in range(4):
        # mix of noisy and flat content (flat exercises mega-group lanes)
        planes = [rng.randint(0, mx + 1, s).astype(np.int32) for s in shapes]
        if t == 2:
            planes = [np.full(s, 100, np.int32) for s in shapes]
        key = t % 3 == 0
        pkt_dev = dev.encode(planes, force_keyframe=key)
        pkt_nat = nat.encode(planes, key)
        assert pkt_dev == pkt_nat, f"frame {t} packet mismatch " \
            f"({len(pkt_dev)} vs {len(pkt_nat)} bytes)"


def test_device_encoder_batch_intra():
    """encode_batch: B intra frames in one fused program == per-frame
    native packets (frame-parallel analogue, all-intra)."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(3)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    dev = DeviceFFV1Encoder(w, h, "yuv420p", cfg)
    nat = NativeFFV1Codec(p)
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    frames = [[rng.randint(0, 256, s).astype(np.int32) for s in shapes]
              for _ in range(3)]
    frames[1] = [np.full(s, 77, np.int32) for s in shapes]
    pkts = dev.encode_batch(frames)
    for t, f in enumerate(frames):
        ref = nat.encode(f, True)
        assert pkts[t] == ref, f"frame {t} mismatch"
    # batch must not disturb the sequential session state
    a = dev.encode(frames[0], force_keyframe=True)
    assert a == nat.encode(frames[0], True)


def test_device_encoder_mega_groups_small_gcap(monkeypatch):
    """Exercise split groups / bucket carry on CPU via a tiny GCAP."""
    import ffmpeg_ffv2_tpu.ffv1.device_coder as dcmod
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    monkeypatch.setattr(dcmod, "GCAP", 64)
    rng = np.random.RandomState(3)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    dev = dcmod.DeviceFFV1Encoder(w, h, "yuv420p", cfg)
    nat = NativeFFV1Codec(p)
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    for t in range(4):
        # gradient + sparse noise -> few large context groups (mega lanes)
        planes = []
        for (hh, ww) in shapes:
            yy, xx = np.mgrid[0:hh, 0:ww]
            pl_ = ((xx // 8 * 8 + t * 5) % 256).astype(np.int32)
            if t != 2:
                mask = rng.rand(hh, ww) < 0.05
                pl_ = np.where(mask, rng.randint(0, 256, (hh, ww)), pl_)
            planes.append(pl_.astype(np.int32))
        key = t % 3 == 0
        a = dev.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"frame {t}"


def test_render_bytes_matches_compact_lane():
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.device_coder import render_bytes
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import compact_lane
    rng = np.random.RandomState(0)
    steps, lanes = 257, 5
    first = np.where(rng.rand(lanes, steps) < 0.3,
                     rng.randint(0, 256, (lanes, steps)), -1)
    fcount = np.where(first >= 0, rng.randint(0, 4, (lanes, steps)), 0)
    fcount[0, 3] = 37          # a long fill run
    fval = np.where(rng.rand(lanes, steps) < 0.5, 0xFF, 0x00)
    b, ln = render_bytes(jnp.asarray(first, jnp.int32),
                         jnp.asarray(fcount, jnp.int32),
                         jnp.asarray(fval, jnp.int32), 1024)
    b, ln = np.asarray(b), np.asarray(ln)
    for l in range(lanes):
        ref = compact_lane(first[l], fcount[l], fval[l])
        assert ln[l] == len(ref)
        assert bytes(b[l, :ln[l]]) == ref, f"lane {l}"


def test_render_bytes_fast_matches_slow():
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.device_coder import (render_bytes,
                                                   render_bytes_fast)
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import compact_lane
    rng = np.random.RandomState(4)
    steps, lanes = 513, 6
    first = np.where(rng.rand(lanes, steps) < 0.25,
                     rng.randint(0, 256, (lanes, steps)), -1)
    fcount = np.where(first >= 0, rng.randint(0, 5, (lanes, steps)), 0)
    first[1, 7] = 0xAB
    fcount[1, 7] = 1023        # max representable fill run
    fval = np.where(rng.rand(lanes, steps) < 0.5, 0xFF, 0x00)
    args = (jnp.asarray(first, jnp.int32), jnp.asarray(fcount, jnp.int32),
            jnp.asarray(fval, jnp.int32), 4096)
    bf, lf, fcm = render_bytes_fast(*args)
    bs, ls = render_bytes(*args)
    assert int(fcm) == 1023
    assert np.array_equal(np.asarray(lf), np.asarray(ls))
    assert np.array_equal(np.asarray(bf), np.asarray(bs))
    for l in range(lanes):
        ref = compact_lane(first[l], fcount[l], fval[l])
        assert bytes(np.asarray(bf)[l, :int(lf[l])]) == ref


def test_shift_compact_expand_randomized():
    """Randomized property test for the log-shift move primitives."""
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.device_coder import shift_compact, shift_expand
    rng = np.random.RandomState(42)
    for trial in range(20):
        m = rng.randint(4, 300)
        valid = rng.rand(m) < rng.rand() * 0.9 + 0.05
        vals = rng.randint(1, 1000, m)
        # compact to ranks
        rank = np.cumsum(valid) - 1
        (out,), om = shift_compact([jnp.asarray(vals, jnp.int32)],
                                   jnp.asarray(valid),
                                   jnp.asarray(np.maximum(rank, 0),
                                               jnp.int32), m)
        out, om = np.asarray(out), np.asarray(om)
        ref = vals[valid]
        assert np.array_equal(out[:len(ref)], ref), f"compact trial {trial}"
        assert om[:len(ref)].all() and not om[len(ref):].any()
        # expand the dense prefix to random increasing destinations
        nv = len(ref)
        out_len = m + rng.randint(0, 64)
        dest = np.sort(rng.choice(out_len, nv, replace=False)).astype(np.int32)
        dest = np.maximum(dest, np.arange(nv, dtype=np.int32))
        dv = np.zeros(m, np.int32)
        dv[:nv] = dest
        vmask = np.zeros(m, bool)
        vmask[:nv] = True
        (eo,), em = shift_expand([jnp.asarray(out[:m], jnp.int32)],
                                 jnp.asarray(vmask), jnp.asarray(dv),
                                 out_len)
        eo, em = np.asarray(eo), np.asarray(em)
        expect = np.zeros(out_len, np.int64)
        expect[dest] = ref
        assert np.array_equal(eo, expect), f"expand trial {trial}"
        assert np.array_equal(em, expect != 0)


@pytest.mark.parametrize("level,coder,slices", [
    (0, 0, 1),          # v0 golomb (the FATE -level 0 config)
    (0, 2, 1),          # v0 range with the custom (ver2) table
    (1, 2, 1),          # v1 range (adds in-band bits field)
    (4, 1, 4),          # v4 range, per-slice headers + coding-mode field
    (4, 0, 4),          # v4 golomb
])
def test_device_encoder_versions_byte_exact(level, coder, slices):
    """Device pipeline == native across bitstream versions 0/1/4:
    in-band v0/v1 keyframe headers (write_header), v4 slice-header
    fields, golomb v0 termination (ffv1enc.c:1203-1262)."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(23 + level + coder)
    w, h = 64, 48
    cfg = FFV1Config(level=level, coder=coder, slices=slices,
                     slicecrc=1 if level >= 3 else 0)
    p = params_from_config(cfg, "yuv420p", w, h)
    dev = DeviceFFV1Encoder(w, h, "yuv420p", cfg)
    nat = NativeFFV1Codec(p)
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    for t in range(3):
        planes = [rng.randint(0, 256, s).astype(np.int32) for s in shapes]
        key = t == 0
        a = dev.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"v{level} coder={coder} frame {t}: " \
            f"{len(a)} vs {len(b)} bytes"


@pytest.mark.parametrize("pix,wh,coder,banked", [
    ("yuv420p", (34, 34), 1, False),   # FATE vsynth3 geometry: chroma
    ("yuv420p", (34, 34), 0, False),   # rects OVERLAP but stay uniform
    ("yuv420p", (35, 33), 1, True),    # odd luma: 17/18 x 16/17 rects
    ("yuv420p", (35, 33), 0, True),    # rice banks
    ("bgr0", (35, 33), 1, True),       # RGB banks (full-res planes)
])
def test_device_encoder_nonuniform_geometry(pix, wh, coder, banked):
    """Non-uniform slice rects (ff_ffv1_init_slice_contexts floor/ceil
    boundaries, ffv1.c:117): the device coder partitions slices into
    uniform-shape banks and assembles the packet in global slice
    order — byte-exact vs native, key + inter."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(41)
    w, h = wh
    cfg = FFV1Config(level=3, coder=coder, slices=4, slicecrc=1)
    p = params_from_config(cfg, pix, w, h)
    dev = DeviceFFV1Encoder(w, h, pix, cfg)
    assert (dev._banks is not None and len(dev._banks) > 1) == banked
    nat = NativeFFV1Codec(p)
    if pix == "bgr0":
        shapes = [(h, w)] * 3
    else:
        shapes = [(h, w), ((h + 1) // 2, (w + 1) // 2),
                  ((h + 1) // 2, (w + 1) // 2)]
    dec = NativeFFV1Codec(p)
    dec2 = NativeFFV1Codec(p)
    for t in range(3):
        planes = [rng.randint(0, 256, s).astype(np.int32) for s in shapes]
        key = t == 0
        a = dev.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"{pix} frame {t}: {len(a)} vs {len(b)} bytes"
        # odd-width chroma: the slice grid's floor/ceil rects may leave
        # the last ceil-rounded column uncoded (host parity behavior),
        # so compare against the native round trip, not the raw input
        for x, y in zip(dec.decode(a), dec2.decode(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_device_encoder_v4_rgb_rct_search():
    """v4 RGB: the per-slice RCT coefficient search runs on device
    (15-candidate L1 over second differences, ffv1enc.c:963-1043) and
    the per-frame slice-header prefixes carry the chosen coefficients —
    byte-exact vs native across frames picking different candidates."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(17)
    w, h = 64, 48
    cfg = FFV1Config(level=4, coder=1, slices=4, slicecrc=1)
    p = params_from_config(cfg, "bgr0", w, h)
    dev = DeviceFFV1Encoder(w, h, "bgr0", cfg)
    assert dev._v4rgb
    nat = NativeFFV1Codec(p)
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(3):
        # channel-correlated content so the candidate search is
        # non-trivial and varies across slices/frames
        g = ((xx * 3 + yy * 2 + 11 * t) % 256).astype(np.int32)
        b = ((g * 2 + rng.randint(0, 6, (h, w))) % 256).astype(np.int32)
        r = ((g + xx + rng.randint(0, 3, (h, w))) % 256).astype(np.int32)
        if t == 2:
            g = rng.randint(0, 256, (h, w)).astype(np.int32)
            b = rng.randint(0, 256, (h, w)).astype(np.int32)
            r = rng.randint(0, 256, (h, w)).astype(np.int32)
        planes = [g, b, r]
        key = t == 0
        a = dev.encode(planes, force_keyframe=key)
        bb = nat.encode(planes, key)
        assert a == bb, f"frame {t}: {len(a)} vs {len(bb)} bytes"


@pytest.mark.parametrize("level", [3, 4])
def test_device_encoder_rgb48(level):
    """RGB 16 bpc (rgb48 / use32bit): int32 sample ring, 17-bit coding
    depth and 17-bit cell payload field — byte-exact vs native across
    key + inter frames (ffv1enc_template.c RGB48 path; level 4 adds the
    on-device per-slice RCT search at this depth)."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    rng = np.random.RandomState(23)
    w, h = 48, 32
    cfg = FFV1Config(level=level, coder=1, slices=4, slicecrc=1)
    p = params_from_config(cfg, "rgb48", w, h)
    assert p.use32bit
    dev = DeviceFFV1Encoder(w, h, "rgb48", cfg)
    assert dev.code_bits == 17
    nat = NativeFFV1Codec(p)
    dec = NativeFFV1Codec(p)
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(3):
        if t < 2:
            # full-range content: b-g / r-g diffs reach +-65535, so the
            # coded stream exercises e = 16 (the 17-bit payload field)
            planes = [rng.randint(0, 1 << 16, (h, w)).astype(np.int32)
                      for _ in range(3)]
        else:
            g = ((xx * 797 + yy * 1031 + 7 * t) % 65536).astype(np.int32)
            planes = [g, (g * 3) % 65536, (g + 12345) % 65536]
            planes = [pl.astype(np.int32) for pl in planes]
        key = t == 0
        a = dev.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"level {level} frame {t}: {len(a)} vs {len(b)}"
        for x, pl in zip(dec.decode(a), planes):
            assert np.array_equal(np.asarray(x), pl)
