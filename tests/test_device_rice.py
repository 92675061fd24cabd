"""Device golomb-rice planning vs the scalar oracle (codec_py/golomb)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from ffmpeg_ffv2_tpu.coder.bitio import BitWriter
from ffmpeg_ffv2_tpu.coder.golomb import (VlcState, LOG2_RUN,
                                          put_vlc_symbol)
from ffmpeg_ffv2_tpu.ffv1.device_rice import (
    plan_runs_plane, ladder_step, run_index_scan, vlc_code_word,
    vlc_update, assemble_bits, VLC_INIT)


def oracle_line_trace(ctx_line, diff_line, run_index):
    """Re-enact the encode_line run machinery (codec_py.py:132-170)
    recording per-pixel classification; returns (events, run_index')
    where events = list of (kind, x, payload)."""
    w = len(ctx_line)
    run_count = 0
    run_mode = 0
    out = []
    for x in range(w):
        context = ctx_line[x]
        diff = diff_line[x]
        if context == 0:
            run_mode = 1
        if run_mode:
            if diff:
                ones = 0
                while run_count >= 1 << LOG2_RUN[run_index]:
                    run_count -= 1 << LOG2_RUN[run_index]
                    run_index += 1
                    ones += 1
                out.append(("event", x, (ones, run_index, run_count)))
                if run_index:
                    run_index -= 1
                run_count = 0
                run_mode = 0
                if diff > 0:
                    diff -= 1
                out.append(("vlc", x, diff))
            else:
                run_count += 1
                out.append(("silent", x, None))
        else:
            out.append(("vlc", x, diff))
    if run_mode:
        ones = 0
        while run_count >= 1 << LOG2_RUN[run_index]:
            run_count -= 1 << LOG2_RUN[run_index]
            run_index += 1
            ones += 1
        out.append(("flush", w - 1, (ones, run_count)))
    return out, run_index


def synth_plane(rng, S, h, w, zero_frac=0.6, ctx0_frac=0.3):
    diff = rng.integers(-20, 20, size=(S, h, w)).astype(np.int32)
    diff[rng.random((S, h, w)) < zero_frac] = 0
    ctx = rng.integers(0, 5, size=(S, h, w)).astype(np.int32)
    ctx[rng.random((S, h, w)) > ctx0_frac] += 1
    return ctx, diff


def test_plan_runs_matches_oracle():
    rng = np.random.default_rng(7)
    S, h, w = 3, 6, 37
    ctx, diff = synth_plane(rng, S, h, w)
    plan = jax.tree.map(np.asarray,
                        plan_runs_plane(jnp.asarray(ctx), jnp.asarray(diff)))
    for s in range(S):
        ri = 0
        for y in range(h):
            ev, ri = oracle_line_trace(ctx[s, y], diff[s, y], ri)
            silent = set()
            events = {}
            flush = None
            for kind, x, payload in ev:
                if kind == "silent":
                    silent.add(x)
                elif kind == "event":
                    events[x] = payload
                elif kind == "flush":
                    flush = payload
            assert set(np.nonzero(plan["silent"][s, y])[0]) == silent
            got_ev = set(np.nonzero(plan["event"][s, y])[0])
            assert got_ev == set(events)
            for x, (ones, idx_after, rem) in events.items():
                # total count before climb = planned run_count
                consumed = sum(1 << LOG2_RUN[i]
                               for i in range(idx_after - ones, idx_after))
                assert plan["run_count"][s, y, x] == rem + consumed
            if flush is not None:
                assert plan["flush"][s, y, w - 1]
                ones, rem = flush
                consumed = plan["flush_count"][s, y, w - 1] - rem
                assert consumed == sum(
                    1 << LOG2_RUN[i] for i in range(ri - ones, ri))
            else:
                assert not plan["flush"][s, y, w - 1]


def test_ladder_step_matches_loop():
    for i0 in range(0, 41, 5):
        for c in [0, 1, 2, 3, 7, 15, 100, 4000]:
            j, ones, rem = jax.tree.map(
                int, ladder_step(jnp.int32(i0), jnp.int32(c)))
            ii, cc, n = i0, c, 0
            while cc >= 1 << LOG2_RUN[ii] and ii < 40:
                cc -= 1 << LOG2_RUN[ii]
                ii += 1
                n += 1
            assert (j, ones, rem) == (ii, n, cc), (i0, c)


def test_run_index_scan_matches_sequence():
    rng = np.random.default_rng(3)
    L, E = 4, 50
    cnt = rng.integers(0, 200, size=(L, E)).astype(np.int32)
    fl = rng.random((L, E)) < 0.2
    va = np.ones((L, E), bool)
    va[:, 40:] = False
    got = np.asarray(run_index_scan(
        jnp.asarray(cnt), jnp.asarray(fl), jnp.asarray(va)))
    for l in range(L):
        ri = 0
        for e in range(E):
            if not va[l, e]:
                continue
            assert got[l, e] == ri
            c = int(cnt[l, e])
            while c >= 1 << LOG2_RUN[ri] and ri < 40:
                c -= 1 << LOG2_RUN[ri]
                ri += 1
            if not fl[l, e] and ri:
                ri -= 1


def test_vlc_code_and_update_match_oracle():
    rng = np.random.default_rng(11)
    bits = 8
    st = VlcState()
    drift, es, bias, count = (jnp.int32(0), jnp.int32(4), jnp.int32(0),
                              jnp.int32(1))
    for _ in range(500):
        v0 = int(rng.integers(-128, 128))
        pb = BitWriter()
        put_vlc_symbol(pb, st, v0, bits)
        ref_bits = pb.bit_count()
        ref_bytes = pb.flush()
        length, val, v = vlc_code_word(
            jnp.int32(v0), drift, es, bias, count, bits)
        drift, es, bias, count = vlc_update(drift, es, bias, count, v)
        assert int(length) == ref_bits
        got = BitWriter()
        got.put(int(length), int(val))
        assert got.flush() == ref_bytes
        assert (int(drift), int(es), int(bias), int(count)) == \
            (st.drift, st.error_sum, st.bias, st.count)


def test_assemble_bits_matches_bitwriter():
    rng = np.random.default_rng(5)
    S, E = 2, 64
    lens = rng.integers(0, 25, size=(S, E)).astype(np.int32)
    vals = rng.integers(0, 1 << 24, size=(S, E)).astype(np.int32)
    nwords = int(np.ceil(lens.sum(axis=1).max() / 32)) + 1
    by, nbits = assemble_bits(jnp.asarray(lens), jnp.asarray(vals), nwords)
    by = np.asarray(by)
    for s in range(S):
        pb = BitWriter()
        for l, v in zip(lens[s], vals[s]):
            pb.put(int(l), int(v))
        ref = pb.flush()
        assert int(nbits[s]) == int(lens[s].sum())
        assert bytes(by[s, :len(ref)]) == ref


@pytest.mark.parametrize("pix,wh", [
    ("yuv420p", (64, 48)),
    ("gray", (48, 32)),
    ("bgr0", (48, 32)),     # FATE's default-coder RGB config
                            # (vcodec.mak:179, coder default ffv1enc.c:563):
                            # RCT at bits+1, line-interleaved planes, one
                            # shared run-index ladder
])
def test_device_rice_encoder_byte_exact(pix, wh):
    """Full device golomb-rice pipeline == native packets."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    rng = np.random.default_rng(13)
    w, h = wh
    cfg = FFV1Config(level=3, coder=0, slices=4)
    p = params_from_config(cfg, pix, w, h)
    dev = DeviceFFV1Encoder(w, h, pix, cfg)
    nat = NativeFFV1Codec(p)
    mx = (1 << p.bits) - 1
    shapes = [(h, w)]
    if p.chroma_planes:
        shapes += [(h >> p.chroma_v_shift, w >> p.chroma_h_shift)] * 2
    for t in range(4):
        if t == 1:
            planes = [np.full(s, 42, np.int64) for s in shapes]
        elif t == 2:
            # long zero runs: constant rows with sparse impulses
            planes = []
            for s in shapes:
                pl = np.full(s, 17, np.int64)
                pl[:: max(1, s[0] // 3)] = 99
                planes.append(pl)
        else:
            planes = [rng.integers(0, mx + 1, s).astype(np.int64)
                      for s in shapes]
        a = dev.encode(planes, force_keyframe=(t == 0))
        b = nat.encode([pl.astype(np.int64) for pl in planes],
                       keyframe=(t == 0))
        assert a == b, f"frame {t}: {len(a)} vs {len(b)} bytes"


@pytest.mark.parametrize("pix,wh", [("yuv420p", (48, 32)),
                                    ("bgr0", (40, 24))])
def test_vlc_pallas_interpret_matches_reference(pix, wh):
    """Triton vlc walk (interpret) == XLA reference walk on a real plan."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.device_rice import (
        build_vlc_s0, vlc_adapt_reference, vlc_adapt_pallas)
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    rng = np.random.default_rng(23)
    w, h = wh
    cfg = FFV1Config(level=3, coder=0, slices=4)
    dev = DeviceFFV1Encoder(w, h, pix, cfg)
    p = dev.p
    shapes = [(h, w)] * 3 if p.colorspace == 1 else \
        [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    planes = [rng.integers(0, 256, s).astype(np.int64) for s in shapes]
    dev.encode(planes, force_keyframe=True)         # settle the caps
    dv = [jnp.asarray(np.asarray(pl), jnp.int32) for pl in planes]
    ctx, streams = dev._phase_a_rice(dv)
    plan = dev._s_rice_layout(ctx, streams["payload"], dev.tiles_cap,
                              dev.cellrows_cap)
    ch1c, ch2c = dev._s_scatter(plan, dev.cellrows_cap)
    s0 = build_vlc_s0(plan, dev.vcanon.astype(jnp.int32), dev.tiles_cap)
    ref_code, ref_ends = vlc_adapt_reference(
        ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
        s0, dev.tiles_cap, dev.code_bits)
    got_code, got_ends = vlc_adapt_pallas(
        ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
        s0, dev.tiles_cap, int(ch1c.shape[0]), dev.code_bits,
        interpret=True)
    nrows = int(np.asarray(plan["n_rows"]))
    a = np.asarray(got_code)[:nrows]
    b = np.asarray(ref_code)[:nrows]
    ne = np.nonzero(a != b)
    assert ne[0].size == 0, f"{ne[0].size} code mismatches at {ne[0][:5]}"
    assert np.array_equal(np.asarray(got_ends), np.asarray(ref_ends))
