"""Lane-parallel device range coder must produce byte-identical packets."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.tpu_coder import TPUCoderFFV1Encoder


def _mk(seed, w, h):
    r = np.random.RandomState(seed)
    y = np.clip(((np.indices((h, w)).sum(0) * 3 + seed) % 256) // 8 * 8
                + r.randint(0, 3, (h, w)), 0, 255)
    return [y.astype(np.int64),
            r.randint(0, 256, (h // 2, w // 2)).astype(np.int64),
            r.randint(0, 256, (h // 2, w // 2)).astype(np.int64)]


CASES = [
    ("v3-range-custom", FFV1Config(slices=4, coder=2), "yuv420p"),
    ("v3-range-default", FFV1Config(slices=4, coder=-2), "yuv420p"),
    ("v1-range", FFV1Config(level=1, coder=2), "yuv420p"),
    ("v0-range", FFV1Config(level=0, coder=2), "yuv420p"),
    ("v3-16bit", FFV1Config(level=3, slices=4), "yuv444p16"),
    ("v3-ctx1", FFV1Config(slices=4, context=1, coder=2), "yuv420p"),
    # Golomb-Rice: headers via the lane coder, body via the device
    # bit packer (bit_pack_lanes)
    ("v0-rice", FFV1Config(level=0, coder=0), "yuv420p"),
    ("v1-rice", FFV1Config(level=1, coder=0), "yuv420p"),
    ("v3-rice", FFV1Config(level=3, slices=4, coder=0), "yuv420p"),
    ("v3-rice-gray", FFV1Config(level=3, slices=4, coder=0), "gray"),
    # RGB (RCT) planning, incl. the v4 per-slice coefficient search
    ("v3-bgr0", FFV1Config(level=3, slices=4, coder=1), "bgr0"),
    ("v4-bgr0-rct", FFV1Config(level=4, slices=4, coder=1), "bgr0"),
    ("v3-gbrp12", FFV1Config(level=3, slices=4, coder=1), "gbrp12"),
    ("v3-gbrp16", FFV1Config(level=3, slices=4, coder=1), "gbrp16"),
    ("v1-bgr0-rice", FFV1Config(level=1, coder=0), "bgr0"),
    ("v3-gbrp10-rice", FFV1Config(level=3, slices=4, coder=0), "gbrp10"),
]


@pytest.mark.parametrize("name,cfg,fmt", CASES, ids=[c[0] for c in CASES])
def test_device_coder_matches_host(name, cfg, fmt):
    w, h = 96, 64
    dev = TPUCoderFFV1Encoder(w, h, fmt, cfg)
    host = NativeFFV1Codec(dev.p)
    dec = NativeFFV1Codec(dev.p)
    for t in range(3):
        from ffmpeg_ffv2_tpu.core.pixfmt import get_pix_fmt
        pf = get_pix_fmt(fmt)
        if fmt == "yuv444p16":
            r = np.random.RandomState(t)
            f = [r.randint(0, 65536, (h, w)).astype(np.int64)
                 for _ in range(3)]
        elif pf.colorspace == 1:
            r = np.random.RandomState(200 + t)
            mx = (1 << pf.bits) - 1
            base = r.randint(0, mx + 1, (h, w)).astype(np.int64)
            f = [np.clip(base + r.randint(-60, 60, (h, w)), 0, mx)
                 for _ in range(3)]
        else:
            f = _mk(100 + t, w, h)
        key = t % 12 == 0
        a = dev.encode(f, key)
        assert a == host.encode(f, key), f"frame {t}"
        outs = dec.decode(a)
        for x, y in zip(f, outs):
            assert np.array_equal(x, y)


def test_bit_packer_matches_bitwriter():
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import (bit_pack_lanes,
                                                pack_lane_bytes)
    from ffmpeg_ffv2_tpu.coder.bitio import BitWriter
    rng = np.random.RandomState(7)
    steps, lanes = 300, 4
    nb = rng.randint(0, 32, (steps, lanes))
    val = np.zeros((steps, lanes), dtype=np.uint32)
    for i in range(steps):
        for l in range(lanes):
            if nb[i, l]:
                val[i, l] = rng.randint(0, 1 << int(nb[i, l]))
    words, total = bit_pack_lanes(val, nb.astype(np.int32))
    words = np.asarray(words)
    total = np.asarray(total)
    for l in range(lanes):
        bw = BitWriter()
        for i in range(steps):
            if nb[i, l]:
                bw.put(int(nb[i, l]), int(val[i, l]))
        assert pack_lane_bytes(words[:, l], int(total[l])) == bw.flush()


def _op_words(rng, steps, lanes, mix):
    """Packed op words [mode:2 | bit:1 | sv:8] for one of three mixes:
    plain ops, ops with NOP gaps, and streams ending in both flush
    modes at different lengths."""
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import (MODE_NOP, MODE_OP,
                                                MODE_FLUSH1, MODE_FLUSH2)
    sv = rng.randint(1, 256, (steps, lanes))
    bit = rng.randint(0, 2, (steps, lanes))
    mode = np.full((steps, lanes), MODE_OP)
    if mix == "nops":
        mode[rng.rand(steps, lanes) < 0.3] = MODE_NOP
    if mix in ("nops", "flush"):
        for lane in range(lanes):
            end = steps - 2 - (lane * 7) % (steps // 2)
            mode[end:, lane] = MODE_NOP
            mode[end, lane] = MODE_FLUSH1
            mode[end + 1, lane] = MODE_FLUSH2
    return (sv | (bit << 8) | (mode << 9)).astype(np.int32)


@pytest.mark.parametrize("lanes", [1, 5, 32, 40])
@pytest.mark.parametrize("mix", ["ops", "nops", "flush"])
def test_coder_kernel_interpret_matches_scan(lanes, mix):
    """The Triton coder kernel (interpret mode) reproduces the plain
    lax.scan coder exactly, over lane counts that fill one, part of one
    and more than one lane block."""
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import rac_scan_lanes
    from ffmpeg_ffv2_tpu.ffv1.pallas_coder import (LANE_BLOCK,
                                                   rac_pallas_packed)
    rng = np.random.RandomState(lanes * 31 + len(mix))
    steps = 90
    opw = _op_words(rng, steps, lanes, mix)
    ref = [np.asarray(a) for a in rac_scan_lanes(
        jnp.asarray(opw & 0xFF), jnp.asarray((opw >> 8) & 1),
        jnp.asarray((opw >> 9) & 3))]
    padded = -(-lanes // LANE_BLOCK) * LANE_BLOCK
    got = [np.asarray(a) for a in rac_pallas_packed(
        jnp.asarray(np.pad(opw, ((0, 0), (0, padded - lanes)))),
        interpret=True)]
    for r, g in zip(ref, got):
        assert np.array_equal(r, g[:, :lanes])


def test_device_coder_v4_pcm_fallback():
    """v4 PCM retry through the planner path (ffv1enc.c:1107-1117):
    adversarial content overflows the slice budget; the replanned raw-PCM
    ops must reproduce the host encoder's packet byte-exactly."""
    import numpy as np
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import TPUCoderFFV1Encoder
    w, h = 64, 32
    cfg = FFV1Config(level=4, coder=1, slices=4)
    p = params_from_config(cfg, "yuv444p16", w, h)
    assert p.version == 4
    rng = np.random.RandomState(0)
    planes = [rng.randint(0, 65536, (h, w)).astype(np.int32)
              for _ in range(3)]
    dev = TPUCoderFFV1Encoder(w, h, "yuv444p16", cfg)
    nat = NativeFFV1Codec(p)
    from ffmpeg_ffv2_tpu.ffv1.native import get_lib
    import ctypes
    # the adaptive coder beats the generous v4 budget on any real
    # content, so force the retry with the shared budget hook
    dev.set_budget_override(4800)
    get_lib().ffv1rt_set_budget_override(nat.handle, ctypes.c_int64(4800))
    a = dev.encode(planes, force_keyframe=True)
    b = nat.encode(planes, True)
    assert a == b
    # PCM really triggered: the packet is ~raw-sized
    assert len(a) > w * h * 3 * 2 * 0.9
    # and a compressible frame still rides the entropy path afterwards
    flat = [np.full((h, w), 99, np.int32) for _ in range(3)]
    fa = dev.encode(flat, force_keyframe=True)
    assert fa == nat.encode(flat, True)
    assert len(fa) < 4800


def test_device_coder_pass1_stats():
    """Pass-1 rc_stat collection through the planner == host-path stats."""
    import numpy as np
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec, get_lib
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import TPUCoderFFV1Encoder
    from ffmpeg_ffv2_tpu.ffv1.twopass import collect_stats
    rng = np.random.RandomState(4)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    frames = []
    for t in range(3):
        frames.append([rng.randint(0, 256, (h, w)).astype(np.int32),
                       rng.randint(0, 256, (h//2, w//2)).astype(np.int32),
                       rng.randint(0, 256, (h//2, w//2)).astype(np.int32)])

    dev = TPUCoderFFV1Encoder(w, h, "yuv420p", cfg)
    dev.set_stats_mode(True)
    host = NativeFFV1Codec(p)
    get_lib().ffv1rt_set_stats_mode(host.handle, 1)
    for t, f in enumerate(frames):
        a = dev.encode(f, force_keyframe=(t == 0))
        b = host.encode(f, t == 0)
        assert a == b, f"frame {t}"
    s1, s2, g1 = collect_stats(dev.native)
    r1, r2, g2 = collect_stats(host)
    assert g1 == g2
    assert np.array_equal(s1, r1)
    assert np.array_equal(s2, r2)


def test_device_coder_rgb():
    """RGB through the planner + lane coder (range + golomb headers)."""
    import numpy as np
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import TPUCoderFFV1Encoder
    rng = np.random.RandomState(6)
    w, h = 48, 32
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "bgr0", w, h)
    dev = TPUCoderFFV1Encoder(w, h, "bgr0", cfg)
    nat = NativeFFV1Codec(p)
    for t in range(2):
        planes = [rng.randint(0, 256, (h, w)).astype(np.int32)
                  for _ in range(3)]
        a = dev.encode(planes, force_keyframe=(t == 0))
        b = nat.encode(planes, t == 0)
        assert a == b, f"frame {t}"
