"""Device phase A (context modeling) must make the hybrid encoder produce
packets byte-identical to the pure host encoder — and thus to the
reference."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import FFV1Config
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder


def _planes(seed, w, h, bits=8, hs=1, vs=1, nplanes=3):
    rng = np.random.RandomState(seed)
    mx = (1 << bits) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * 3 + yy + seed) % (mx + 1)) // 8 * 8
                + rng.randint(0, 3, (h, w)), 0, mx)
    out = [y.astype(np.int64)]
    cw, ch = -(-w >> hs), -(-h >> vs)
    for _ in range(nplanes - 1):
        out.append(rng.randint(0, mx + 1, (ch, cw)).astype(np.int64))
    return out


CASES = [
    ("v3-golomb", FFV1Config(slices=4), "yuv420p", 8, 1, 1),
    ("v3-range", FFV1Config(slices=4, coder=2), "yuv420p", 8, 1, 1),
    ("v0", FFV1Config(), "yuv420p", 8, 1, 1),
    ("v3-ctx1", FFV1Config(slices=4, context=1, coder=2), "yuv420p", 8, 1, 1),
    ("v3-16bit", FFV1Config(level=3, slices=4), "yuv444p16", 16, 0, 0),
    ("v3-gray", FFV1Config(slices=4), "gray", 8, 0, 0),
]


@pytest.mark.parametrize("name,cfg,fmt,bits,hs,vs", CASES,
                         ids=[c[0] for c in CASES])
def test_tpu_encoder_matches_host(name, cfg, fmt, bits, hs, vs):
    if hs or vs:
        # even frame dims (420 requires them), but odd slice boundaries:
        # 70/2 -> x=35, so chroma slices overlap one column (coded twice)
        w, h = 70, 44
    else:
        w, h = 69, 47   # odd sizes stress slice geometry directly
    nplanes = 1 if fmt == "gray" else 3
    tpu = TPUFFV1Encoder(w, h, fmt, cfg)
    host = NativeFFV1Codec(tpu.p)
    dec = NativeFFV1Codec(tpu.p)
    for t in range(3):
        if bits == 16:
            rng = np.random.RandomState(t)
            planes = [rng.randint(0, 65536, (h, w)).astype(np.int64)
                      for _ in range(3)]
        else:
            planes = _planes(20 + t, w, h, bits, hs, vs, nplanes)
        key = t % tpu.cfg.gop_size == 0
        a = tpu.encode(planes)
        b = host.encode(planes, key)
        assert a == b, f"frame {t}: device hybrid != host"
        outs = dec.decode(a)
        for x, y in zip(planes, outs):
            assert np.array_equal(x, y)


import pytest as _pytest


@_pytest.mark.parametrize("pix,coder", [
    ("bgr0", 1),          # 8-bit RGB, range coder
    ("bgr0", -1),         # 8-bit RGB, golomb-rice (shared run index)
    ("gbrp10", 1),        # 9..14-bit planar: G<->B swap quirk
])
def test_hybrid_rgb_phase_a_byte_exact(pix, coder):
    """RGB/RCT phase A on device (hybrid encoder) == host packets
    (ffv1enc_template.c:encode_rgb_frame semantics: fixed 1,1 RCT,
    row-interleaved planes, bits+1 coding depth)."""
    import numpy as np
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder
    rng = np.random.RandomState(2)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=coder, slices=4)
    p = params_from_config(cfg, pix, w, h)
    assert p.colorspace == 1
    hyb = TPUFFV1Encoder(w, h, pix, cfg)
    nat = NativeFFV1Codec(p)
    mx = (1 << p.bits) - 1
    for t in range(3):
        planes = [rng.randint(0, mx + 1, (h, w)).astype(np.int32)
                  for _ in range(3)]          # g, b, r
        key = t % 2 == 0
        a = hyb.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"frame {t}"
