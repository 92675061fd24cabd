"""Jitted conversions (convert/tpu.py) are bit-identical to the numpy
models (which are themselves pinned against the reference swscale binary
in test_convert_parity.py)."""

import numpy as np

from ffmpeg_ffv2_tpu.convert import yuv_rgb as host
from ffmpeg_ffv2_tpu.convert import tpu as dev

H, W = 96, 128


def _yuv(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (H, W)).astype(np.uint8),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8))


def test_yuv420p_to_bgr0():
    y, u, v = _yuv(0)
    assert np.array_equal(host.yuv420p_to_bgr0(y, u, v),
                          np.asarray(dev.yuv420p_to_bgr0(y, u, v)))


def test_yuv420p_to_rgb48():
    y, u, v = _yuv(1)
    assert np.array_equal(host.yuv420p_to_rgb48(y, u, v).astype(np.uint16),
                          np.asarray(dev.yuv420p_to_rgb48(y, u, v)))


def test_bgr0_to_yuv420p():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    for a, b in zip(host.bgr0_to_yuv420p(img), dev.bgr0_to_yuv420p(img)):
        assert np.array_equal(a, np.asarray(b))


def test_rgb48_to_yuv420p():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 65536, (H, W, 3)).astype(np.int64)
    for a, b in zip(host.rgb48_to_yuv420p(img),
                    dev.rgb48_to_yuv420p(img.astype(np.uint16))):
        assert np.array_equal(a, np.asarray(b))


def test_gbrp16_to_yuv420p():
    rng = np.random.RandomState(4)
    g, b, r = (rng.randint(0, 65536, (H, W)).astype(np.int64)
               for _ in range(3))
    for a, o in zip(host.gbrp16_to_yuv420p(g, b, r),
                    dev.gbrp16_to_yuv420p(g.astype(np.uint16),
                                          b.astype(np.uint16),
                                          r.astype(np.uint16))):
        assert np.array_equal(a, np.asarray(o))


def test_fused_bgr0_phase_a_matches_staged():
    """The fused convert+model program == staged host conversion + the
    device phase A on each plane."""
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.tpu import (lut_for, plane_context_diff,
                                          _wrap16)

    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    p = params_from_config(FFV1Config(level=3), "yuv420p", W, H)
    qt = lut_for(p, 0)

    fused = dev.fused_bgr0_phase_a(img, qt, 8, False)
    staged_planes = host.bgr0_to_yuv420p(img)
    for (fc, fd), pl in zip(fused, staged_planes):
        sc, sd = plane_context_diff(_wrap16(jnp.asarray(pl, jnp.int32)),
                                    qt, 8, False)
        assert np.array_equal(np.asarray(fc), np.asarray(sc))
        assert np.array_equal(np.asarray(fd), np.asarray(sd))
