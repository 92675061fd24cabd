"""Native (C++) FFV2 sessions are byte/pixel-identical to the Python codec.

The Python codec is itself validated symbol-exact against the reference
Daala EC (test_ffv2.py); these tests pin the native fast path to it.
"""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.core.pixfmt import get_pix_fmt
from ffmpeg_ffv2_tpu.ffv2 import FFV2Encoder, FFV2Decoder, FFV2Config
from ffmpeg_ffv2_tpu.ffv2.native import NativeFFV2Encoder, NativeFFV2Decoder


def _planes(fmt, w, h, seed):
    f = get_pix_fmt(fmt)
    mx = (1 << f.bits) - 1
    rng = np.random.RandomState(seed)
    base = rng.randint(0, mx + 1, (h, w)).astype(np.int64)
    return [np.clip(base + rng.randint(-40, 40, (h, w)), 0, mx)
            for _ in range(f.nb_planes)]


CASES = [
    ("gray", 70, 44, 8, 0),
    ("yuv444p", 96, 96, 12, 1),
    ("yuv444p", 130, 66, 31, 2),     # non-multiple-of-64 dims
    ("yuv444p10", 64, 64, 16, 3),
    ("yuv444p12", 64, 64, 20, 4),
    ("gbrp", 128, 96, 24, 5),
    ("gbrp10", 64, 64, 10, 6),
    ("gbrp12", 100, 80, 32, 7),
]


@pytest.mark.parametrize("fmt,w,h,qp,seed", CASES)
def test_native_matches_python(fmt, w, h, qp, seed):
    planes = _planes(fmt, w, h, seed)
    cfg = FFV2Config(qp=qp)
    pkt_py = FFV2Encoder(w, h, fmt, cfg).encode(planes)
    pkt_na = NativeFFV2Encoder(w, h, fmt, cfg).encode(planes)
    assert pkt_na == pkt_py

    out_py = FFV2Decoder(w, h).decode(pkt_py)
    out_na = NativeFFV2Decoder(w, h).decode(pkt_py)
    assert len(out_na) == len(out_py)
    for p, q in zip(out_py, out_na):
        assert np.array_equal(p, q)


@pytest.mark.parametrize("bs", [32, 16, 8, 4, 0])
def test_split_tree_native_matches_python(bs):
    """block_size < 64 exercises the XY quad-tree (the reference encoder
    stubs splits; its decoder — and ours — support them); 0 = the
    activity-adaptive mode (mixed leaf sizes)."""
    w, h = 128, 96
    planes = _planes("yuv444p", w, h, 20 + bs)
    if bs == 0:
        # mixed content so the adaptive tree actually mixes leaf sizes
        planes[0][:64, :64] = np.linspace(
            0, 255, 64 * 64).reshape(64, 64).astype(np.int64)
    cfg = FFV2Config(qp=12, block_size=bs)
    pkt_py = FFV2Encoder(w, h, "yuv444p", cfg).encode(planes)
    pkt_na = NativeFFV2Encoder(w, h, "yuv444p", cfg).encode(planes)
    assert pkt_na == pkt_py
    out_py = FFV2Decoder(w, h).decode(pkt_py)
    out_na = NativeFFV2Decoder(w, h).decode(pkt_py)
    for p, q in zip(out_py, out_na):
        assert np.array_equal(p, q)


def test_native_session_reuse():
    """One encoder/decoder object across several frames stays exact."""
    w = h = 96
    cfg = FFV2Config(qp=14)
    enc = NativeFFV2Encoder(w, h, "yuv444p", cfg)
    dec = NativeFFV2Decoder(w, h)
    for seed in range(3):
        planes = _planes("yuv444p", w, h, 10 + seed)
        pkt = FFV2Encoder(w, h, "yuv444p", cfg).encode(planes)
        assert enc.encode(planes) == pkt
        ref = FFV2Decoder(w, h).decode(pkt)
        for p, q in zip(ref, dec.decode(pkt)):
            assert np.array_equal(p, q)


def test_native_decoder_bad_pixfmt():
    with pytest.raises(ValueError):
        NativeFFV2Decoder(32, 32).decode(b"\xff" * 64)


def test_pipelined_matches_sequential():
    """Frame-pipelined EC: byte-identical packets.
    The EC is a pure function of the staged (dc, cg, pulses), so
    overlapping frame t's C++ coder with frame t+1's front must not
    change a single byte."""
    from ffmpeg_ffv2_tpu.ffv2.native import PipelinedFFV2Encoder
    w, h = 128, 96
    cfg = FFV2Config(qp=14)
    frames = [_planes("yuv444p", w, h, 10 + t) for t in range(4)]
    seq = NativeFFV2Encoder(w, h, "yuv444p", cfg)
    pipe = PipelinedFFV2Encoder(w, h, "yuv444p", cfg, depth=3)
    try:
        pkts_pipe = pipe.encode_stream(frames)
        pkts_seq = [seq.encode(f) for f in frames]
        assert len(pkts_pipe) == len(pkts_seq)
        for t, (a, b) in enumerate(zip(pkts_pipe, pkts_seq)):
            assert a == b, f"pipelined packet differs at frame {t}"
    finally:
        pipe.close()
