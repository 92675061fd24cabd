"""Two-pass rate statistics: self-consistency + bit-exact parity with the
reference's -pass 1/-pass 2 flow."""

import os
import subprocess

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1 import twopass, headers as H
from ffmpeg_ffv2_tpu.container.avi import AviReader
from ffmpeg_ffv2_tpu.testsrc import vsynth1_frames

from util import REF_FFMPEG, have_ref_ffmpeg

N_FRAMES = 6
W, H_ = 352, 288


def _frames():
    return [[pl.astype(np.int32) for pl in f]
            for f in vsynth1_frames(N_FRAMES)]


def test_twopass_self():
    frames = _frames()
    cfg = FFV1Config(slices=4, coder=2, level=3)
    p1 = params_from_config(cfg, "yuv420p", W, H_)
    enc = NativeFFV1Codec(p1)
    enc.enable_stats()
    size1 = sum(len(enc.encode(f, t % 12 == 0))
                for t, f in enumerate(frames))
    rc, rc2, gob = twopass.collect_stats(enc)
    txt = twopass.stats_to_text(p1, rc, rc2, gob)

    p2 = params_from_config(cfg, "yuv420p", W, H_)
    p2 = twopass.apply_pass2(p2, txt)
    assert p2.initial_states is not None
    enc2 = NativeFFV1Codec(p2)
    size2 = 0
    pkts = []
    for t, f in enumerate(frames):
        pkt = enc2.encode(f, t % 12 == 0)
        size2 += len(pkt)
        pkts.append(pkt)
    # optimized states should not hurt (and usually help)
    assert size2 <= size1 * 1.01, (size1, size2)

    # decoder reads initial states from extradata
    extradata = H.write_extradata(p2)
    dec = NativeFFV1Codec(H.read_extradata(extradata, W, H_))
    for t, f in enumerate(frames):
        outs = dec.decode(pkts[t])
        for a, b in zip(f, outs):
            assert np.array_equal(a, b)


@pytest.mark.skipif(not have_ref_ffmpeg(), reason="reference ffmpeg absent")
def test_twopass_reference_parity(tmp_path):
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for fr in vsynth1_frames(N_FRAMES):
            for pl in fr:
                f.write(pl.astype(np.uint8).tobytes())
    log = tmp_path / "plog"
    common = [REF_FFMPEG, "-y", "-loglevel", "error",
              "-f", "rawvideo", "-pix_fmt", "yuv420p", "-s", f"{W}x{H_}",
              "-i", str(src), "-c:v", "ffv1", "-level", "3", "-slices", "4",
              "-coder", "range_tab", "-passlogfile", str(log),
              "-flags", "+bitexact", "-fflags", "+bitexact", "-threads", "1"]
    subprocess.run(common + ["-pass", "1", "-f", "avi",
                             str(tmp_path / "p1.avi")], check=True)
    subprocess.run(common + ["-pass", "2", "-f", "avi",
                             str(tmp_path / "p2.avi")], check=True)

    frames = _frames()
    cfg = FFV1Config(slices=4, coder=2, level=3)

    # our pass-1 stats must match the reference log token-for-token
    p1 = params_from_config(cfg, "yuv420p", W, H_)
    enc = NativeFFV1Codec(p1)
    enc.enable_stats()
    for t, f in enumerate(frames):
        enc.encode(f, t % 12 == 0)
    rc, rc2, gob = twopass.collect_stats(enc)
    ours = twopass.stats_to_text(p1, rc, rc2, gob).split()
    ref = (log.parent / (log.name + "-0.log")).read_text().split()
    assert ours == ref

    # our pass-2 output must match the reference's byte-for-byte
    p2 = params_from_config(cfg, "yuv420p", W, H_)
    p2 = twopass.apply_pass2(p2, " ".join(ref))
    avi = AviReader((tmp_path / "p2.avi").read_bytes())
    assert H.write_extradata(p2) == avi.video.extradata
    enc2 = NativeFFV1Codec(p2)
    for t, (f, refpkt) in enumerate(zip(frames, avi.video.packets)):
        assert enc2.encode(f, t % 12 == 0) == refpkt, f"packet {t}"


def test_twopass_pass2_device_byte_exact():
    """Pass-2 params (custom initial states + sorted transition table)
    through the DEVICE pipeline: byte-identical to the native encoder
    (ffv1enc.c:793-873 applied at the keyframe canonical)."""
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    frames = _frames()[:3]
    cfg = FFV1Config(slices=4, coder=2, level=3, slicecrc=1)
    p1 = params_from_config(cfg, "yuv420p", W, H_)
    enc = NativeFFV1Codec(p1)
    enc.enable_stats()
    for t, f in enumerate(frames):
        enc.encode(f, t == 0)
    rc, rc2, gob = twopass.collect_stats(enc)
    txt = twopass.stats_to_text(p1, rc, rc2, gob)

    p2 = twopass.apply_pass2(
        params_from_config(cfg, "yuv420p", W, H_), txt)
    p2n = twopass.apply_pass2(
        params_from_config(cfg, "yuv420p", W, H_), txt)
    dev = DeviceFFV1Encoder(W, H_, "yuv420p", cfg,
                            params=p2)
    nat = NativeFFV1Codec(p2n)
    for t, f in enumerate(frames):
        a = dev.encode(f, t == 0)        # covers key + inter frames
        b = nat.encode(f, t == 0)
        assert a == b, f"frame {t}: {len(a)} vs {len(b)} bytes"
    # lossless through the extradata-driven decoder
    dec = NativeFFV1Codec(H.read_extradata(dev.extradata, W, H_))
    for t, f in enumerate(frames):
        for x, y in zip(dec.decode(nat.encode(f, t == 0)), f):
            assert np.array_equal(x, y)
