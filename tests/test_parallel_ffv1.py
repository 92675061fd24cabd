"""Public multi-chip FFV1 API: ParallelFFV1Encoder packets must be
byte-identical to the single-device/host encoder per data lane, with
the adaptive context state carried across frames (inter)."""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu.ffv1.encoder import FFV1Encoder
from ffmpeg_ffv2_tpu.ffv1.decoder import FFV1Decoder
from ffmpeg_ffv2_tpu.parallel.ffv1 import ParallelFFV1Encoder


def _mesh(data, ns):
    devs = jax.devices()
    if len(devs) < data * ns:
        pytest.skip(f"need {data * ns} devices")
    return Mesh(np.array(devs[:data * ns]).reshape(data, ns),
                ("data", "slice"))


def _frames(w, h, n, seed, rgb=False):
    rng = np.random.RandomState(seed)

    def plane(ph, pw, k, t):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = ((xx * (2 + k) + yy * (3 + k) + 5 * t) % 256) // 8 * 8
        return (base + rng.randint(0, 4, (ph, pw))).astype(np.int32) & 0xFF

    if rgb:
        return [[plane(h, w, k, t) for k in range(3)] for t in range(n)]
    return [[plane(h, w, 0, t), plane(h // 2, w // 2, 1, t),
             plane(h // 2, w // 2, 2, t)] for t in range(n)]


@pytest.mark.parametrize("coder", [1, 0])
def test_parallel_matches_host_and_carries_state(coder):
    w, h = 64, 32
    mesh = _mesh(2, 4)
    cfg = FFV1Config(level=3, coder=coder, slices=16, slicecrc=1,
                     gop_size=2)
    par = ParallelFFV1Encoder(w, h, "yuv420p", cfg, mesh)
    # two independent per-lane streams, 2 frames each (key + inter)
    lanes = [_frames(w, h, 2, seed) for seed in (7, 11)]
    refs = []
    for fr in lanes:
        e = FFV1Encoder(w, h, "yuv420p", cfg)
        refs.append([e.encode(fr[0], True), e.encode(fr[1], False)])
    for t, kf in ((0, True), (1, False)):
        pkts = par.encode_batch([lanes[0][t], lanes[1][t]],
                                force_keyframe=kf)
        for b in range(2):
            assert pkts[b] == refs[b][t], (
                f"coder={coder} lane {b} frame {t}: sharded packet != "
                f"host ({len(pkts[b])} vs {len(refs[b][t])})")
    # decode check on lane 0
    dec = FFV1Decoder(w, h, par.extradata)
    for t in range(2):
        out = dec.decode(refs[0][t])
        for a, b in zip(out, lanes[0][t]):
            assert np.array_equal(np.asarray(a), b)


def test_parallel_rgb_range():
    w, h = 64, 32
    mesh = _mesh(1, 8)
    cfg = FFV1Config(level=3, coder=1, slices=16, slicecrc=1)
    par = ParallelFFV1Encoder(w, h, "bgr0", cfg, mesh)
    fr = _frames(w, h, 1, 3, rgb=True)[0]
    ref = FFV1Encoder(w, h, "bgr0", cfg).encode(fr, True)
    pkt = par.encode_batch([fr], force_keyframe=True)[0]
    assert pkt == ref


def test_parallel_rejects_bad_mesh():
    mesh = _mesh(1, 8)
    cfg = FFV1Config(level=3, coder=1, slices=12)   # 12 % 8 != 0
    with pytest.raises(ValueError, match="divisible"):
        ParallelFFV1Encoder(64, 32, "yuv420p", cfg, mesh)


def test_parallel_banked_nonuniform():
    """Non-uniform slice geometry (36x33 at 2x2: luma slice rows 16 vs
    17) shards via shape banks: one shard_map program per bank, packets
    byte-identical to the host encoder."""
    w, h = 36, 33
    mesh = _mesh(1, 2)
    cfg = FFV1Config(level=3, coder=1, slices=4, slicecrc=1)
    par = ParallelFFV1Encoder(w, h, "yuv420p", cfg, mesh)
    assert len(par.units) == 2
    rng = np.random.RandomState(2)

    def frame(t):
        def plane(ph, pw, k):
            yy, xx = np.mgrid[0:ph, 0:pw]
            base = ((xx * (2 + k) + yy * (3 + k) + 5 * t) % 256) // 8 * 8
            return (base + rng.randint(0, 4, (ph, pw))).astype(np.int32)
        return [plane(h, w, 0), plane((h + 1) // 2, (w + 1) // 2, 1),
                plane((h + 1) // 2, (w + 1) // 2, 2)]

    frames = [frame(0), frame(1)]
    enc = FFV1Encoder(w, h, "yuv420p", cfg)
    for t in range(2):
        ref = enc.encode(frames[t], t == 0)
        pkt = par.encode_batch([frames[t]], force_keyframe=(t == 0))[0]
        assert pkt == ref, f"frame {t}"


def test_parallel_rgb_rice():
    """FATE's default-coder bgr0 config on the sharded encoder."""
    w, h = 64, 32
    mesh = _mesh(1, 8)
    cfg = FFV1Config(level=3, coder=0, slices=16, slicecrc=1)
    par = ParallelFFV1Encoder(w, h, "bgr0", cfg, mesh)
    fr = _frames(w, h, 1, 5, rgb=True)[0]
    ref = FFV1Encoder(w, h, "bgr0", cfg).encode(fr, True)
    pkt = par.encode_batch([fr], force_keyframe=True)[0]
    assert pkt == ref
