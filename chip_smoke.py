#!/usr/bin/env python3
"""GPU smoke test: the FFV1 device encoder end to end, byte-exact.

Drives the public entry points on the GPU at full frame size and checks
every packet against the host C++ encoder (``NativeFFV1Codec``) fed the
same frames and keyframe flags, and that ``NativeFFV1Codec.decode``
gives the input back exactly.  Tolerance is zero: the whole path is
integer arithmetic.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the four-card mesh path
    python chip_smoke.py --phase NAME  # one phase (repeatable)

One line per phase (name, byte_exact, frames, compile seconds, steady
seconds per frame, stage implementations), then the card's name and
power limit and the JAX version, and last one JSON line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line; so does a run where JAX finds no GPU.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def synth_frames(w, h, n, pix="yuv420p", seed=1234):
    """Deterministic video-like planes: gradients, a moving block and mild
    noise, at the depth and chroma layout of ``pix``."""
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    p = params_from_config(FFV1Config(), pix, w, h)
    if p.colorspace == 1:
        shapes = [(h, w)] * (4 if p.transparency else 3)
    else:
        shapes = [(h, w)]
        if p.chroma_planes:
            shapes += [(-(-h // (1 << p.chroma_v_shift)),
                        -(-w // (1 << p.chroma_h_shift)))] * 2
    up = max(p.bits, 8) - 8
    rng = np.random.RandomState(seed)
    frames = []
    for t in range(n):
        planes = []
        for k, (ph, pw) in enumerate(shapes):
            yy, xx = np.mgrid[0:ph, 0:pw]
            base = ((xx * (2 + k) + yy * (3 + k) + 7 * t) % 256) // 4 * 4
            bx = (13 * t + 5 * k) % max(1, pw - 32)
            by = (9 * t + 3 * k) % max(1, ph - 32)
            base[by:by + 32, bx:bx + 32] = (base[by:by + 32, bx:bx + 32]
                                            + 64) % 256
            pl = ((base + rng.randint(0, 3, (ph, pw))) & 0xFF) << up
            planes.append((pl | rng.randint(0, 1 << up, (ph, pw))
                           if up else pl).astype(np.int32))
        frames.append(planes)
    return frames


class PhaseFailed(AssertionError):
    pass


def check_packets(params, frames, keys, packets):
    """Each packet == the host encoder's for the same frame and keyframe
    flag, and the host decoder returns the frame exactly."""
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    nat = NativeFFV1Codec(params)
    dec = NativeFFV1Codec(params)
    for t, (fr, kf, pk) in enumerate(zip(frames, keys, packets)):
        ref = nat.encode(fr, kf)
        if pk != ref:
            raise PhaseFailed(f"frame {t} (key={kf}): {len(pk)} bytes vs "
                              f"host {len(ref)} bytes, not identical")
        for a, b in zip(dec.decode(pk), fr):
            if not np.array_equal(np.asarray(a), b):
                raise PhaseFailed(f"frame {t}: decode not lossless")


def run_session(encode, params, frames, keys):
    """Encode frames in order (the last one again, as the steady frame),
    check all of them, return (frames, compile_s, steady_s)."""
    times, pkts = [], []
    frames = list(frames) + [frames[-1]]
    keys = list(keys) + [False]
    for fr, kf in zip(frames, keys):
        t0 = time.perf_counter()
        pkts.append(encode(fr, kf))
        times.append(time.perf_counter() - t0)
    check_packets(params, frames, keys, pkts)
    steady = times[-1]
    return len(frames), sum(times[:-1]) - steady * (len(times) - 1), steady


def ffv1_phase(pix, w, h, cfg, keys, seed, params=None):
    from ffmpeg_ffv2_tpu.ffv1.params import params_from_config
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    dev = DeviceFFV1Encoder(w, h, pix, cfg, params=params)
    p = params or params_from_config(cfg, pix, w, h)
    frames = synth_frames(w, h, len(keys), pix, seed)
    n, comp, steady = run_session(
        lambda fr, kf: dev.encode(fr, force_keyframe=kf), p, frames, keys)
    return n, comp, steady, dev.plan.describe()


def phase_range_1080p(w=1920, h=1080):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    return ffv1_phase("yuv420p", w, h, FFV1Config(level=3, coder=1,
                                                  slices=30),
                      [True, False, False], 1234)


def phase_rice_1080p(w=1920, h=1080):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    return ffv1_phase("yuv420p", w, h, FFV1Config(level=3, coder=0,
                                                  slices=30),
                      [True, False], 77)


def phase_archival_422p10(w=1920, h=1080):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    cfg = FFV1Config(level=3, coder=1, context=1, slices=16, slicecrc=1)
    return ffv1_phase("yuv422p10", w, h, cfg, [True, False], 10)


def phase_rgb_720p(w=1280, h=720):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    return ffv1_phase("bgr0", w, h, FFV1Config(level=3, coder=1,
                                               slices=16),
                      [True, False], 9)


def phase_twopass_1080p(w=1920, h=1080):
    from ffmpeg_ffv2_tpu.ffv1 import twopass
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    cfg = FFV1Config(level=3, coder=1, slices=30)
    frames = synth_frames(w, h, 2, "yuv420p", 4242)
    p1 = params_from_config(cfg, "yuv420p", w, h)
    enc1 = NativeFFV1Codec(p1)
    enc1.enable_stats()
    for t, fr in enumerate(frames):
        enc1.encode(fr, t == 0)
    txt = twopass.stats_to_text(p1, *twopass.collect_stats(enc1))
    p2 = twopass.apply_pass2(params_from_config(cfg, "yuv420p", w, h), txt)
    if p2.initial_states is None:
        raise PhaseFailed("pass 2 carries no initial states")
    return ffv1_phase("yuv420p", w, h, cfg, [True, False], 4242, params=p2)


def phase_batch_1080p(w=1920, h=1080):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    cfg = FFV1Config(level=3, coder=1, slices=30)
    dev = DeviceFFV1Encoder(w, h, "yuv420p", cfg)
    frames = synth_frames(w, h, 2, "yuv420p", 1234)
    t0 = time.perf_counter()
    first = dev.encode_batch(frames)
    t1 = time.perf_counter()
    again = dev.encode_batch(frames)
    t2 = time.perf_counter()
    p = params_from_config(cfg, "yuv420p", w, h)
    check_packets(p, frames, [True, True], first)
    if again != first:
        raise PhaseFailed("second batch differs from the first")
    steady = (t2 - t1) / len(frames)
    return 2 * len(frames), (t1 - t0) - (t2 - t1), steady, \
        dev.plan.describe()


def parallel_session(w, h, cfg, mesh, frames_per_lane, keys):
    """ParallelFFV1Encoder over ``mesh``; lane b encodes its own stream.
    Returns (frames, compile_s, steady_s per call, impl)."""
    from ffmpeg_ffv2_tpu.ffv1.params import params_from_config
    from ffmpeg_ffv2_tpu.parallel.ffv1 import ParallelFFV1Encoder
    par = ParallelFFV1Encoder(w, h, "yuv420p", cfg, mesh)
    p = params_from_config(cfg, "yuv420p", w, h)
    frames_per_lane = [list(lane[:len(keys)]) + [lane[len(keys) - 1]]
                       for lane in frames_per_lane]
    keys = list(keys) + [False]          # the last frame again: steady
    times, out = [], [[] for _ in frames_per_lane]
    for t, kf in enumerate(keys):
        t0 = time.perf_counter()
        pkts = par.encode_batch([lane[t] for lane in frames_per_lane],
                                force_keyframe=kf)
        times.append(time.perf_counter() - t0)
        for b, pk in enumerate(pkts):
            out[b].append(pk)
    for b, lane in enumerate(frames_per_lane):
        check_packets(p, lane, keys, out[b])
    steady = times[-1]
    return (len(keys) * len(frames_per_lane),
            sum(times[:-1]) - steady * (len(times) - 1), steady,
            par.enc.plan.describe())


def phase_parallel_1card(w=1920, h=1080):
    import jax
    from jax.sharding import Mesh
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "slice"))
    cfg = FFV1Config(level=3, coder=1, slices=30)
    frames = synth_frames(w, h, 3, "yuv420p", 555)
    return parallel_session(w, h, cfg, mesh, [frames],
                            [True, False, False])


def ffv2_host_front(padded, depth, qp, bands):
    """The FFV2 front on the host: dsp's Q12, lapped prefilter and DCT,
    pvq's greedy search; same (dc, pulses, igain) layout as the device
    front (blocks in raster order, planes innermost)."""
    from ffmpeg_ffv2_tpu.ffv2 import dsp
    from ffmpeg_ffv2_tpu.ffv2.pvq import pvq_search
    sb = dsp.SB_SIZE
    coeff = [dsp.lap_filter_frame_ver(dsp.lap_filter_frame_hor(
        dsp.ref_to_coeff(pl, depth), sb, 32, True), sb, 32, True)
        for pl in padded]
    ph, pw = coeff[0].shape
    dcs, pulses, gains = [], [], []
    for y0 in range(0, ph, sb):
        for x0 in range(0, pw, sb):
            for c in coeff:
                stream = dsp.raster_to_coding(dsp.fwd_tx_2d(
                    c[y0:y0 + sb, x0:x0 + sb], dsp.TX_DCT))
                ac = stream[1:]
                dcs.append(int(stream[0]))
                row_p, row_g = [], []
                for lo, hi in zip(bands[:-1], bands[1:]):
                    band = np.zeros(hi - lo, np.int64)
                    real = ac[lo:hi]
                    band[:len(real)] = real
                    row_g.append(int(np.sum(band * band)))
                    row_p.append(pvq_search(band, qp, max_abs=qp - 1))
                pulses.append(np.concatenate(row_p))
                gains.append(row_g)
    return (np.asarray(dcs, np.int32), np.asarray(pulses, np.int8),
            np.asarray(gains, np.int64))


def phase_ffv2_front_512(w=512, h=512):
    from ffmpeg_ffv2_tpu.ffv2 import dsp
    from ffmpeg_ffv2_tpu.ffv2.codec import FFV2Config
    from ffmpeg_ffv2_tpu.ffv2.native import NativeFFV2Encoder, _pad_px
    from ffmpeg_ffv2_tpu.ffv2.tpu import encode_front_q
    frame = synth_frames(w, h, 1, "yuv444p", 16)[0]
    padded = np.stack([_pad_px(np.asarray(pl), 8) for pl in frame])
    bands = list(dsp.band_starts(dsp.SB_SIZE))
    t0 = time.perf_counter()
    dev = encode_front_q(padded, 8, 16, bands)
    t1 = time.perf_counter()
    dev = encode_front_q(padded, 8, 16, bands)
    t2 = time.perf_counter()
    host = ffv2_host_front(padded, 8, 16, bands)
    for name, a, b in zip(("dc", "pulses", "igain"), dev, host):
        if not np.array_equal(np.asarray(a), b):
            raise PhaseFailed(f"ffv2 front {name} differs from the host")
    enc = NativeFFV2Encoder(w, h, "yuv444p", FFV2Config(qp=16))
    if enc.encode(frame) != enc.encode(
            frame, front_q=lambda *a: ffv2_host_front(*a)):
        raise PhaseFailed("ffv2 packet differs with the host front")
    return 1, (t1 - t0) - (t2 - t1), t2 - t1, "front=xla"


PHASES = {
    "range_1080p": phase_range_1080p,
    "rice_1080p": phase_rice_1080p,
    "archival_422p10": phase_archival_422p10,
    "rgb_720p": phase_rgb_720p,
    "twopass_1080p": phase_twopass_1080p,
    "batch_1080p": phase_batch_1080p,
    "parallel_1card": phase_parallel_1card,
    "ffv2_front_512": phase_ffv2_front_512,
}


def four_card_phases(w=1920, h=1080):
    """The multi-card path, all in this process over four cards."""
    import jax
    from jax.sharding import Mesh
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")

    def mesh_1x4():
        cfg = FFV1Config(level=3, coder=1, slices=16)
        mesh = Mesh(np.asarray(devs).reshape(1, 4), ("data", "slice"))
        frames = synth_frames(w, h, 2, "yuv420p", 41)
        return parallel_session(w, h, cfg, mesh, [frames], [True, False])

    def mesh_2x2():
        cfg = FFV1Config(level=3, coder=0, slices=30)
        mesh = Mesh(np.asarray(devs).reshape(2, 2), ("data", "slice"))
        lanes = [synth_frames(w, h, 2, "yuv420p", 42 + b) for b in range(2)]
        return parallel_session(w, h, cfg, mesh, lanes, [True, False])

    def ffv2_sharded():
        from ffmpeg_ffv2_tpu.ffv2 import dsp
        from ffmpeg_ffv2_tpu.ffv2.native import _pad_px
        from ffmpeg_ffv2_tpu.ffv2.tpu import encode_front_q
        from ffmpeg_ffv2_tpu.parallel.ffv2 import encode_front_q_sharded
        frame = synth_frames(512, 512, 1, "yuv444p", 16)[0]
        padded = np.stack([_pad_px(np.asarray(pl), 8) for pl in frame])
        bands = list(dsp.band_starts(dsp.SB_SIZE))
        mesh = Mesh(np.asarray(devs), ("slice",))
        one = encode_front_q(padded, 8, 16, bands)
        t0 = time.perf_counter()
        four = encode_front_q_sharded(padded, 8, 16, bands, mesh)
        t1 = time.perf_counter()
        four = encode_front_q_sharded(padded, 8, 16, bands, mesh)
        t2 = time.perf_counter()
        for a, b in zip(one, four):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise PhaseFailed("sharded ffv2 front != one-card front")
        return 1, (t1 - t0) - (t2 - t1), t2 - t1, "front=xla"

    return {"parallel_1x4_range": mesh_1x4,
            "parallel_2x2_rice": mesh_2x2,
            "ffv2_front_sharded_4": ffv2_sharded}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only this one-card phase (repeatable)")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: needs a GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from ffmpeg_ffv2_tpu.accel import setup_compile_cache
    setup_compile_cache()

    if args.four_cards:
        phases = four_card_phases()
    else:
        phases = {k: PHASES[k] for k in (args.phase or PHASES)}
    failed = []
    for name, fn in phases.items():
        try:
            n, comp, steady, impl = fn()
            print(json.dumps({"phase": name, "byte_exact": True,
                              "frames": n, "compile_s": round(comp, 3),
                              "steady_s_per_frame": round(steady, 4),
                              "impl": f"{impl} others=xla"}), flush=True)
        except Exception as e:                  # report, go on, fail
            traceback.print_exc()
            failed.append(name)
            print(json.dumps({"phase": name, "byte_exact": False,
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
    from ffmpeg_ffv2_tpu.accel import card_info
    print(f"card: {card_info()}")
    print(f"jax: {jax.__version__}")
    if failed:
        print(f"chip_smoke.py: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
