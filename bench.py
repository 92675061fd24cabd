#!/usr/bin/env python3
"""Benchmarks: FFV1/FFV2 encode + decode throughput on this machine.

Prints ONE JSON line per metric:
    {"metric": ..., "value": N, "unit": ...}
The HEADLINE metric (1080p FFV1 lossless encode, best pipeline) is
printed LAST.

Every host-side metric (native encode, decode, 4K, FFV2, the
reference-binary head-to-head) is emitted before the device section,
which runs in the same process (one JAX process per card) and needs a
GPU: without one it emits a zero-valued line with an "error" key.

Pipelines measured at equal frame counts, failures loud:
  * native        — host C++ slice-threaded encoder (golomb + range)
  * ref_ffmpeg    — the reference binary (.refbuild/ffmpeg), same input,
                    same slices/threads: the head-to-head baseline
  * device        — the fully on-device pipeline (phase A, chain-grouped
                    adaptation, op assembly, arithmetic coder), measured
                    device-resident (frames pre-staged, one scalar
                    fetched at the end)
  * device_batched / device_rice — the all-intra batched device
                    pipeline (frame-parallel coder lanes) and the
                    golomb-rice device pipeline (FATE's default coder),
                    same device-resident convention
  * decode        — host decode throughput
  * 4K encode, FFV2 encode/decode

Correctness gates: the device packets are byte-compared against the
native encoder and decoded losslessly before any timing is reported.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(metric, value, unit="Mpix/s", **extra):
    rec = {"metric": metric, "value": round(float(value), 3), "unit": unit}
    rec.update(extra)
    line = json.dumps(rec)
    print(line, flush=True)
    return rec


def synth_1080p_frames(n, w=1920, h=1080):
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2) % 256 // 8 * 8).astype(np.int32)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2]
    cb = ((cxx + cyy) % 256).astype(np.int32)
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 4, (h, w)).astype(np.int32)
    return [[(base + t * 5 + noise) & 0xFF, (cb + t * 3) & 0xFF,
             (cb * 2 + t) & 0xFF] for t in range(n)]


def measure_host(frames, w, h, encode_fn):
    t0 = time.perf_counter()
    for t, f in enumerate(frames):
        encode_fn(f, t)
    return len(frames) * w * h / (time.perf_counter() - t0) / 1e6


def bench_native(frames, w, h, gop, results):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    for name, coder in (("golomb", -1), ("range", 1)):
        cfg = FFV1Config(slices=30, coder=coder, level=3)
        nat = NativeFFV1Codec(params_from_config(cfg, "yuv420p", w, h))
        nat.encode(frames[0], True)
        mp = measure_host(frames, w, h, lambda f, t: nat.encode(f, gop(t)))
        emit(f"ffv1_1080p_encode_native_{name}", mp)
        results[f"native_{name}"] = mp


def bench_decode(frames, w, h, gop, n_frames):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    cfg = FFV1Config(slices=30, coder=1, level=3)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = NativeFFV1Codec(p)
    pkts = [enc.encode(f, gop(t)) for t, f in enumerate(frames)]
    dec = NativeFFV1Codec(p)
    dec.decode(pkts[0])
    dec2 = NativeFFV1Codec(p)
    t0 = time.perf_counter()
    for pk in pkts:
        dec2.decode(pk)
    mp = n_frames * w * h / (time.perf_counter() - t0) / 1e6
    emit("ffv1_1080p_decode_native", mp)

    from ffmpeg_ffv2_tpu.ffv1.batched import BatchedFFV1Decoder
    bd = BatchedFFV1Decoder(p, mode="gop")
    keys = [gop(t) for t in range(n_frames)]
    bd.decode_all(pkts[:2], keys[:2])
    t0 = time.perf_counter()
    bd.decode_all(pkts, keys)
    mp = n_frames * w * h / (time.perf_counter() - t0) / 1e6
    emit("ffv1_1080p_decode_batched_gop", mp)

    # slice-column frame pipeline (the frame-thread analogue): scales
    # with min(threads, slices) on inter-heavy streams, no GOP splits
    nthr = os.cpu_count() or 1
    pd = NativeFFV1Codec(p, nthr)
    pd.decode_pipelined(pkts[:2])
    t0 = time.perf_counter()
    pd.decode_pipelined(pkts)
    mp = n_frames * w * h / (time.perf_counter() - t0) / 1e6
    emit("ffv1_1080p_decode_pipelined", mp, threads=nthr)


def bench_4k(n_frames, gop):
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    w4, h4 = 3840, 2160
    f4 = synth_1080p_frames(max(2, n_frames // 2), w4, h4)
    cfg = FFV1Config(slices=30, coder=1, level=3)
    nat4 = NativeFFV1Codec(params_from_config(cfg, "yuv420p", w4, h4))
    nat4.encode(f4[0], True)
    mp = measure_host(f4, w4, h4, lambda f, t: nat4.encode(f, gop(t)))
    emit("ffv1_4k_encode_native", mp)


def bench_ref_binary(frames, w, h, n_frames, results):
    """Head-to-head vs the reference ffmpeg binary on this host: same
    synthetic input over a rawvideo file, -slices 30 -coder range,
    -threads 1, gop 12 like our runs.  Wall-clock includes the binary's
    own startup — reported as-is.

    When the binary is absent, build it first (tools/build_ref.sh, the
    verify-skill recipe) under its own time limit."""
    ref = os.environ.get("REF_FFMPEG", os.path.join(REPO, ".refbuild",
                                                    "ffmpeg"))
    if not os.path.exists(ref) \
            and os.environ.get("BENCH_BUILD_REF", "1") == "1" \
            and os.path.exists("/root/reference/configure"):
        budget = float(os.environ.get("BENCH_REF_BUILD_BUDGET", "1500"))
        try:
            subprocess.run(["sh", os.path.join(REPO, "tools",
                                               "build_ref.sh")],
                           timeout=budget, check=True,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.STDOUT)
        except (subprocess.TimeoutExpired,
                subprocess.CalledProcessError) as e:
            emit("ref_ffmpeg_1080p_encode", 0.0,
                 error=f"reference build failed: {type(e).__name__}")
            return
    if not os.path.exists(ref):
        emit("ref_ffmpeg_1080p_encode", 0.0,
             error="reference binary not built")
        return
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.yuv")
        with open(src, "wb") as f:
            for fr in frames:
                f.write(np.asarray(fr[0], np.uint8).tobytes())
                f.write(np.asarray(fr[1], np.uint8).tobytes())
                f.write(np.asarray(fr[2], np.uint8).tobytes())
        out = os.path.join(td, "ref.avi")
        for name, coder in (("golomb", "0"), ("range", "1")):
            cmd = [ref, "-y", "-loglevel", "error", "-threads", "1",
                   "-f", "rawvideo", "-pix_fmt", "yuv420p",
                   "-s", f"{w}x{h}", "-i", src, "-c:v", "ffv1",
                   "-level", "3", "-coder", coder,
                   "-slices", "30", "-g", "12",
                   "-flags", "+bitexact", "-fflags", "+bitexact",
                   "-threads", "1", "-f", "avi", out]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True)
            dt = time.perf_counter() - t0
            mp = n_frames * w * h / dt / 1e6
            emit(f"ref_ffmpeg_1080p_encode_{name}", mp)
            results["ref_ffmpeg"] = max(results.get("ref_ffmpeg", 0), mp)

        dec_out = os.path.join(td, "dec.yuv")
        cmd = [ref, "-y", "-loglevel", "error", "-threads", "1",
               "-i", out, "-f", "rawvideo", dec_out]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True)
        dt = time.perf_counter() - t0
        emit("ref_ffmpeg_1080p_decode", n_frames * w * h / dt / 1e6)


def bench_ffv2(n_frames):
    from ffmpeg_ffv2_tpu.ffv2.native import (NativeFFV2Encoder,
                                             NativeFFV2Decoder,
                                             PipelinedFFV2Encoder)
    from ffmpeg_ffv2_tpu.ffv2.codec import FFV2Config
    wf, hf = 512, 512
    yy, xx = np.mgrid[0:hf, 0:wf]
    fr2 = [[((xx + yy * 2 + 40 * t) % 256).astype(np.int64)
            for _ in range(3)] for t in range(4)]
    enc2 = NativeFFV2Encoder(wf, hf, "yuv444p", FFV2Config(qp=16))
    pk0 = enc2.encode(fr2[0])
    t0 = time.perf_counter()
    pkts2 = [enc2.encode(f) for f in fr2]
    mp = len(fr2) * wf * hf / (time.perf_counter() - t0) / 1e6
    emit("ffv2_512_encode", mp)
    # frame-pipelined EC: worker-thread Daala coder overlaps the
    # device front (byte-identical packets — asserted)
    pipe = PipelinedFFV2Encoder(wf, hf, "yuv444p", FFV2Config(qp=16),
                                depth=2)
    pk_pipe = pipe.encode_stream(fr2[:1])      # warm
    assert pk_pipe[0] == pk0, "pipelined ffv2 packet mismatch"
    t0 = time.perf_counter()
    pkts_p = pipe.encode_stream(fr2)
    mp = len(fr2) * wf * hf / (time.perf_counter() - t0) / 1e6
    pipe.close()
    assert pkts_p == pkts2, "pipelined ffv2 stream mismatch"
    emit("ffv2_512_encode_pipelined", mp)

    dec2 = NativeFFV2Decoder(wf, hf)
    dec2.decode(pkts2[0])
    t0 = time.perf_counter()
    for pk in pkts2:
        dec2.decode(pk)
    mp = len(fr2) * wf * hf / (time.perf_counter() - t0) / 1e6
    emit("ffv2_512_decode", mp)

    # compute-bound split: the EC below runs on prefetched quant data
    import ctypes
    from ffmpeg_ffv2_tpu.ffv2 import dsp as _dsp
    from ffmpeg_ffv2_tpu.ffv2.native import _pad_px
    from ffmpeg_ffv2_tpu.ffv2.tpu import encode_front_q
    from ffmpeg_ffv2_tpu.ffv2.pvq import icbrt_array
    lib = enc2.lib
    bands_l = list(_dsp.band_starts(64))
    padded = np.stack([_pad_px(np.asarray(p), 8) for p in fr2[0]])
    dcq, pulses, igain = encode_front_q(padded, 8, 16, bands_l)
    t0 = time.perf_counter()
    for _ in range(len(fr2)):
        cgq = icbrt_array(np.asarray(igain))
        hq = lib.ffv2rt_enc_create(
            16, np.asarray(bands_l, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)), len(bands_l))
        dc64 = np.ascontiguousarray(dcq, np.int64)
        cgc = np.ascontiguousarray(cgq)
        pu = np.ascontiguousarray(pulses)
        lib.ffv2rt_enc_frame_q(
            hq, dc64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cgc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pu.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            pu.shape[1], igain.shape[1], 64, 3, 64, _dsp.TX_DCT)
        out = np.empty(1 << 22, np.uint8)
        lib.ffv2rt_enc_done.restype = ctypes.c_int64
        lib.ffv2rt_enc_done(hq, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), 1 << 22)
        lib.ffv2rt_enc_destroy(hq)
    mp = len(fr2) * wf * hf / (time.perf_counter() - t0) / 1e6
    emit("ffv2_512_encode_compute", mp)

    # head-to-head: the reference FFV2 encoder is single-threaded C
    # (ffv2enc.c:453, no slice/frame threading) with the AVX PVQ search
    # replaced by the same C stand-in our refbuild links (the asm needs
    # x86asm).  Same content, same qp via -global_quality.
    ref = os.environ.get("REF_FFMPEG", os.path.join(REPO, ".refbuild",
                                                    "ffmpeg"))
    if os.path.exists(ref):
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "in.yuv")
            with open(src, "wb") as f:
                for fr in fr2:
                    for pl in fr:
                        f.write(np.asarray(pl, np.uint8).tobytes())
            out = os.path.join(td, "ref.mkv")
            cmd = [ref, "-y", "-loglevel", "error", "-threads", "1",
                   "-f", "rawvideo", "-pix_fmt", "yuv444p",
                   "-s", f"{wf}x{hf}", "-i", src, "-c:v", "ffv2",
                   "-strict", "-2", "-global_quality", "16",
                   "-threads", "1", "-f", "matroska", out]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True)
            dt = time.perf_counter() - t0
            emit("ref_ffmpeg_ffv2_512_encode",
                 len(fr2) * wf * hf / dt / 1e6)
    else:
        emit("ref_ffmpeg_ffv2_512_encode", 0.0,
             error="reference binary not built")


# ---------------------------------------------------------------------------
# Device section

def device_main(results):
    """Gate + time the full on-device pipeline (needs a GPU)."""
    import jax
    if jax.default_backend() != "gpu":
        emit("ffv1_1080p_encode_device", 0.0,
             error=f"device section needs a GPU, found "
                   f"{jax.default_backend()!r}")
        return
    from ffmpeg_ffv2_tpu.accel import card_info, setup_compile_cache
    setup_compile_cache()
    dev0 = jax.devices()[0]
    where = dict(platform=dev0.platform, device_kind=dev0.device_kind,
                 devices=len(jax.devices()), card=card_info())
    print(f"# card: {where['card']}", flush=True)
    import jax.numpy as jnp
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder

    w, h = 1920, 1080
    n_frames = int(os.environ.get("BENCH_FRAMES", "8"))
    frames = synth_1080p_frames(n_frames)
    gop = lambda t: t % 12 == 0
    cfg_r = FFV1Config(level=3, coder=1, slices=30)
    p_r = params_from_config(cfg_r, "yuv420p", w, h)

    # ---- correctness gate: device packets == native, decode lossless ----
    dev = DeviceFFV1Encoder(w, h, "yuv420p", cfg_r)
    nat_gate = NativeFFV1Codec(p_r)
    dec_gate = NativeFFV1Codec(p_r)
    for t in range(2):
        pk = dev.encode(frames[t], force_keyframe=gop(t))
        ref = nat_gate.encode(frames[t], gop(t))
        assert pk == ref, f"device pipeline packet mismatch, frame {t}"
        for a, b in zip(dec_gate.decode(pk), frames[t]):
            assert np.array_equal(a, b), "device pipeline not lossless"
    print("# gate: device packets byte-identical to native and "
          "lossless", flush=True)

    # ---- full device pipeline, device-resident (frame in -> packet
    # bytes out: phase A, layout, adapt, op assembly, arithmetic coder,
    # byte rendering — everything but the final tiny fetch) ----
    ev_use = dev.op_cap
    planes_dev = [[jnp.asarray(pl, jnp.int32) for pl in f] for f in frames]
    canon = dev.canonical
    caps = (dev.tiles_cap, dev.cellrows_cap, dev.op_cap,
            dev.sortrows_cap)                             # gate-adapted
    rcap = dev.render_cap
    uw = dev.unsort_words                                 # gate-adapted

    def frame_step(t, canon):
        opw, n_ops, canon, sizes = dev._pipeline(
            planes_dev[t], canon, gop(t), caps, uw)
        by, ln, fcm = dev._code_render(opw, ev_use, rcap)
        probe = (jnp.sum(ln) + jnp.max(n_ops) + jnp.sum(sizes)
                 + jnp.sum(by[:, :128].astype(jnp.int32)) + fcm)
        return canon, probe, jnp.max(n_ops), jnp.max(ln), fcm, sizes[-1]

    canon, probe, nmax, lmax, fcm, mc = frame_step(0, canon)
    canon, probe, nmax, lmax, fcm, mc = frame_step(1, canon)
    float(probe)
    t0 = time.perf_counter()
    probes = []
    for t in range(n_frames):
        canon, probe, nmax, lmax, fcm, mc = frame_step(t, canon)
        probes.append((probe, nmax, lmax, fcm, mc))
    tot = float(sum(pr for pr, _, _, _, _ in probes))  # one sync at end
    dt = time.perf_counter() - t0
    assert all(float(nm) <= ev_use for _, nm, _, _, _ in probes), \
        "device pipeline op-stream overflow (raise EV bound)"
    assert all(float(lm) <= rcap for _, _, lm, _, _ in probes), \
        "device render buffer overflow (raise render_cap)"
    assert all(float(m) <= 4 * uw for _, _, _, _, m in probes), \
        "device unsort payload width overflow; bench path invalid"
    # fast-render validity: encode() re-renders when a fill run
    # overflows the 10-bit field; the bench must not time garbage
    assert all(float(fc) <= 1023 for _, _, _, fc, _ in probes), \
        "fast-render fill-run overflow; bench path invalid"
    assert np.isfinite(tot)
    mp = n_frames * w * h / dt / 1e6
    emit("ffv1_1080p_encode_device", mp, **where)
    results["device"] = mp

    # ---- golomb-rice device pipeline (the FATE-default coder) ----
    if os.environ.get("BENCH_DEVICE_RICE", "1") == "1":
        cfg_g = FFV1Config(level=3, coder=0, slices=30)
        p_g = params_from_config(cfg_g, "yuv420p", w, h)
        devg = DeviceFFV1Encoder(w, h, "yuv420p", cfg_g)
        natg = NativeFFV1Codec(p_g)
        decg = NativeFFV1Codec(p_g)
        for t in range(2):
            pk = devg.encode(frames[t], force_keyframe=gop(t))
            ref = natg.encode(frames[t], gop(t))
            assert pk == ref, f"device rice packet mismatch, frame {t}"
            for a, b in zip(decg.decode(pk), frames[t]):
                assert np.array_equal(a, b), "device rice not lossless"
        print("# gate: device_rice packets byte-identical to native "
              "and lossless", flush=True)

        def rice_step(t, vcanon):
            ctx, streams = devg._phase_a_rice(planes_dev[t])
            plan = devg._s_rice_layout(ctx, streams["payload"],
                                       devg.tiles_cap, devg.cellrows_cap)
            ch1c, ch2c = devg._s_scatter(plan, devg.cellrows_cap)
            code_cells, vcanon, psizes = devg._s_vlc_walk(
                ch1c, plan, vcanon, gop(t), devg.tiles_cap)
            vlc_codes = devg._s_rice_unsort(code_cells, ch2c, devg.S,
                                            devg.sortrows_cap)
            by, nbits, n_lad = devg._s_rice_bits(streams, vlc_codes,
                                                 devg.ev_cap, devg.nwords)
            probe = (jnp.sum(nbits) + jnp.sum(psizes) + jnp.max(n_lad)
                     + jnp.sum(by[:, :128].astype(jnp.int32)))
            return vcanon, (probe, psizes, jnp.max(n_lad),
                            jnp.max(nbits))

        vcanon = devg.vcanon
        vcanon, sig0 = rice_step(0, vcanon)
        vcanon, sig1 = rice_step(1, vcanon)
        float(sig0[0])
        float(sig1[0])          # frame 0's outputs are not in sig1's
        # dependency chain; block on both so no warm-up work leaks
        # into the timed window
        vcanon = devg.vcanon
        t0 = time.perf_counter()
        sigs = []
        for t in range(n_frames):
            vcanon, sig = rice_step(t, vcanon)
            sigs.append(sig)
        tot = float(sum(pr for pr, _, _, _ in sigs))   # one sync at end
        dt = time.perf_counter() - t0
        assert np.isfinite(tot)
        for pr, psz, nl, nb in sigs:
            rows, tiles, slots = (int(v) for v in np.asarray(psz))
            assert rows + 1024 <= devg.cellrows_cap \
                and rows <= devg.sortrows_cap \
                and tiles <= devg.tiles_cap \
                and slots <= devg.tiles_cap * 128, "rice layout overflow"
            assert int(nl) <= devg.ev_cap, "rice ladder overflow"
            assert int(nb) <= devg.nwords * 32, "rice bit-count overflow"
        mp = n_frames * w * h / dt / 1e6
        # device-resident convention, same as the range metric above:
        # the timed loop syncs one probe scalar per batch; the per-frame
        # host fetch of psizes/nbits + packet-byte assembly that
        # devg.encode() performs is EXCLUDED (and for rice that fetch
        # happens every frame, so frame-to-packet throughput through
        # encode() is lower than this number)
        emit("ffv1_1080p_encode_device_rice", mp, **where)
        results["device_rice"] = mp

    # ---- all-intra batched device encode (frame-parallel lanes) ----
    if os.environ.get("BENCH_BATCHED", "1") == "1":
        Bb = min(4, n_frames)
        pkb = dev.encode_batch(frames[:Bb])        # gate + cap adaptation
        for t in range(Bb):
            assert pkb[t] == nat_gate.encode(frames[t], True), \
                f"batched device packet mismatch, frame {t}"
        st = dev._batch_state(Bb)
        bcaps = (st["tiles"], st["cellrows"], dev.op_cap, st["sort"])

        def bstep(fr):
            opw, n_ops, _, sizes = dev._pipeline_batch(fr, st["canon"],
                                                       bcaps)
            by, ln, fcm = dev._code_render(opw, ev_use, dev.render_cap)
            return (jnp.sum(ln) + jnp.sum(sizes) + fcm
                    + jnp.sum(by[:, :128].astype(jnp.int32)),
                    jnp.max(n_ops), jnp.max(ln))

        batches = [planes_dev[i:i + Bb]
                   for i in range(0, n_frames - Bb + 1, Bb)]
        pr, nm, lm = bstep(batches[0])
        float(pr)
        t0 = time.perf_counter()
        outs = [bstep(bt) for bt in batches]
        tot = float(sum(pr for pr, _, _ in outs))
        dt = time.perf_counter() - t0
        assert np.isfinite(tot)
        assert all(float(nm) <= ev_use for _, nm, _ in outs)
        assert all(float(lm) <= dev.render_cap for _, _, lm in outs)
        mp = len(batches) * Bb * w * h / dt / 1e6
        emit(f"ffv1_1080p_encode_device_batched{Bb}", mp, **where)
        results[f"device_batched{Bb}"] = mp


def main():
    w, h = 1920, 1080
    n_frames = int(os.environ.get("BENCH_FRAMES", "8"))
    which = set(os.environ.get(
        "BENCH_PIPELINES",
        "native,decode,4k,ffv2,ref,device").split(","))
    frames = synth_1080p_frames(n_frames)
    gop = lambda t: t % 12 == 0
    results = {}

    # host-side metrics first: the bench emits its floor before any
    # device compile can stall it
    if "native" in which:
        bench_native(frames, w, h, gop, results)
    if "decode" in which:
        bench_decode(frames, w, h, gop, n_frames)
    if "4k" in which:
        bench_4k(n_frames, gop)
    if "ref" in which:
        # before ffv2: bench_ref_binary builds .refbuild/ffmpeg when
        # absent, and bench_ffv2's head-to-head reuses it
        bench_ref_binary(frames, w, h, n_frames, results)
    if "ffv2" in which:
        bench_ffv2(n_frames)

    # device pipeline last
    if "device" in which:
        device_main(results)

    # ---- headline: best 1080p lossless encode pipeline (ours) ----
    ours = {k: v for k, v in results.items() if k != "ref_ffmpeg"}
    if ours:
        best = max(ours, key=ours.get)
        emit(f"ffv1_1080p_lossless_encode_throughput_{best}", ours[best])


if __name__ == "__main__":
    main()
