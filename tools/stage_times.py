#!/usr/bin/env python3
"""Per-stage device times of the FFV1 device encoder on the GPU.

Runs the stages of ``DeviceFFV1Encoder`` one by one at 1080p yuv420p
(30 slices, level 3), blocking after each, and prints one JSON line per
(config, stage) with the mean milliseconds per frame.  For each stage
that has a hand-written kernel it times the kernel and the plain XLA
reference side by side, and ``--xla-e2e`` times the whole path through
``encode()`` with every kernel replaced by its XLA reference.

    python tools/stage_times.py [--frames N] [--config range|rice]
                                [--xla-e2e]

Needs a GPU; the card's name and power limit are printed first.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import jax
import jax.numpy as jnp


def emit(**rec):
    print(json.dumps(rec), flush=True)


def timed(fn, *args, reps=3):
    """Mean seconds of fn(*args) over reps calls after one warm call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


def encode_seconds(dev, frames, reps):
    """Warm on frames[0..1], then mean seconds per encode() call."""
    dev.encode(frames[0], force_keyframe=True)
    dev.encode(frames[1], force_keyframe=False)
    t0 = time.perf_counter()
    for t in range(reps):
        dev.encode(frames[2 + t % (len(frames) - 2)], force_keyframe=False)
    return (time.perf_counter() - t0) / reps


def range_stages(dev, planes, reps):
    from ffmpeg_ffv2_tpu.ffv1.adapt_pallas import adapt_pallas
    from ffmpeg_ffv2_tpu.ffv1.device_coder import adapt_reference
    from ffmpeg_ffv2_tpu.ffv1.pallas_coder import LANE_BLOCK, \
        rac_pallas_packed
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import rac_scan_lanes
    tc, cc, sc = dev.tiles_cap, dev.cellrows_cap, dev.sortrows_cap
    out = {}
    t, (ctx, diff) = timed(dev._phase_a, planes, reps=reps)
    out["phase_a"] = t
    t, plan = timed(dev._s_layout, ctx, diff, tc, cc, reps=reps)
    out["layout"] = t
    t, (ch1c, ch2c) = timed(dev._s_scatter, plan, cc, reps=reps)
    out["scatter"] = t
    canon = dev.canonical
    t, s0 = timed(dev._s_s0, plan, canon, tc, reps=reps)
    out["s0"] = t
    t, (ev, ends) = timed(dev._s_adapt, ch1c, plan, s0, tc, cc,
                          dev.unsort_words, reps=reps)
    out["adapt+repack"] = t
    t, _ = timed(dev._s_wb, plan, canon, ends, tc, reps=reps)
    out["writeback"] = t
    t, (words_n, maxc) = timed(dev._s_unsort, ev, ch1c, ch2c, dev.S, sc,
                               reps=reps)
    out["unsort"] = t
    svp, btp, hlen = dev.prefix[False]
    t, (opw, n_ops) = timed(dev._s_expand, words_n, diff, svp, btp, hlen,
                            dev.op_cap, reps=reps)
    out["expand"] = t
    steps = 1 << int(jnp.max(n_ops)).bit_length()     # encode()'s bucket
    steps = max(512, min(steps, int(opw.shape[1])))
    t, (f, c, v) = timed(dev._coder_jit, opw, steps, reps=reps)
    out["coder"] = t
    t, _ = timed(dev._render_jit, f, c, v, dev.S, steps, dev.render_cap,
                 True, reps=reps)
    out["render"] = t

    # kernel vs plain XLA for the two range-coder kernels
    args = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
            s0, jnp.asarray(dev.table))
    walk_k = jax.jit(lambda *a: adapt_pallas(*a, tc, cc,
                                             code_bits=dev.code_bits))
    walk_x = jax.jit(lambda *a: adapt_reference(*a, tc,
                                                code_bits=dev.code_bits))
    tk, a = timed(walk_k, *args, reps=reps)
    tx, b = timed(walk_x, *args, reps=1)
    nr = int(plan["n_rows"])
    same = (np.array_equal(np.asarray(a[0])[:nr], np.asarray(b[0])[:nr])
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))
    kv = {"adapt_walk": (tk, tx, same)}
    lanes = -(-dev.S // LANE_BLOCK) * LANE_BLOCK
    opT = jnp.pad(opw[:, :steps].T, ((0, 0), (0, lanes - dev.S)))
    coder_x = jax.jit(lambda o: rac_scan_lanes(o & 0xFF, (o >> 8) & 1,
                                               (o >> 9) & 3))
    tk, a = timed(rac_pallas_packed, opT, reps=reps)
    tx, b = timed(coder_x, opT, reps=1)
    kv["coder"] = (tk, tx, all(np.array_equal(np.asarray(x), np.asarray(y))
                               for x, y in zip(a, b)))
    return out, kv, {"rows": nr, "tiles": int(plan["n_tiles"]),
                     "steps": steps, "max_ops": int(jnp.max(n_ops))}


def rice_stages(dev, planes, reps):
    from ffmpeg_ffv2_tpu.ffv1 import device_rice as R
    tc, cc, sc = dev.tiles_cap, dev.cellrows_cap, dev.sortrows_cap
    out = {}
    t, (ctx, streams) = timed(dev._phase_a_rice, planes, reps=reps)
    out["phase_a"] = t
    t, plan = timed(dev._s_rice_layout, ctx, streams["payload"], tc, cc,
                    reps=reps)
    out["layout"] = t
    t, (ch1c, ch2c) = timed(dev._s_scatter, plan, cc, reps=reps)
    out["scatter"] = t
    t, (code, vcanon, _) = timed(dev._s_vlc_walk, ch1c, plan, dev.vcanon,
                                 False, tc, reps=reps)
    out["vlc_walk+s0+writeback"] = t
    t, codes = timed(dev._s_rice_unsort, code, ch2c, dev.S, sc, reps=reps)
    out["unsort"] = t
    lf = jax.jit(lambda s: R.ladder_fields(s, dev.ev_cap))
    t, (ones, term_j, rem, _) = timed(lf, streams, reps=reps)
    out["ladder"] = t
    el = jax.jit(R.rice_elements)
    t, (lens, vals) = timed(el, streams, codes, ones, term_j, rem,
                            reps=reps)
    out["elements"] = t
    ab = jax.jit(lambda a, b: R.assemble_bits(a, b, dev.nwords))
    t, _ = timed(ab, lens, vals, reps=reps)
    out["assemble_bits"] = t

    s0 = R.build_vlc_s0(plan, dev.vcanon, tc)
    args = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
            s0)
    walk_k = jax.jit(lambda *a: R.vlc_adapt_pallas(*a, tc, cc, dev.p.bits))
    walk_x = jax.jit(lambda *a: R.vlc_adapt_reference(*a, tc, dev.p.bits))
    tk, a = timed(walk_k, *args, reps=reps)
    tx, b = timed(walk_x, *args, reps=1)
    nr = int(plan["n_rows"])
    same = (np.array_equal(np.asarray(a[0])[:nr], np.asarray(b[0])[:nr])
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))
    return out, {"vlc_walk": (tk, tx, same)}, {"rows": nr}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--config", choices=("range", "rice"), action="append",
                    help="only this configuration (repeatable)")
    ap.add_argument("--xla-e2e", action="store_true",
                    help="time encode() with every kernel replaced by XLA")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit("stage_times.py needs a GPU")
    from ffmpeg_ffv2_tpu.accel import setup_compile_cache
    setup_compile_cache()
    from ffmpeg_ffv2_tpu.accel import card_info
    emit(card=card_info(), jax=jax.__version__,
         device=jax.devices()[0].device_kind)
    from chip_smoke import synth_frames
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
    from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder
    w, h = 1920, 1080
    frames = synth_frames(w, h, 2 + args.frames, seed=77)
    planes = [jnp.asarray(np.asarray(p), jnp.int32) for p in frames[2]]
    for coder, name in ((1, "range"), (0, "rice")):
        if args.config and name not in args.config:
            continue
        cfg = FFV1Config(level=3, coder=coder, slices=30)
        dev = DeviceFFV1Encoder(w, h, "yuv420p", cfg)
        e2e = encode_seconds(dev, frames, args.frames)
        emit(config=name, stage="encode()", ms=e2e * 1e3,
             impl=dev.plan.describe())
        # host share of encode(): the slice-trailer CRCs over the packet
        from ffmpeg_ffv2_tpu.core.crc import crc32_trailer
        pkt = dev.encode(frames[2], force_keyframe=False)
        part = pkt[:len(pkt) // dev.S]
        t0 = time.perf_counter()
        for _ in range(dev.S):
            crc32_trailer(part)
        emit(config=name, stage="host_slice_crc", bytes=len(pkt),
             ms=(time.perf_counter() - t0) * 1e3)
        stages, kv, info = (range_stages if coder else rice_stages)(
            dev, planes, args.frames)
        for st, t in stages.items():
            emit(config=name, stage=st, ms=t * 1e3)
        for st, (tk, tx, same) in kv.items():
            emit(config=name, stage=st, kernel_ms=tk * 1e3,
                 xla_ms=tx * 1e3, identical=same)
        emit(config=name, **info)
        if args.xla_e2e:
            d = DeviceFFV1Encoder(w, h, "yuv420p", cfg)
            d.plan = dataclasses.replace(d.plan, kernels=frozenset())
            emit(config=name, stage="encode()", impl=d.plan.describe(),
                 ms=encode_seconds(d, frames, 1) * 1e3)


if __name__ == "__main__":
    main()
