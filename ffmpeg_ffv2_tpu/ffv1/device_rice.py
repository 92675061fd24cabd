"""Device-side FFV1 Golomb-Rice (run mode) encode planning.

The FATE-default coder (coder=0, 8-bit) on the full device pipeline.
Reference semantics: ffv1enc_template.c:46-76 (run machinery),
ffv1enc.c put_vlc_symbol / golomb.h set_sr_golomb (adaptive-k signed
Rice), bitstream.c ff_log2_run ladder.  The repo oracle is
codec_py.encode_line + coder/golomb.py (FATE-green).

Data-parallel formulation — nothing here follows the C control flow:

* **Run automaton closed form.**  Per line, with z = (diff == 0) and
  c0 = (ctx == 0):  mode_after(x) = "∃t ≤ x with c0(t) and z(t..x)"
  = (last-c0-pos > last-nonzero-pos), two `cummax` scans.  A pixel is
  *silent* (inside a run, no output, no state update) iff
  mode_in = (mode_after(x-1) | c0(x)) and z(x); a *run-end event* iff
  mode_in and not z(x).  The event's run length is x - entry where
  entry = first c0 position after the last nonzero diff — one
  segmented cummin (segments keyed by the running count of nonzero
  positions, folded into a single monotone key).
* **Ladder in closed form.**  The climb loop
  `while count >= 1 << L[i]: count -= 1 << L[i]; i++` is
  j = searchsorted(P, count + P[i]) - 1 over the prefix sums P of
  2^L — O(1) per event with a 42-entry table.  Only the tiny
  run_index carry (i ∈ [0, 40], one chain per (slice, plane), reset
  per plane) is sequential: a `lax.scan` over the compacted event
  stream, vectorized over all (slice, plane) lanes.
* **VlcState adaptation** rides the SAME chain-grouping front as the
  range coder (layout_plan / scatter_cells group pixels by
  (slice, plane-class, |context|)): the walk is a sibling of
  adapt_reference with a 4-row state block (drift, error_sum, bias,
  count) and one packed (len << 16 | bits) word out per cell.  Silent
  pixels travel in their context chain with a flag bit (bit 12 of the
  cell word — unused by the narrow packing) and are no-ops.
* **Bit assembly** is pure data parallelism: element lengths
  (run-climb ones, run terminator field, vlc code) prefix-sum into
  bit offsets; each element scatter-adds its MSB-first value into at
  most two 32-bit words (bit ranges are disjoint, so add == or).

Packets: [host-rendered range-coded slice header][device bitstream],
then the existing trailer/CRC assembly.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..accel import check_kernel_platform
from ..coder.golomb import LOG2_RUN

I32MAX = 2**31 - 1

LOG2_RUN_T = np.asarray(LOG2_RUN, np.int32)                  # (41,)
# P[i] = total run length consumed by climbing 0..i-1 (42 entries;
# max ~33M, comfortably int32 — counts are bounded by line width)
LADDER_P = np.concatenate(
    [[0], np.cumsum(1 << LOG2_RUN_T.astype(np.int64))]).astype(np.int32)


def _cummax(a, axis):
    return jax.lax.cummax(a, axis=axis)


def plan_runs_plane(ctx, diff):
    """Run-mode planning for one plane, all slices at once.

    ctx/diff: int32 (S, h, w) plane-local |context| and folded diff.
    Returns dict of (S, h, w) arrays: silent (bool), event (bool),
    run_count (i32, at events), flush (bool, at x = w-1), flush_count
    (i32), and diff_adj (i32: diff with the run-end ``diff>0 -> diff-1``
    adjustment applied).
    """
    i32 = jnp.int32
    S, h, w = diff.shape
    pos = jnp.arange(w, dtype=i32)[None, None, :]
    z = diff == 0
    c0 = ctx == 0

    lnz = _cummax(jnp.where(~z, pos, -1), axis=2)        # last nonzero
    lc0 = _cummax(jnp.where(c0, pos, -1), axis=2)        # last ctx==0
    mode_after = lc0 > lnz
    prev_after = jnp.concatenate(
        [jnp.zeros((S, h, 1), bool), mode_after[:, :, :-1]], axis=2)
    mode_in = prev_after | c0
    silent = mode_in & z
    event = mode_in & ~z

    # entry = first c0 position in the current zero-run segment.
    # Segments advance at nonzero positions; a monotone combined key
    # lets a plain cummin act segmented: seg strictly increases, so
    # later segments always win the min.
    BASE = w + 1
    seg = jnp.cumsum((~z).astype(i32), axis=2) - (~z).astype(i32)
    key = (-seg) * BASE + jnp.where(c0, pos, BASE - 1)
    fc0 = jax.lax.cummin(key, axis=2) + seg * BASE       # first-c0 pos
    entry = jnp.minimum(fc0, pos)
    run_count = pos[:, :, :] - entry                     # valid at events

    flush = jnp.zeros((S, h, w), bool).at[:, :, w - 1].set(
        mode_after[:, :, w - 1])
    flush_count = jnp.where(flush, w - entry, 0)

    diff_adj = jnp.where(event & (diff > 0), diff - 1, diff)
    return dict(silent=silent, event=event, run_count=run_count,
                flush=flush, flush_count=flush_count, diff_adj=diff_adj)


def ladder_step(i, count):
    """Closed-form climb: returns (j, ones, rem) — the post-climb index,
    the number of climb 1-bits, and the remaining count."""
    P = jnp.asarray(LADDER_P)
    t = count + jnp.take(P, i)
    j = (jnp.searchsorted(P, t, side="right") - 1).astype(jnp.int32)
    j = jnp.minimum(j, 40)
    ones = j - i
    rem = t - jnp.take(P, j)
    return j, ones, rem


def run_index_scan(ev_count, ev_flush, ev_valid, ev_reset=None):
    """Sequential run_index evolution over compacted event streams.

    ev_*: (L, E) per-lane event arrays (lane = slice when events from
    all planes share the lane — ev_reset marks each plane's first event
    and zeroes the index there, mirroring encode_plane's per-plane
    ``ss.run_index = 0``; E = event capacity; invalid tail entries have
    ev_valid False).  Returns idx_before (L, E) i32 — the post-reset
    index each event climbs from (overflow is NOT detected here —
    caller compares true event counts against E).
    """
    if ev_reset is None:
        ev_reset = jnp.zeros(ev_count.shape, bool)

    def step(i, xs):
        c, fl, va, rs = xs
        i_in = jnp.where(rs, 0, i)
        j, _, _ = ladder_step(i_in, c)
        nxt = jnp.where(fl, j, jnp.maximum(j - 1, 0))
        nxt = jnp.where(va, nxt, i)
        return nxt, jnp.where(va, i_in, i)

    i0 = jnp.zeros(ev_count.shape[0], jnp.int32)
    _, idx_before = jax.lax.scan(
        step, i0, (ev_count.T, ev_flush.T, ev_valid.T, ev_reset.T))
    return idx_before.T


# ---------------------------------------------------------------------------
# VlcState chain walk — plain XLA reference (the Triton kernel is below)
# ---------------------------------------------------------------------------

VLC_INIT = np.array([0, 4, 0, 1], np.int32)      # drift, error_sum, bias, count


def vlc_code_word(v0, drift, es, bias, count, bits: int):
    """One put_vlc_symbol, vectorized: returns (len, val, v) where v is
    the bias-folded value the state update consumes."""
    i32 = jnp.int32
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    d = (v0 - bias) & mask
    v = d - ((d & half) << 1)                       # fold to signed bits
    # k = smallest k with count << k >= error_sum   (golomb.py:95-99)
    ks = jnp.arange(16, dtype=i32)
    k = jnp.sum((count[..., None] << ks) < es[..., None], axis=-1)
    sgn = (2 * drift + count) >> 31                 # arithmetic shift
    code = v ^ sgn
    vv = (code << 1) ^ (code >> 31)                 # zigzag
    e = vv >> k
    esc = e >= 12
    length = jnp.where(esc, 12 + bits, e + k + 1)
    val = jnp.where(esc, vv - 11, (1 << k) | (vv & ((1 << k) - 1)))
    return length, val, v


def vlc_update(drift, es, bias, count, v):
    es = (es + jnp.abs(v)) & 0xFFFF
    drift = drift + v
    at128 = count == 128
    count = jnp.where(at128, count >> 1, count)
    drift = jnp.where(at128, drift >> 1, drift)     # arithmetic
    es = jnp.where(at128, es >> 1, es)
    count = count + 1
    neg = drift <= -count
    pos = drift > 0
    bias = jnp.where(neg, jnp.maximum(bias - 1, -128),
                     jnp.where(pos, jnp.minimum(bias + 1, 127), bias))
    drift = jnp.where(neg, jnp.maximum(drift + count, -count + 1),
                      jnp.where(pos, jnp.minimum(drift - count, 0), drift))
    return drift, es, bias, count


def vlc_adapt_reference(ch1_cells, tile_caps, tile_bases, tile_pred,
                        s0_blocks, tiles_cap: int, bits: int):
    """Row-scan reference of the vlc walk (the CPU path).

    ch1_cells: (CELLROWS, 128) int32 — bits 0..11 diff+2048, bit 12
    silent, bit 13 valid; s0_blocks: (TILES_CAP, 5, 128) int32 —
    4 state rows (drift, error_sum, bias, count) + row 4 continuation
    flag.  Returns (code_cells (CELLROWS, 128) int32 packed
    (len << 18 | val) — val reaches 17 bits when k = 16 —
    end_states (TILES_CAP, 4, 128)).
    """
    cellrows = ch1_cells.shape[0]
    i32 = jnp.int32

    starts = jnp.full(cellrows, -1, i32)
    tidx = jnp.arange(tiles_cap, dtype=i32)
    valid_tile = tile_caps > 0
    starts = starts.at[jnp.where(valid_tile, tile_bases, cellrows)].set(
        jnp.where(valid_tile, tidx, -1), mode="drop")

    def flush(carrybuf, cur_tile, s, do):
        t = jnp.maximum(cur_tile, 0)
        old = jax.lax.dynamic_slice(carrybuf, (t, 0, 0), (1, 4, 128))[0]
        newv = jnp.where(do & (cur_tile >= 0), s, old)
        return jax.lax.dynamic_update_slice(carrybuf, newv[None], (t, 0, 0))

    def step(carry, xs):
        s, cur_tile, carrybuf = carry
        row, tile_here = xs
        is_start = tile_here >= 0
        carrybuf = flush(carrybuf, cur_tile, s, is_start)

        t = jnp.maximum(tile_here, 0)
        blk = jax.lax.dynamic_slice(s0_blocks, (t, 0, 0), (1, 5, 128))[0]
        pr = tile_pred[t]
        prblk = jax.lax.dynamic_slice(
            carrybuf, (jnp.maximum(pr, 0), 0, 0), (1, 4, 128))[0]
        cont = (blk[4:5] > 0) & (pr >= 0)
        loaded = jnp.where(cont, prblk, blk[:4])
        s = jnp.where(is_start, loaded, s)
        cur_tile = jnp.where(is_start, tile_here, cur_tile)

        pb = 12 if bits <= 12 else 16      # payload diff-field width
        v0 = (row & ((1 << pb) - 1)) - (1 << (pb - 1))
        live = ((((row >> (pb + 1)) & 1) == 1)
                & (((row >> pb) & 1) == 0))
        drift, es, bias, count = s[0], s[1], s[2], s[3]
        length, val, v = vlc_code_word(v0, drift, es, bias, count, bits)
        nd, ne, nb, nc = vlc_update(drift, es, bias, count, v)
        s = jnp.where(live,
                      jnp.stack([nd, ne, nb, nc]), s)
        out = jnp.where(live, (length << 18) | val, 0)
        return (s, cur_tile, carrybuf), out

    s_init = jnp.broadcast_to(
        jnp.asarray(VLC_INIT)[:, None], (4, 128)).astype(i32)
    carrybuf = jnp.zeros((tiles_cap, 4, 128), i32)
    (s, cur_tile, carrybuf), code_cells = jax.lax.scan(
        step, (s_init, -1, carrybuf), (ch1_cells, starts))
    carrybuf = flush(carrybuf, cur_tile, s, jnp.bool_(True))
    return code_cells, carrybuf


def build_vlc_s0(plan, vcanon, tiles_cap: int):
    """(TILES_CAP, 5, 128) start-state blocks from the canonical vlc
    table ((rows + 1, 4) int32; the +1 row is scratch for drops)."""
    rows = plan["lane_rows"].reshape(tiles_cap, 128)
    cont = plan["lane_cont"].reshape(tiles_cap, 128)
    s0 = jnp.take(vcanon, rows, axis=0)                      # (T,128,4)
    s0 = s0.transpose(0, 2, 1)                               # (T,4,128)
    return jnp.concatenate([s0, cont[:, None, :]], axis=1)


def writeback_vlc(plan, vcanon, end_states, tiles_cap: int):
    rows = plan["lane_rows"].reshape(tiles_cap * 128)
    last = plan["lane_last"].reshape(tiles_cap * 128) > 0
    ends = end_states.transpose(0, 2, 1).reshape(tiles_cap * 128, 4)
    tgt = jnp.where(last, rows, I32MAX)
    return vcanon.at[tgt].set(ends, mode="drop", unique_indices=True)


# ---------------------------------------------------------------------------
# bit assembly
# ---------------------------------------------------------------------------

def assemble_bits(lens, vals, nwords: int):
    """Pack MSB-first bit elements into big-endian bytes per slice.

    lens/vals: (S, E) int32 element lengths (0 = absent, <= 31) and
    values (low ``len`` bits used).  Returns (bytes_ (S, nwords * 4)
    uint8, nbits (S,) total bit counts).
    """
    i32 = jnp.int32
    S, E = lens.shape
    off = jnp.cumsum(lens, axis=1) - lens
    nbits = jnp.sum(lens, axis=1)
    w0 = off >> 5
    b0 = off & 31
    # MSB-first within a 32-bit word: element occupies bits
    # [b0, b0+len); value shifts left by (32 - b0 - len), splitting
    # into the next word when b0 + len > 32.
    sh = 32 - b0 - lens
    vmask = jnp.where(lens > 0, (jnp.uint32(1) << lens.astype(jnp.uint32))
                      - 1, 0)
    v = vals.astype(jnp.uint32) & vmask
    hi = jnp.where(sh >= 0, v << jnp.maximum(sh, 0).astype(jnp.uint32),
                   v >> jnp.minimum(-sh, 31).astype(jnp.uint32))
    lo = jnp.where(sh < 0, v << ((32 + sh) & 31).astype(jnp.uint32),
                   jnp.uint32(0))
    live = lens > 0
    drop = I32MAX
    rows = jnp.arange(S, dtype=i32)[:, None]
    flat_hi = jnp.where(live, rows * nwords + w0, drop)
    flat_lo = jnp.where(live & (sh < 0), rows * nwords + w0 + 1, drop)
    words = jnp.zeros(S * nwords, jnp.uint32)
    words = words.at[flat_hi.reshape(-1)].add(hi.reshape(-1), mode="drop")
    words = words.at[flat_lo.reshape(-1)].add(lo.reshape(-1), mode="drop")
    words = words.reshape(S, nwords)
    sh8 = jnp.asarray([24, 16, 8, 0], jnp.uint32)
    by = (words[:, :, None] >> sh8[None, None, :]) & 0xFF
    return by.reshape(S, nwords * 4).astype(jnp.uint8), nbits


# ---------------------------------------------------------------------------
# stream building + element assembly (the glue between the planned runs,
# the vlc walk output, and assemble_bits)
# ---------------------------------------------------------------------------

def build_rice_streams(ctx_planes, diff_planes, pb: int = 12,
                       interleave: bool = False):
    """Per-plane (S, h, w) |context| / folded-diff grids -> stream-order
    (S, npix) arrays for the rice pipeline.

    Returns dict: payload ((diff_adj + 2^(pb-1)) | silent<<pb, the
    vlc-walk cell word before the layout adds the valid flag at
    pb+1), lad (bool, pixel carries a ladder event — run end or line
    flush), cnt (the ladder count), flush (bool), plane (plane index
    per stream pos).  pb = 12 covers bits <= 12; 16 covers 13..16.

    interleave: RGB stream layout — planes alternate per LINE
    (ffv1enc_template.c:188-198) and the run-index ladder is shared
    across the whole interleaved stream (one reset per slice,
    ffv1enc_template.c:138), so every position carries plane id 0.
    Run planning stays per-plane either way: runs cannot cross line
    ends (the encode_line flush)."""
    i32 = jnp.int32
    pays, lads, cnts, flushes, planes = [], [], [], [], []
    for li, (ctx, diff) in enumerate(zip(ctx_planes, diff_planes)):
        pr = plan_runs_plane(ctx, diff)
        pay = (((pr["diff_adj"] + (1 << (pb - 1))) & ((1 << pb) - 1))
               | (pr["silent"].astype(i32) << pb))
        lad = pr["event"] | pr["flush"]
        cnt = jnp.where(pr["flush"], pr["flush_count"], pr["run_count"])
        pays.append(pay)
        lads.append(lad)
        cnts.append(cnt)
        flushes.append(pr["flush"])
        planes.append(jnp.full(pay.shape, 0 if interleave else li, i32))
    S = diff_planes[0].shape[0]
    if interleave:
        cat = lambda xs: jnp.stack(xs, axis=2).reshape(S, -1)
    else:
        cat = lambda xs: jnp.concatenate(
            [x.reshape(x.shape[0], -1) for x in xs], axis=1)
    return dict(payload=cat(pays), lad=cat(lads), cnt=cat(cnts),
                flush=cat(flushes), plane=cat(planes))


def ladder_fields(streams, ev_cap: int):
    """Run the sequential run_index chain and deliver per-pixel ladder
    fields back to stream order.

    Returns (ones (S, npix), term_j (S, npix; post-climb ladder index
    for the terminator length), rem (S, npix; the post-climb count),
    n_lad (S,) true ladder-event counts for the ev_cap overflow check).
    Events compact per slice via one batched 3-operand sort (events of
    all planes share the lane; per-plane run_index resets ride a
    "first event of this plane" flag).
    """
    i32 = jnp.int32
    lad, cnt = streams["lad"], streams["cnt"]
    flush, plane = streams["flush"], streams["plane"]
    S, npix = lad.shape
    drop = I32MAX
    pos = jnp.arange(npix, dtype=i32)[None, :]
    key = jnp.where(lad, pos, drop)
    meta = (plane << 24) | (flush.astype(i32) << 23) | pos
    skey, scnt, smeta = jax.lax.sort(
        (key, cnt, meta), num_keys=1, dimension=1)
    skey = skey[:, :ev_cap]
    scnt = scnt[:, :ev_cap]
    smeta = smeta[:, :ev_cap]
    valid = skey != drop
    spl = smeta >> 24
    prev_pl = jnp.concatenate(
        [jnp.full((S, 1), -1, i32), spl[:, :-1]], axis=1)
    reset = valid & (spl != prev_pl)
    sflush = ((smeta >> 23) & 1) == 1
    i_before = run_index_scan(scnt, sflush, valid, reset)
    j, ones, rem = ladder_step(i_before, scnt)
    # deliver back to stream positions (tiny scatters: E updates)
    sorig = smeta & 0x7FFFFF
    flat = (jnp.arange(S, dtype=i32)[:, None] * npix
            + jnp.where(valid, sorig, 0))
    flat = jnp.where(valid, flat, drop)

    def put(v):
        return jnp.zeros(S * npix, i32).at[flat.reshape(-1)].set(
            v.reshape(-1), mode="drop",
            unique_indices=True).reshape(S, npix)

    return put(ones), put(j), put(rem), jnp.sum(lad, axis=1)


def rice_elements(streams, vlc_codes, ones, term_j, rem):
    """Per-pixel bit elements in stream order -> (lens, vals) (S, 3*npix).

    Slot order per pixel: [run climbs / line-flush bits][run terminator]
    [vlc code] — encode_line emission order (codec_py.py:132-170).
    vlc_codes: (S, npix) packed (len << 18 | val) from the vlc walk
    (0 for silent pixels).
    """
    i32 = jnp.int32
    lad, flush = streams["lad"], streams["flush"]
    event = lad & ~flush
    S, npix = lad.shape
    L2R = jnp.asarray(LOG2_RUN_T)
    # slot 0: event climbs = `ones` 1-bits; flush = ones 1-bits plus a
    # single 1 when a partial count remains (codec_py.py:163-169)
    l0 = jnp.where(event, ones,
                   jnp.where(flush, ones + (rem > 0).astype(i32), 0))
    v0 = (1 << jnp.maximum(l0, 0)) - 1
    # slot 1: run terminator [0][rem in LOG2_RUN[j] bits]
    lj = jnp.take(L2R, jnp.clip(term_j, 0, 40))
    l1 = jnp.where(event, 1 + lj, 0)
    v1 = jnp.where(event, rem, 0)
    # slot 2: vlc code (events and non-run pixels; 0 len for silent)
    l2 = vlc_codes >> 18
    v2 = vlc_codes & ((1 << 18) - 1)
    lens = jnp.stack([l0, l1, l2], axis=2).reshape(S, 3 * npix)
    vals = jnp.stack([v0, v1, v2], axis=2).reshape(S, 3 * npix)
    return lens, vals


# ---------------------------------------------------------------------------
# VlcState chain walk — Pallas (Triton) kernel
# ---------------------------------------------------------------------------
#
# The sibling of adapt_pallas: one program per block of lanes walks every
# tile and cell row in order, its lanes' four state rows (drift,
# error_sum, bias, count) in registers; there is no table gather, the
# coding and the state update are the reference's own arithmetic
# (vlc_code_word / vlc_update).  Split groups continue from carry[pred]
# at the same lane, written earlier by the same program.

VLC_LANE_BLOCK = 32


def _vlc_kernel(caps_ref, bases_ref, preds_ref, ch1_ref, s0_ref,
                code_ref, carry_ref, *, tiles: int, bits: int,
                lane_block: int, barrier: bool):
    lanes = pl.ds(pl.program_id(0) * lane_block, lane_block)
    pb = 12 if bits <= 12 else 16          # payload diff-field width

    def tile_body(t, carry):
        cap = caps_ref[t]
        base = bases_ref[t]
        pred = preds_ref[t]
        cont = (s0_ref[t, 4, lanes] > 0) & (pred >= 0)
        pr = jnp.maximum(pred, 0)
        st = tuple(jnp.where(cont, carry_ref[pr, k, lanes],
                             s0_ref[t, k, lanes]) for k in range(4))

        def row_body(r, c):
            drift, es, bias, count, cur = c
            nxt = ch1_ref[base + r + 1, lanes]          # prefetch
            v0 = (cur & ((1 << pb) - 1)) - (1 << (pb - 1))
            live = (((cur >> (pb + 1)) & 1) == 1) & (((cur >> pb) & 1) == 0)
            length, val, v = vlc_code_word(v0, drift, es, bias, count, bits)
            code_ref[base + r, lanes] = jnp.where(live, (length << 18) | val,
                                                  0)
            new = vlc_update(drift, es, bias, count, v)
            return (*(jnp.where(live, n, o)
                      for n, o in zip(new, (drift, es, bias, count))), nxt)

        out = jax.lax.fori_loop(0, cap, row_body,
                                (*st, ch1_ref[base, lanes]))
        for k in range(4):
            carry_ref[t, k, lanes] = jnp.where(cap > 0, out[k], 0)
        if barrier:
            plgpu.debug_barrier()
        return carry

    jax.lax.fori_loop(0, tiles, tile_body, 0)


@functools.partial(jax.jit,
                   static_argnames=("tiles_cap", "cellrows_cap", "bits",
                                    "interpret"))
def vlc_adapt_pallas(ch1_cells, tile_caps, tile_bases, tile_pred,
                     s0_blocks, tiles_cap: int, cellrows_cap: int,
                     bits: int, interpret: bool = False):
    """Same contract as vlc_adapt_reference (code_cells, end_states) on
    the layout's live rows; rows past the last tile are not written, and
    the layout must leave a row of slack past it (each row prefetches the
    next)."""
    check_kernel_platform("vlc_adapt_pallas", interpret)
    kern = functools.partial(_vlc_kernel, tiles=tiles_cap, bits=bits,
                             lane_block=VLC_LANE_BLOCK,
                             barrier=not interpret)
    return pl.pallas_call(
        kern,
        grid=(128 // VLC_LANE_BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((cellrows_cap, 128), jnp.int32),
                   jax.ShapeDtypeStruct((tiles_cap, 4, 128), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ffv1_vlc_walk",
    )(tile_caps, tile_bases, tile_pred, ch1_cells, s0_blocks)
