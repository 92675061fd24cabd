"""Fully on-device FFV1 phase B: adaptation + arithmetic on the device.

The hybrid encoder (tpu_encoder.py) runs phase A (context modeling) on the
device and phase B (adaptive range coding) on the host, where the
*adaptation planner* — resolving which 8-bit state value codes each binary
decision — is serial.  This module moves that planning onto the device.

The key observation: ``put_symbol_inline`` (ffv1enc.c:185-231) emits, per
pixel, at most one event per state slot when the exponent e <= 9 (always
true for bits <= 10: |diff| <= 2^(bits-1)).  So the adaptive state table
walk decomposes into independent *chains*, one per (slice, plane-class,
context) "group" x 32 slots, and a group's 32 slot-chains advance together
pixel-by-pixel.  Pipeline:

1. phase A (ffv1/tpu.py) -> per-slice streams of (ctx, diff) in coding
   order (planes concatenated, ffv1enc.c:1045-1102 order).
2. group pixels by chain row = (slice, plane-class, ctx): one stable sort.
3. lay groups out as *lanes*: one group per lane, lanes sorted by length
   (descending) and packed 128 per tile; groups longer than GCAP split
   into sub-lanes placed in later tiles at the same lane, and a carry
   buffer hands the 32 slot states from a sub-lane to its successor.
4. the adaptation walk (adapt_pallas on the GPU, adapt_reference
   elsewhere) walks each lane's pixels with its 32 slot states; the state
   transition is one lookup in the zero/one tables (rangecoder.h:104-121
   semantics).  It emits the pre-update state value per (pixel, slot).
5. unsort the cells back to stream order, expand each pixel's state
   values into its op stream (expand_ops_reference), then run the
   lane-parallel arithmetic coder (pallas_coder on the GPU, tpu_coder's
   scan elsewhere) and render the packet bytes.

The slice headers and keyframe bit are planned on the host (tiny, ~40
symbols/slice) with a recording RangeEncoder and prepended to each slice's
op stream; the tail appends the version-1 terminator op (state 129, bit 0;
rangecoder.c:109-123) and the two flush steps.

Byte-exactness oracle: the native planner (ffv1rt_plan) emits the exact
per-slice (sv, bit) streams; tests diff every stage against it and the
assembled packets against NativeFFV1Codec.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import stage_plan
from ..coder.rac import (RangeEncoder, DEFAULT_ZERO_STATE, DEFAULT_ONE_STATE)
from ..core.crc import crc32_trailer
from .params import FFV1Params, FFV1Config, params_from_config, \
    CODER_RANGE_CUSTOM, CODER_GOLOMB
from .codec_py import SliceState
from . import headers as H

# ---------------------------------------------------------------------------
# transition tables
# ---------------------------------------------------------------------------


def transition_tables(p: FFV1Params) -> tuple[np.ndarray, np.ndarray]:
    """(zero_state, one_state) uint8[256] used by this stream's slices."""
    if p.ac == CODER_RANGE_CUSTOM:
        one = np.asarray(p.state_transition, dtype=np.uint8).copy()
        zero = np.zeros(256, dtype=np.uint8)
        idx = np.arange(1, 256)
        zero[256 - idx] = (256 - one[idx].astype(np.int64)).astype(np.uint8)
        return zero, one
    return (np.asarray(DEFAULT_ZERO_STATE, dtype=np.uint8),
            np.asarray(DEFAULT_ONE_STATE, dtype=np.uint8))


def packed_transition_table(p: FFV1Params) -> np.ndarray:
    """zero_state ++ one_state packed little-endian into 128 int32 words.

    Lookup of T[bit*256 + s] becomes one lanewise gather of word
    (bit*256+s)>>2 plus a byte extract — the whole table fits one
    128-lane vector register."""
    zero, one = transition_tables(p)
    return np.concatenate([zero, one]).view("<u4").astype(np.int32)


def lookup_packed(table: jnp.ndarray, idx9: jnp.ndarray) -> jnp.ndarray:
    """table: (...,128) int32 (broadcast to idx9's shape row-wise);
    idx9: int32 in [0, 512) -> table byte value (int32)."""
    word = jnp.take_along_axis(table, idx9 >> 2, axis=-1)
    return (word >> ((idx9 & 3) * 8)) & 0xFF


# ---------------------------------------------------------------------------
# put_symbol expansion.  For coding depth <= 10 (e <= 9) every state slot
# is hit at most once per pixel.  Deeper formats (<= 16) repeat slots 10
# (exponent cap) and 31 (mantissa cap) up to e-9 extra times each
# (put_symbol_inline FFMIN caps, ffv1enc.c:217-226); the adapt kernels
# run R = bits-10 masked sub-steps per pixel for those and emit the
# repeat state values in (R+1)//2 extra packed words.
# ---------------------------------------------------------------------------


def quantize_cap(need: int, cap_max: int, gran: int = 1) -> int:
    """Snap an adaptive working-domain size to a coarse rung.

    Rungs are m * 2^e with m in [4, 8) (quarter-octave spacing), rounded
    up to ``gran``.  Every jitted stage is keyed by these static sizes;
    fine-grained content-measured caps (rows + rows//16 style) would give
    each clip its own shapes and therefore its own cold compile.
    Quantized, a whole band of contents shares one
    compiled variant and the persistent cache actually persists.  The
    rung always covers ``need`` (clamped to cap_max; callers validate
    real fit against the measured sizes)."""
    if need >= cap_max:
        return cap_max
    v = max(int(need), 1)
    e = max(0, v.bit_length() - 3)
    v = -(-v >> e) << e
    v = -(-v // gran) * gran
    return min(v, cap_max)


def k_max_for_bits(bits: int) -> int:
    """Worst-case rac ops per pixel: 2*e_max + 3, e_max = bits-1 <= 16
    (17 = RGB at 16 bpc, coded at bits+1 — ffv1enc_template.c:193)."""
    if bits > 17:
        raise ValueError("slot-grid expansion needs e <= 16 (bits <= 17)")
    return 2 * (bits - 1) + 3


def payload_field(code_bits: int) -> tuple[int, int, int]:
    """(mask, bias, valid_bit) of the cell payload's diff field: 12-bit
    for coding depths <= 10, 16-bit for 11..16, 17-bit for 17."""
    if code_bits > 16:
        return 0x1FFFF, 65536, 17
    if code_bits > 10:
        return 0xFFFF, 32768, 16
    return 0xFFF, 2048, 13


def n_sv_words(bits: int) -> int:
    """Packed sv words per cell: 8 base + ceil(R/2) repeat-pair words."""
    r = max(0, bits - 10)
    return 8 + (r + 1) // 2


def n_ev_words(bits: int) -> int:
    """Emission-order byte words per cell: ceil(k_max / 4)."""
    return (k_max_for_bits(bits) + 3) // 4


def exponent(a):
    """floor(log2(a)) for 1 <= a < 2^24 via the f32 exponent; -1 for 0."""
    f = a.astype(jnp.float32)
    e = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127
    return jnp.where(a > 0, e, -1)


def event_count(diff):
    """Number of rac ops put_symbol(diff, signed) performs."""
    e = exponent(jnp.abs(diff))
    return jnp.where(diff == 0, 1, 2 * e + 3)


def slot_bit_grid(diff):
    """Per (pixel, slot) validity and coded bit of each slot's FIRST hit.

    diff: int32 [...]; returns (valid bool [..., 32], bit int32 [..., 32])
    following put_symbol_inline (ffv1enc.c:203-230) incl. the e > 9 FFMIN
    caps (repeat hits of slots 10/31 are handled by the adapt sub-steps):
      slot 0: always, bit = (v == 0)
      slots 1..min(e+1,10): exponent ones then terminator zero
      slots 22..21+min(e,10): mantissa (slot 31's first hit is i = e-1
        when e > 9, else i = slot-22)
      slot 11+min(e,10): sign (v < 0)
    """
    v = diff[..., None]
    a = jnp.abs(v)
    e = exponent(jnp.abs(diff))[..., None]
    s = jnp.arange(32, dtype=jnp.int32)
    s = jnp.broadcast_to(s, v.shape[:-1] + (32,))
    nz = v != 0
    is0 = s == 0
    isexp = (s >= 1) & (s <= jnp.minimum(e + 1, 10))
    ismant = (s >= 22) & (s <= 21 + jnp.minimum(e, 10))
    issign = s == 11 + jnp.minimum(e, 10)
    valid = is0 | (nz & (isexp | ismant | issign))
    msh = jnp.where((s == 31) & (e > 9), e - 1, s - 22)
    bit = jnp.where(is0, (v == 0).astype(jnp.int32),
          jnp.where(isexp, (s <= e).astype(jnp.int32),
          jnp.where(ismant, (a >> jnp.maximum(msh, 0)) & 1,
                    (v < 0).astype(jnp.int32))))
    return valid, bit.astype(jnp.int32)


def emission_slots(diff, k_max: int):
    """Per (pixel, k) the state slot and coded bit in *emission order*:
    [slot0][exp asc][term][mantissa desc][sign], with the e > 9 FFMIN
    caps (slots 10/31 repeat; see module comment).

    Returns (slot int32 [..., K], bit int32 [..., K], valid bool [..., K]).
    """
    v = diff[..., None]
    a = jnp.abs(v)
    e = exponent(jnp.abs(diff))[..., None]
    k = jnp.arange(k_max, dtype=jnp.int32)
    k = jnp.broadcast_to(k, v.shape[:-1] + (k_max,))
    nz = v != 0
    valid = jnp.where(nz, k <= 2 * e + 2, k == 0)
    mant_i = 2 * e + 1 - k                    # for the mantissa span
    slot = jnp.where(k == 0, 0,
           jnp.where(k <= e, jnp.minimum(k, 10),
           jnp.where(k == e + 1, jnp.minimum(e + 1, 10),
           jnp.where(k <= 2 * e + 1, 22 + jnp.minimum(mant_i, 9),
                     11 + jnp.minimum(e, 10)))))
    bit = jnp.where(k == 0, (v == 0).astype(jnp.int32),
          jnp.where(k <= e, 1,
          jnp.where(k == e + 1, 0,
          jnp.where(k <= 2 * e + 1, (a >> jnp.maximum(mant_i, 0)) & 1,
                    (v < 0).astype(jnp.int32)))))
    return (jnp.where(valid, slot, 0).astype(jnp.int32),
            jnp.where(valid, bit, 0), valid)


def repack_emission_order(sv_words, diff, code_bits: int,
                          n_words: int | None = None):
    """Slot-packed sv words -> EMISSION-ORDER byte words.

    sv_words: (..., W, 128) int32 (W = n_sv_words); diff: (..., 128)
    signed per-cell diff.  Output (..., Wk, 128), Wk = n_ev_words: byte
    k of a cell's output stream (word k >> 2, byte k & 3) is the sv
    byte its k-th rac op consumes, so downstream indexing needs only k.
    Shrinks the unsort payload (8 -> 5 words at 8 bit, 11 -> 9 at 16)
    and deletes the expand kernel's slot->word mapping.

    n_words caps Wk below the worst case: the unsort sort's cost is
    ~linear in its payload width and a frame whose max |diff| < 2^(2w-1)
    only ever reads bytes < 4w (event_count <= 4w); callers validate
    max event_count <= 4*n_words from the layout sizes and retry wider
    on miss (the same contract as every other adaptive cap here)."""
    k_max = k_max_for_bits(code_bits)
    Wk = (k_max + 3) // 4
    if n_words is not None:
        Wk = min(Wk, n_words)
    W = sv_words.shape[-2]
    e = exponent(jnp.abs(diff))
    outs = []
    for m in range(Wk):
        acc = jnp.zeros_like(diff)
        for k in range(4 * m, min(4 * m + 4, k_max)):
            if k == 0:
                word = jnp.zeros_like(e)
                shift = jnp.zeros_like(e)
            else:
                mant_i = 2 * e + 1 - k
                slot = jnp.where(
                    k <= e, min(k, 10),
                    jnp.where(k == e + 1, jnp.minimum(e + 1, 10),
                              jnp.where(k <= 2 * e + 1,
                                        22 + jnp.minimum(mant_i, 9),
                                        11 + jnp.minimum(e, 10))))
                if code_bits <= 10:
                    word = slot >> 2
                    shift = (slot & 3) * 8
                else:
                    h10 = jnp.where(k <= e, k - 9, e - 8)
                    h31 = k - e - 1
                    h = jnp.where(slot == 10, jnp.maximum(h10, 1),
                                  jnp.where(slot == 31,
                                            jnp.maximum(h31, 1), 1))
                    j = h - 1
                    word = jnp.where(j == 0, slot >> 2, 8 + (j - 1) // 2)
                    shift = jnp.where(
                        j == 0, (slot & 3) * 8,
                        ((j - 1) % 2) * 16 + jnp.where(slot == 31, 8, 0))
            b = jnp.zeros_like(diff)
            for wi in range(W):
                b = jnp.where(word == wi, sv_words[..., wi, :], b)
            b = (b >> shift) & 0xFF
            acc = acc | (b << ((k & 3) * 8))
        outs.append(acc)
    return jnp.stack(outs, axis=-2)


# ---------------------------------------------------------------------------
# host-side planning: slice header / keyframe / terminator ops
# ---------------------------------------------------------------------------


class RecordingRangeEncoder(RangeEncoder):
    """RangeEncoder that logs the (state value, bit) of every put()."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ops_sv = []
        self.ops_bit = []

    def put(self, states, idx, bit):
        self.ops_sv.append(int(states[idx]))
        self.ops_bit.append(1 if bit else 0)
        super().put(states, idx, bit)


def plan_slice_prefix(p: FFV1Params, ss: SliceState, si: int, rect,
                      keyframe: bool) -> tuple[np.ndarray, np.ndarray]:
    """(sv, bit) ops preceding the plane data in slice si's rac stream:
    the keyframe bit for slice 0 (ffv1enc.c:1203-1211), the in-band
    v0/v1 keyframe header (write_header), and the v3+ slice header
    (encode_slice_header, ffv1enc.c:930-961).

    Table-order contract (mirrors FFV1Encoder.encode): the keyframe bit
    and the v0/v1 header are recorded with the DEFAULT transition
    tables — the custom table only applies from the slice header on
    (the reference installs it after write_header)."""
    c = RecordingRangeEncoder()
    if si == 0:
        key_state = np.array([128], dtype=np.uint8)
        c.put(key_state, 0, 1 if keyframe else 0)
        if keyframe and p.version < 2:
            H.write_v01_header(c, p)
    if p.ac == CODER_RANGE_CUSTOM:
        c.set_state_tables(p.state_transition)
    if p.version > 2:
        H.write_slice_header(c, p, ss, rect)
    return (np.array(c.ops_sv, dtype=np.uint8),
            np.array(c.ops_bit, dtype=np.uint8))


TERMINATOR_SV = 129      # ff_rac_terminate version-1 bit (rangecoder.c:109)


# ---------------------------------------------------------------------------
# scalar oracle (numpy): exact chain walk, for tests
# ---------------------------------------------------------------------------


def oracle_plane_ops(p: FFV1Params, ctx_stream: np.ndarray,
                     pclass_stream: np.ndarray, diff_stream: np.ndarray,
                     states: list[np.ndarray]):
    """Walk one slice's plane data exactly like encode_plane ->
    put_symbol_inline, mutating `states` (per plane-class uint8[ctx][32]).
    Returns (sv uint8[N], bit uint8[N]) in stream order."""
    zero, one = transition_tables(p)
    svs, bits = [], []

    def put(st, slot, b):
        svs.append(st[slot])
        st[slot] = one[st[slot]] if b else zero[st[slot]]
        bits.append(b)

    for ctx, pc, v in zip(ctx_stream, pclass_stream, diff_stream):
        st = states[pc][ctx]
        if v:
            a = abs(int(v))
            e = a.bit_length() - 1
            put(st, 0, 0)
            for i in range(e):
                put(st, 1 + i, 1)
            put(st, 1 + e, 0)
            for i in range(e - 1, -1, -1):
                put(st, 22 + i, (a >> i) & 1)
            put(st, 11 + e, 1 if v < 0 else 0)
        else:
            put(st, 0, 1)
    return np.array(svs, dtype=np.uint8), np.array(bits, dtype=np.uint8)


# ---------------------------------------------------------------------------
# lane/tile layout
# ---------------------------------------------------------------------------
#
# Pixels are grouped by chain row (one stable sort), then each group becomes
# a *lane*; groups longer than GCAP split into GCAP-sized sub-lanes.  Lanes
# are ordered by (length desc, sub-block index asc, #sub-blocks desc) so
#   * lane lengths are non-increasing -> a tile's row count ("cap") is its
#     first lane's length and total cell rows stay ~N/128;
#   * all sub-lanes of split groups sit in a leading region of uniform
#     GCAP-length "buckets" (bucket k = every group's k-th sub-block),
#     padded to 128-lane multiples, so sub-lane k+1 of a group sits exactly
#     BUCKET_W lanes after sub-lane k: the tile processing it runs later in
#     the sequential grid and reads the predecessor's 32 slot states from
#     the carry buffer one fixed tile-stride back.
#
# Cells are laid out tile-major, row-major, 128 lanes per row:
#   cell(lane, t) = (tile_base_rows[tile] + t) * 128 + lane_in_tile.

GCAP = 4096          # max pixels per lane (sub-lane size for split groups)


def layout_plan(row_local, diff, rows_per_slice: int, slots_cap: int,
                tiles_cap: int, wide: bool = False,
                payload_bits: int = 0):
    """Group-sort + lane/tile layout (group-domain formulation).

    row_local/diff: int32 (n_slices, npix) per-slice coding-order streams;
    row_local is the slice-LOCAL chain row (plane-class offset + context).

    Permutations and broadcasts ride SORTS, small-input SCATTERS and
    associative-scan forward fills; the only pixel-sized gather-like ops are
    one 2-channel sort and one masked scatter. The trick for bringing
    group-level data to pixels without a gather: one SENTINEL record per
    chain row is merged into the pixel sort (key (row<<B)|0 sorts
    immediately before the group's pixels), carries the group's packed lane
    word, and forward-fills over the group's span. Every lane/tile decision
    — bucket ranks, tile caps/bases/predecessors, the slot tables — runs in
    the group domain (G = n_slices*rows_per_slice, ~1e5) and the tile domain
    (~1e3). The produced layout is identical to the original pixel-domain
    formulation (rules in the module docstring): buckets of GCAP sub-lanes
    ordered (sub-block asc, n_sb desc, group asc) on fresh tiles, then whole
    groups ordered (length desc, group asc) packed 128 per tile.
    """
    i32 = jnp.int32
    S, npix = row_local.shape
    G = S * rows_per_slice
    M = npix + rows_per_slice                 # merged pixels + sentinels
    RB = max(int(rows_per_slice - 1).bit_length(), 1)
    B = max(int(npix).bit_length(), 1)
    drop = jnp.iinfo(i32).max
    nsb_cap = npix // GCAP + 2
    pidx = jnp.arange(npix, dtype=i32)[None, :]
    gq = jnp.arange(rows_per_slice, dtype=i32)[None, :]
    diff_m = jnp.concatenate(
        [diff, jnp.zeros((S, rows_per_slice), i32)], axis=1)

    if RB + B <= 31:
        key = jnp.concatenate(
            [(row_local << B) | (pidx + 1),
             jnp.broadcast_to(gq << B, (S, rows_per_slice))], axis=1)
        key, diff_s = jax.lax.sort((key, diff_m), num_keys=1,
                                   dimension=1)          # keys unique
        row_s = key >> B
        sidx = key & ((1 << B) - 1)
    else:
        rows_m = jnp.concatenate(
            [row_local, jnp.broadcast_to(gq, (S, rows_per_slice))], axis=1)
        sidx_m = jnp.concatenate(
            [jnp.broadcast_to(pidx + 1, row_local.shape),
             jnp.zeros((S, rows_per_slice), i32)], axis=1)
        row_s, sidx, diff_s = jax.lax.sort(
            (rows_m, sidx_m, diff_m), num_keys=2, dimension=1)
    is_sent = sidx == 0
    idx_s = sidx - 1                                  # pixel stream index
    pidx2 = jnp.arange(M, dtype=i32)[None, :]
    st = jax.lax.cummax(jnp.where(is_sent, pidx2, -1), axis=1)
    r = pidx2 - st - 1                                # rank within group
    # per-(slice, chain row) group sizes WITHOUT a pixel-sized scatter:
    # compact the sentinel sorted positions per slice — every chain row
    # has exactly one sentinel and sentinels sort in chain-row order, so
    # slice s's k-th compacted entry IS group (s, k)'s start; sizes are
    # adjacent differences.
    # sentinel positions are already ascending per slice AND ascending
    # in chain row (key (row<<B)|0), so compacting the masked positions
    # is a ONE-operand sort (the values are the payload)
    spos = jax.lax.sort(jnp.where(is_sent, pidx2, drop),
                        dimension=1)[:, :rows_per_slice]
    nxt_spos = jnp.concatenate(
        [spos[:, 1:], jnp.full((S, 1), M, i32)], axis=1)
    size_g = nxt_spos - spos - 1

    # ---- group-domain class ordering ---------------------------------------
    # buckets (split groups + exact-GCAP groups) by (n_sb desc, group asc),
    # then whole groups by (size desc, group asc); empty groups sort last
    size_f = size_g.reshape(-1)
    nsb = (size_f + GCAP - 1) // GCAP                 # 0 for empty groups
    is_bucket = (nsb > 1) | (size_f == GCAP)
    ckey = jnp.where(is_bucket, -nsb, (1 << 30) + (GCAP - size_f))
    ckey_s, g_sorted, nsb_sorted, size_sorted = jax.lax.sort(
        (ckey, jnp.arange(G, dtype=i32), nsb, size_f),
        num_keys=1, is_stable=True)
    isb_sorted = ckey_s < 0
    Mb = jnp.sum(isb_sorted.astype(i32))              # bucket group count
    rank_sorted = jnp.arange(G, dtype=i32) - jnp.where(isb_sorted, 0, Mb)

    # bucket k = the k-th GCAP sub-lane of every group with n_sb > k
    # (k = 0 additionally holds the exact-GCAP groups); membership counts
    # come straight off the sorted class keys
    kk = jnp.arange(nsb_cap, dtype=i32)
    Mk = jnp.searchsorted(ckey_s, -kk, side="left").astype(i32)
    ntiles_k = -(-Mk // 128)                          # buckets pad to tiles
    base_k = jnp.cumsum(ntiles_k) - ntiles_k          # bucket k's first tile
    n_bucket_tiles = jnp.sum(ntiles_k)
    n_nonempty_norm = (jnp.searchsorted(
        ckey_s, (1 << 30) + GCAP, side="left").astype(i32) - Mb)

    # ---- tile tables (tile domain) ------------------------------------------
    T = jnp.arange(tiles_cap, dtype=i32)
    isbt = T < n_bucket_tiles
    k_of_T = jnp.clip(jnp.searchsorted(base_k, T, side="right") - 1,
                      0, nsb_cap - 1)
    nidx = Mb + 128 * (T - n_bucket_tiles)
    ncap = jnp.where((nidx >= Mb) & (nidx < G),
                     jnp.take(size_sorted, jnp.clip(nidx, 0, G - 1)), 0)
    tile_caps = jnp.where(isbt, GCAP, ncap)
    tile_bases = jnp.cumsum(tile_caps) - tile_caps
    prev_base = jnp.take(base_k, jnp.maximum(k_of_T - 1, 0))
    tile_pred = jnp.where(isbt & (k_of_T > 0),
                          T - (jnp.take(base_k, k_of_T) - prev_base), -1)

    # ---- slot-indexed lane tables --------------------------------------------
    # sb = 0 lane of every group: one group-domain scatter
    slot0 = jnp.where(isb_sorted, rank_sorted,
                      n_bucket_tiles * 128 + rank_sorted)
    last0 = ((nsb_sorted == 1) & (size_sorted > 0)).astype(i32)
    lane_packed0 = (g_sorted << 2) | last0
    lane_tab = jnp.zeros(slots_cap, i32).at[
        jnp.where(slot0 < slots_cap, slot0, drop)].set(
        lane_packed0, mode="drop", unique_indices=True)
    # sub-lanes k >= 1 exist only for split groups — a prefix of the class
    # ordering, so a tiny (split_cap, nsb_cap) grid covers them all
    split_cap = min(S * npix // GCAP + 2, G)
    sg = g_sorted[:split_cap]
    snsb = nsb_sorted[:split_cap]
    ks = jnp.arange(1, nsb_cap, dtype=i32)[None, :]
    validk = ks < snsb[:, None]
    slotk = (jnp.take(base_k, jnp.arange(1, nsb_cap))[None, :] * 128
             + jnp.arange(split_cap, dtype=i32)[:, None])
    lastk = (ks == snsb[:, None] - 1).astype(i32)
    packedk = (sg[:, None] << 2) | 2 | lastk
    lane_tab = lane_tab.at[
        jnp.where(validk & (slotk < slots_cap), slotk, drop)].set(
        packedk, mode="drop", unique_indices=True)

    # ---- per-pixel destinations (sorted order, gather-free) ------------------
    # per-group lane word: bucket -> (rank << 1) | 1; whole group -> its
    # sb=0 lane's cell0 = row_base*128 + lane (tile bases in the bucket
    # prefix are uniform GCAP*tile, so bucket pixels reconstruct their
    # cell from rank + sub-block index alone)
    norm_tile = jnp.clip(n_bucket_tiles + (rank_sorted >> 7), 0,
                         tiles_cap - 1)
    cell0 = jnp.take(tile_bases, norm_tile) * 128 + (rank_sorted & 127)
    wprime = jnp.where(isb_sorted, (rank_sorted << 1) | 1, cell0 << 1)
    w_tab = jnp.zeros(G, i32).at[g_sorted].set(wprime,
                                               unique_indices=True)
    # deliver via the group's sentinel + a forward fill (no pixel gather)
    sent_at = (jnp.arange(S, dtype=i32)[:, None] * M + spos).reshape(-1)
    wfill = jnp.full(S * M, -1, i32).at[sent_at].set(
        w_tab, mode="drop", unique_indices=True).reshape(S, M)
    wfill = jax.lax.associative_scan(
        lambda a, b: jnp.where(b < 0, a, b), wfill, axis=1)

    sb = r // GCAP
    t2 = r - sb * GCAP
    if nsb_cap <= 48:                    # tiny static unroll, fused
        bk = jnp.zeros_like(sb)
        for k in range(1, nsb_cap):
            bk = jnp.where(sb == k, base_k[k], bk)
    else:                                # few-slice frames: one gather
        bk = jnp.take(base_k, jnp.clip(sb, 0, nsb_cap - 1))
    v = wfill >> 1
    dest_b = (GCAP * (bk + (v >> 7)) + t2) * 128 + (v & 127)
    dest = jnp.where(is_sent, drop,
                     jnp.where((wfill & 1) == 1, dest_b, v + r * 128))
    # cell channel: biased diff + pixel-valid flag ("wide" = the valid
    # bit position, 16 for coding depths 11..16, 17 for depth 17).
    # payload_bits > 0: ``diff`` already carries an encoded payload
    # (e.g. the rice walk's diff+2048 | silent<<12); only the valid
    # flag is added.
    if payload_bits:
        ch1 = diff_s | ((~is_sent).astype(i32) << payload_bits)
    elif wide:
        wb = int(wide) if int(wide) > 1 else 16
        ch1 = (diff_s + (1 << (wb - 1))) | ((~is_sent).astype(i32) << wb)
    else:
        ch1 = (diff_s + 2048) | ((~is_sent).astype(i32) << 13)
    orig = jnp.where(is_sent, drop,
                     jnp.arange(S, dtype=i32)[:, None] * npix + idx_s)

    return dict(ch1=ch1.reshape(-1), orig=orig.reshape(-1),
                dest=dest.reshape(-1),
                tile_caps=tile_caps, tile_bases=tile_bases,
                tile_pred=tile_pred, lane_rows=lane_tab >> 2,
                lane_cont=(lane_tab >> 1) & 1, lane_last=lane_tab & 1,
                n_rows=jnp.sum(tile_caps),
                n_tiles=(n_bucket_tiles
                         + -(-jnp.maximum(n_nonempty_norm, 0) // 128)),
                n_slots=n_bucket_tiles * 128 + n_nonempty_norm)


def scatter_cells(plan, cellrows_cap: int):
    """Scatter the two cell channels into the tile-major layout.

    ch2 holds each cell's stream index (empty cells = int32 max) — it
    doubles as the sort key of the post-adapt unsort, so the pipeline
    does not scatter `orig` a second time."""
    cells = cellrows_cap * 128
    drop = jnp.iinfo(jnp.int32).max
    ch1 = jnp.zeros(cells, jnp.int32).at[plan["dest"]].set(
        plan["ch1"], mode="drop", unique_indices=True)
    ch2 = jnp.full(cells, drop, jnp.int32).at[plan["dest"]].set(
        plan["orig"], mode="drop", unique_indices=True)
    return ch1.reshape(cellrows_cap, 128), ch2.reshape(cellrows_cap, 128)


# ---------------------------------------------------------------------------
# adapt walk — plain XLA reference; adapt_pallas.py is its GPU kernel
# ---------------------------------------------------------------------------
#
# The 32 slot states live as rows in PERMUTED order: row r holds slot
# 4*(r&7) + (r>>3).  Then the sv output packs into the 8 int32 words the
# op assembly wants (word j = slots 4j..4j+3, bytes LE) with three
# contiguous row-block shifts — no int8 transpose anywhere:
#   words = sv[0:8] | sv[8:16]<<8 | sv[16:24]<<16 | sv[24:32]<<24

SLOT_AT_ROW = np.array([4 * (r & 7) + (r >> 3) for r in range(32)],
                       dtype=np.int32)
ROW_OF_SLOT = np.array([8 * (s & 3) + (s >> 2) for s in range(32)],
                       dtype=np.int32)


def pack_sv_words(sv_perm):
    """(..., 32, 128) permuted-row sv bytes -> (..., 8, 128) int32 words."""
    return (sv_perm[..., 0:8, :]
            | (sv_perm[..., 8:16, :] << 8)
            | (sv_perm[..., 16:24, :] << 16)
            | (sv_perm[..., 24:32, :] << 24))


def adapt_reference(ch1_cells, tile_caps, tile_bases, tile_pred,
                    s0_blocks, packed_table, tiles_cap: int,
                    code_bits: int = 10):
    """Row-scan reference of the adapt kernel (the CPU path).

    ch1_cells: (CELLROWS, 128) int32 cell channel; s0_blocks:
    (TILES_CAP, 33, 128) int32 — 32 PERMUTED slot-state rows (see
    SLOT_AT_ROW) plus row 32 = per-lane continuation flag.  Returns
    (sv_words (CELLROWS, 8, 128) int32 packed pre-update state values,
    end_states (TILES_CAP, 32, 128) int32 in permuted row order — each
    tile's lane states after its last row; for split groups these carry
    to the successor tile).

    The kernel (adapt_pallas) has the same semantics: rows scan
    sequentially; at a tile's base row the previous tile's states flush
    to the carry buffer and the new tile loads s0 (or carry[pred] for
    continuation lanes).  A lane's state freezes after its last valid
    pixel, so the tile-end state IS the lane/group end state.
    """
    cellrows = ch1_cells.shape[0]
    i32 = jnp.int32
    R = max(0, code_bits - 10)

    starts = jnp.full(cellrows, -1, i32)
    tidx = jnp.arange(tiles_cap, dtype=i32)
    valid_tile = tile_caps > 0
    starts = starts.at[jnp.where(valid_tile, tile_bases, cellrows)].set(
        jnp.where(valid_tile, tidx, -1), mode="drop")

    table = jnp.broadcast_to(packed_table, (32, 128))

    def flush(carrybuf, cur_tile, s, do):
        # branch-free (conditionals would trip shard_map's varying-axes
        # typing): write the slot unconditionally but re-write the old
        # content when disabled
        t = jnp.maximum(cur_tile, 0)
        old = jax.lax.dynamic_slice(carrybuf, (t, 0, 0), (1, 32, 128))[0]
        newv = jnp.where(do & (cur_tile >= 0), s, old)
        return jax.lax.dynamic_update_slice(carrybuf, newv[None], (t, 0, 0))

    def step(carry, xs):
        s, cur_tile, carrybuf = carry
        row, tile_here = xs
        is_start = tile_here >= 0
        carrybuf = flush(carrybuf, cur_tile, s, is_start)

        t = jnp.maximum(tile_here, 0)
        blk = jax.lax.dynamic_slice(s0_blocks, (t, 0, 0), (1, 33, 128))[0]
        pr = tile_pred[t]
        prblk = jax.lax.dynamic_slice(
            carrybuf, (jnp.maximum(pr, 0), 0, 0), (1, 32, 128))[0]
        cont = (blk[32:33] > 0) & (pr >= 0)
        loaded = jnp.where(cont, prblk, blk[:32])
        s = jnp.where(is_start, loaded, s)
        cur_tile = jnp.where(is_start, tile_here, cur_tile)

        if code_bits > 10:
            _m, _b, _vb = payload_field(code_bits)
            v = (row & _m) - _b
            valid_px = ((row >> _vb) & 1) == 1
        else:
            v = (row & 0xFFF) - 2048
            valid_px = ((row >> 13) & 1) == 1
        valid, bit = slot_bit_grid(v)            # (128, 32) standard order
        valid = (valid & valid_px[:, None])[:, SLOT_AT_ROW].transpose(1, 0)
        bit = bit[:, SLOT_AT_ROW].transpose(1, 0)
        sv = jnp.where(valid, s, 0)
        idx9 = jnp.where(bit != 0, 256 + s, s)
        ns = lookup_packed(table, idx9)
        s = jnp.where(valid, ns, s)
        out = pack_sv_words(sv)
        if R > 0:
            # repeat hits of slots 10/31 (e > 9): sub-step j handles hit
            # j+1 of each; the pre-update sv pair packs 2 pairs per word
            e = exponent(jnp.abs(v))              # (128,)
            a = jnp.abs(v)
            r18 = ROW_OF_SLOT[10]                 # permuted row of slot 10
            pairs = []
            for j in range(1, R + 1):
                v10 = valid_px & (e >= 9 + j)
                v31 = valid_px & (e >= 10 + j)
                b10 = (e >= j + 10).astype(i32)
                b31 = (a >> jnp.maximum(e - 1 - j, 0)) & 1
                sv10 = jnp.where(v10, s[r18], 0)
                sv31 = jnp.where(v31, s[31], 0)
                pairs.append(sv10 | (sv31 << 8))
                s = s.at[r18].set(jnp.where(
                    v10, lookup_packed(table[:1], b10[None] * 256
                                       + s[r18][None])[0], s[r18]))
                s = s.at[31].set(jnp.where(
                    v31, lookup_packed(table[:1], b31[None] * 256
                                       + s[31][None])[0], s[31]))
            if len(pairs) % 2:
                pairs.append(jnp.zeros_like(pairs[0]))
            ext = jnp.stack([pairs[2 * w] | (pairs[2 * w + 1] << 16)
                             for w in range(len(pairs) // 2)])
            out = jnp.concatenate([out, ext], axis=0)
        return (s, cur_tile, carrybuf), out

    s_init = jnp.full((32, 128), 128, i32)
    carrybuf = jnp.zeros((tiles_cap, 32, 128), i32)
    (s, cur_tile, carrybuf), sv_cells = jax.lax.scan(
        step, (s_init, -1, carrybuf), (ch1_cells, starts))
    carrybuf = flush(carrybuf, cur_tile, s, jnp.bool_(True))
    return sv_cells, carrybuf


def build_s0_blocks(plan, canonical, tiles_cap: int):
    """(TILES_CAP, 33, 128) int32 start-state blocks from the canonical
    per-chain state table ((rows, 32) uint8): slot rows in SLOT_AT_ROW
    order, row 32 = continuation flag."""
    rows = plan["lane_rows"].reshape(tiles_cap, 128)
    cont = plan["lane_cont"].reshape(tiles_cap, 128)
    perm = canonical.astype(jnp.int32)[:, jnp.asarray(SLOT_AT_ROW)]
    s0 = jnp.take(perm, rows, axis=0)                          # (T,128,32)
    s0 = s0.transpose(0, 2, 1)                                 # (T,32,128)
    return jnp.concatenate([s0, cont[:, None, :]], axis=1)


def writeback_canonical(plan, canonical, end_states, tiles_cap: int):
    """Store group-end states back into the canonical table for the next
    (inter) frame; only lanes holding their group's last sub-block write.
    end_states rows are in SLOT_AT_ROW order; un-permute on the way out."""
    rows = plan["lane_rows"].reshape(tiles_cap * 128)
    last = plan["lane_last"].reshape(tiles_cap * 128) > 0
    ends = end_states[:, jnp.asarray(ROW_OF_SLOT), :]
    ends = ends.transpose(0, 2, 1).reshape(tiles_cap * 128, 32)
    tgt = jnp.where(last, rows, jnp.iinfo(jnp.int32).max)
    return canonical.at[tgt].set(ends.astype(jnp.uint8), mode="drop",
                                 unique_indices=True)


# ---------------------------------------------------------------------------
# masked-stream compaction (XLA log-shift merge)
# ---------------------------------------------------------------------------


def shift_compact_packed(packed, out_len: int, data_bits: int = 9):
    """Stable left-compaction of ONE packed int32 channel along axis -1.

    Layout: bits [31:data_bits+1] = move distance delta (monotone over
    valid elements, delta <= index, so the log-shift passes never
    collide), bit data_bits = valid, bits [data_bits-1:0] = payload;
    invalid slots are all-zero.  Same algorithm as shift_compact, but
    one fused array moves a fraction of the multi-array bytes per pass.
    Requires the source length < 2^(31-data_bits-1)."""
    m = packed.shape[-1]
    vb = data_bits
    db = vb + 1
    # the final log-shift pass moves by up to 2^(nbits-1) <= m, so the
    # shifted delta field (starting at bit db) must keep step<<db < 2^31
    assert m < (1 << (31 - vb - 1)), \
        "delta field overflow; use shift_compact"
    nbits = max(1, int(m - 1).bit_length())
    for b in range(nbits):
        step = 1 << b
        sh = jnp.concatenate(
            [packed[..., step:],
             jnp.zeros(packed.shape[:-1] + (step,), packed.dtype)],
            axis=-1)
        move_in = ((sh >> vb) & 1 & (sh >> (db + b))) == 1
        move_out = ((packed >> vb) & 1 & (packed >> (db + b))) == 1
        packed = jnp.where(move_in, sh - (step << db),
                           jnp.where(move_out, 0, packed))
    if m >= out_len:
        return packed[..., :out_len]
    return jnp.concatenate(
        [packed, jnp.zeros(packed.shape[:-1] + (out_len - m,),
                           packed.dtype)], axis=-1)


def shift_compact(channels, valid, dest, out_len: int):
    """Stable left-compaction along axis -1.

    channels: list of (..., M) int32; valid: (..., M) bool; dest: (..., M)
    int32 target index (strictly increasing over valid elements per row,
    dest <= index).  Returns list of (..., out_len) with invalid slots 0.

    Log-shift algorithm: process delta bits low to high; with monotone
    destinations the partial shifts never collide (order-preserving:
    masked-delta differences are bounded by index differences).
    """
    m = channels[0].shape[-1]
    idx = jnp.arange(m, dtype=jnp.int32)
    delta = jnp.where(valid, idx - dest, 0)
    arrs = [jnp.where(valid, c, 0) for c in channels]
    val = valid
    nbits = max(1, int(m - 1).bit_length())
    for b in range(nbits):
        step = 1 << b
        move = val & (((delta >> b) & 1) == 1)

        def shl(a, fill=0):
            pad = jnp.full(a.shape[:-1] + (step,), fill, a.dtype)
            return jnp.concatenate([a[..., step:], pad], axis=-1)

        move_in = shl(move, False)
        arrs = [jnp.where(move_in, shl(a), jnp.where(move, 0, a))
                for a in arrs]
        delta = jnp.where(move_in, shl(delta) - step,
                          jnp.where(move, 0, delta))
        val = jnp.where(move_in, True, val & ~move)

    def fit(a, fill):
        if m >= out_len:
            return a[..., :out_len]
        pad = jnp.full(a.shape[:-1] + (out_len - m,), fill, a.dtype)
        return jnp.concatenate([a, pad], axis=-1)

    return [fit(a, 0) for a in arrs], fit(val, False)


# ---------------------------------------------------------------------------
# full-device encoder session
# ---------------------------------------------------------------------------

MODE_NOP, MODE_OP, MODE_FLUSH1, MODE_FLUSH2 = 0, 1, 2, 3
OP_GRAN = 4096           # op_cap rung granularity (quantize_cap gran)


def expand_ops_reference(words_n, diff, svp, btp, hlen, op_cap: int,
                         code_bits: int):
    """Op expansion: per-pixel EMISSION-ORDER sv words (stream order,
    from the unsort) -> the packed compacted op stream per slice.

    words_n: W arrays (S, npix) packed sv words (op k of a pixel reads
    byte k); diff: (S, npix); svp/btp/hlen: the host-planned prefix ops
    (slice headers, keyframe bit).  Each slice's stream is [prefix ops,
    NOPs up to hpad][pixel ops][v1 terminator (state 129, bit 0;
    rangecoder.c:109-123)][FLUSH1][FLUSH2][NOPs].  Returns (opw (S,
    op_cap) int32 [mode:2 | bit:1 | sv:8] at bits [10:9], [8], [7:0];
    n_ops (S,) = coded steps incl. the terminator and flushes)."""
    i32 = jnp.int32
    S, npix = diff.shape
    hpad = int(svp.shape[1])
    k_max = k_max_for_bits(code_bits)
    slot, bit, valid = emission_slots(diff, k_max)
    kg = jnp.arange(k_max, dtype=i32)[None, None, :]
    wsel, shf = kg >> 2, (kg & 3) * 8
    wsel = jnp.broadcast_to(wsel, slot.shape)
    shf = jnp.broadcast_to(shf, slot.shape)
    sv = jnp.zeros_like(slot)
    for j in range(len(words_n)):
        sv = jnp.where(wsel == j, words_n[j][..., None], sv)
    sv = (sv >> shf) & 0xFF

    counts = event_count(diff)
    koff = jnp.cumsum(counts, axis=1)
    total = hpad + koff[:, -1]
    off = (hpad + (koff - counts)[..., None]
           + jnp.arange(k_max, dtype=i32)[None, None, :])

    def lpad(a, fill=0):
        return jnp.concatenate(
            [jnp.full((S, hpad), fill, a.dtype),
             a.reshape(S, -1)], axis=1)

    (sv_c, bit_c), valid_c = shift_compact(
        [lpad(sv), lpad(bit)], lpad(valid, False), lpad(off), op_cap)

    pos = jnp.arange(op_cap, dtype=i32)[None, :]
    in_hdr = pos < hlen[:, None]
    hsv = jnp.pad(svp, ((0, 0), (0, max(0, op_cap - hpad))))[:, :op_cap]
    hbt = jnp.pad(btp, ((0, 0), (0, max(0, op_cap - hpad))))[:, :op_cap]
    sv_c = jnp.where(in_hdr, hsv, sv_c)
    bit_c = jnp.where(in_hdr, hbt, bit_c)
    term = pos == total[:, None]
    sv_c = jnp.where(term, TERMINATOR_SV, sv_c)
    bit_c = jnp.where(term, 0, bit_c)
    mode = jnp.where(in_hdr | (valid_c & (pos >= hpad)) | term, MODE_OP,
                     jnp.where(pos == total[:, None] + 1, MODE_FLUSH1,
                               jnp.where(pos == total[:, None] + 2,
                                         MODE_FLUSH2, MODE_NOP)))
    opw = jnp.where(mode == MODE_OP, (sv_c & 0xFF) | (bit_c << 8), 0) \
        | (mode << 9)
    return opw, total + 3


class DeviceFFV1Encoder:
    """FFV1 encode with phase A *and* phase B on the device.

    Covers versions 0/1/3/4, range (ac 1/2) + golomb-rice coders,
    YUV/gray at depths 8..16, RGB/RCT (incl. the v4 per-slice RCT
    search) at every depth up to 16 bpc (rgb48: int32 sample ring,
    17-bit coding depth, 17-bit cell payload field), 2-pass custom
    initial states, and non-uniform slice geometries (via per-shape
    banks).  Golomb-rice above 8 bits is forced to the range coder by
    the format itself (ffv1enc.c:702-708; the 16-bit payload field is
    in place should custom params ever carry it).  How each stage runs
    (jitted, kernel or plain XLA) follows the platform:
    accel.stage_plan.
    """

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None,
                 params: FFV1Params | None = None, slice_subset=None):
        """params overrides the config-derived FFV1Params — the 2-pass
        flow (twopass.apply_pass2) hands a params object carrying the
        sorted state-transition table and per-context initial states
        (ffv1enc.c:793-873); both flow into the packed transition table
        and the keyframe canonical below.

        slice_subset (internal): restrict this instance to the given
        GLOBAL slice indices.  Non-uniform geometries (odd frame sizes
        where the floor/ceil slice boundaries differ, e.g. FATE's 34x34
        chroma at 2x2 slices — ff_ffv1_init_slice_contexts, ffv1.c:117)
        are handled by partitioning the slices into uniform-shape
        groups ("banks"), one pipeline per shape, and assembling the
        packet in global slice order."""
        self.cfg = config or FFV1Config()
        if params is not None:
            p = self.p = params
        else:
            p = self.p = params_from_config(self.cfg, pix_fmt, width,
                                            height)
        if p.version == 2:
            raise NotImplementedError(
                "device coder: versions 0/1/3/4 (v2's in-band slice "
                "table is a deprecated transitional layout)")
        # version-4 RGB runs the per-slice RCT coefficient search on
        # device (15-candidate L1 reduction, ffv1enc.c:963-1043) and
        # re-plans the slice-header prefixes per frame (the chosen
        # coefficients are coded in the header)
        self._v4rgb = p.version > 3 and p.colorspace == 1
        self._rct_prefix_cache = {}
        self.golomb = p.ac == CODER_GOLOMB
        if self.golomb and self._v4rgb:
            raise NotImplementedError(
                "device rice + version-4 RGB: the per-slice RCT search "
                "re-plans the static rice headers per frame; use "
                "version <= 3 (the FATE configuration) or the range "
                "coder")
        # RGB codes the RCT planes at depth bits+1 (lbd path,
        # ffv1enc_template.c:193); depths 11..16 take the slot-repeat
        # sub-step path (R = depth-10 extra masked steps per pixel)
        self.code_bits = max(p.bits, 8) + 1 if p.colorspace == 1 else p.bits
        # rice cell payload: 12-bit diff field for coding depths <= 12,
        # 16-bit for 13..16 (silent flag at pb, layout valid flag at
        # pb+1).  RGB rice (FATE's bgr0 default-coder config,
        # vcodec.mak:179, ffv1enc.c:563) codes at bits+1 like the range
        # path; its single run-index ladder spans the line-interleaved
        # stream (ffv1enc_template.c:138 resets once per slice, vs
        # encode_plane's per-plane reset, ffv1enc.c:280)
        self._rice_pb = 12 if self.code_bits <= 12 else 16
        if self.code_bits > 17:
            raise NotImplementedError("device coder: coding depth <= 17")
        if p.initial_states is not None and self.golomb:
            raise NotImplementedError("initial states are a range-coder "
                                      "feature")
        self.plan = stage_plan()
        self.k_max = k_max_for_bits(self.code_bits)

        # crop plan (one rect per (plane, slice)); the pipeline's batched
        # stream layout needs uniform shapes, so non-uniform geometries
        # split into shape banks
        from .tpu_encoder import TPUFFV1Encoder
        from .tpu import lut_for
        shell = TPUFFV1Encoder.__new__(TPUFFV1Encoder)
        shell.p = p
        full_plan = TPUFFV1Encoder._build_plan(shell)
        self._banks = None
        if slice_subset is None:
            sig = [tuple((prects[si][2], prects[si][3])
                         for prects in full_plan)
                   for si in range(p.slice_count)]
            groups = {}
            for si in range(p.slice_count):
                groups.setdefault(sig[si], []).append(si)
            if len(groups) > 1:
                self._banks = [
                    DeviceFFV1Encoder(width, height, pix_fmt, self.cfg,
                                      params=p, slice_subset=g)
                    for g in groups.values()]
                self.extradata = self._banks[0].extradata
                self.picture_number = 0
                return
            self.slice_ids = list(range(p.slice_count))
        else:
            self.slice_ids = list(slice_subset)
        self.S = len(self.slice_ids)
        self.crop_plan = [[prects[si] for si in self.slice_ids]
                          for prects in full_plan]
        self.qt = lut_for(p, p.context_model)
        self.five = bool(p.quant_tables[p.context_model][3][127]
                         or p.quant_tables[p.context_model][4][127])

        # stream structure: YUV concatenates whole planes per slice;
        # RGB interleaves per line (g,b,r[,a] rows alternate —
        # ffv1enc_template.c:188-198); bank = (plane+1)//2 in both
        n_planes = len(self.crop_plan)
        self.plane_sizes = [prects[0][2] * prects[0][3]
                            for prects in self.crop_plan]
        self.npix = int(np.sum(self.plane_sizes))
        if p.colorspace == 1:
            sw, sh = self.crop_plan[0][0][2], self.crop_plan[0][0][3]
            pclass = np.tile(np.repeat(
                np.array([(li + 1) // 2 for li in range(n_planes)],
                         np.int32), sw), sh)
        else:
            pclass = np.concatenate([
                np.full(sz, (li + 1) // 2, np.int32)
                for li, sz in enumerate(self.plane_sizes)])
        ss = SliceState(p)
        self.class_counts = ss.plane_ctx_count        # per plane_count
        class_off = np.zeros(p.plane_count, np.int32)
        class_off[1:] = np.cumsum(self.class_counts[:-1])
        self.rows_per_slice = int(np.sum(self.class_counts))
        self.class_off_stream = class_off[pclass]     # (npix,) int32

        n = self.S * self.npix
        self.n = n
        self.n_chain_rows = self.S * self.rows_per_slice
        # worst-case bounds: bucket k = the k-th GCAP-sub-lane of every
        # split group; up to npix/GCAP + 1 buckets, and each bucket's
        # final partial tile can cost a full GCAP of rows on its own
        n_buckets = self.npix // GCAP + 2
        self.tiles_max = (n // GCAP + 2 * n_buckets
                          + self.n_chain_rows // 128 + 8)
        self.cellrows_max = (n // 128 + (n_buckets + 2) * GCAP
                             + self.tiles_max + 128)
        # adaptive working sizes: start at a content-typical estimate and
        # grow on overflow (detected from the layout's actual sizes at
        # the existing per-frame sync); every downstream static domain —
        # especially the cell-space unsort — scales with these.  All
        # values sit on quantize_cap rungs so adaptation lands on a
        # small shared set of compiled shapes.
        self.tiles_cap = quantize_cap(
            n // GCAP + self.n_chain_rows // 128 + 72, self.tiles_max)
        self.cellrows_cap = quantize_cap(
            n // 128 * 5 // 4 + 2 * GCAP + 256, self.cellrows_max)
        # unsort domain: real cells are a dense prefix of the cell
        # buffer (tile_bases = cumsum of caps); the payload sort only
        # needs n_rows, not the DMA slack, so it gets a tighter cap
        self.sortrows_cap = min(self.cellrows_cap,
                                quantize_cap(n // 128 * 9 // 8 + 1024,
                                             self.cellrows_max))

        self.table = packed_transition_table(p)
        # keyframe canonical: 128 everywhere, or the 2-pass per-context
        # initial states (ff_ffv1_clear_slice_state, ffv1.c:70-84)
        ck = np.full((self.rows_per_slice, 32), 128, np.uint8)
        if p.initial_states is not None:
            off = 0
            ssk = SliceState(p)
            for i in range(p.plane_count):
                cnt = int(self.class_counts[i])
                init = p.initial_states[ssk.plane_qt_index[i]]
                if init is not None:
                    ck[off:off + cnt] = np.asarray(init, np.uint8)[:cnt]
                off += cnt
        full = np.full((self.n_chain_rows + 1, 32), 128, np.uint8)
        full[:self.n_chain_rows] = np.tile(ck, (self.S, 1))
        self._canonical_key1 = ck                 # one slice's worth
        self.canonical_key = jnp.asarray(full)
        self.canonical = self.canonical_key
        self.extradata = (H.write_extradata(p) if p.version > 1 else b"")

        # host-planned per-slice prefixes (constant per keyframe flag)
        rects = p.rects()
        self.prefix = {}
        for key in (True, False):
            svs, bits = [], []
            for si in self.slice_ids:
                sv, bit = plan_slice_prefix(p, SliceState(p), si, rects[si],
                                            key)
                svs.append(sv)
                bits.append(bit)
            hmax = max(len(s) for s in svs)
            svp = np.zeros((self.S, hmax), np.int32)
            btp = np.zeros((self.S, hmax), np.int32)
            for si, (s, b) in enumerate(zip(svs, bits)):
                svp[si, :len(s)] = s
                btp[si, :len(b)] = b
            hlen = np.array([len(s) for s in svs], np.int32)
            self.prefix[key] = (jnp.asarray(svp), jnp.asarray(btp),
                                jnp.asarray(hlen))
        if self.golomb:
            # vlc canonical state table (one 4-word row per chain) and
            # host-rendered slice headers: the golomb slice's rac
            # TERMINATES after the header (encoder.py:80-83), so the
            # header bytes are static per (keyframe, slice)
            from .device_rice import VLC_INIT
            self.vcanon = jnp.asarray(
                np.tile(VLC_INIT, (self.n_chain_rows + 1, 1)))
            self.rice_headers = {}
            for key in (True, False):
                hdrs = []
                for si in self.slice_ids:
                    c = RangeEncoder()
                    if si == 0:
                        key_state = np.array([128], dtype=np.uint8)
                        c.put(key_state, 0, 1 if key else 0)
                        if key and p.version < 2:
                            H.write_v01_header(c, p)
                    if p.version > 2:
                        H.write_slice_header(c, p, SliceState(p),
                                             rects[si])
                    hdrs.append(c.terminate(1 if p.version > 2 else 0))
                self.rice_headers[key] = hdrs
            # adaptive ladder-event and bitstream-word capacities
            nlines = sum(prects[0][3] for prects in self.crop_plan)
            self.ev_cap_max = self.npix + nlines + 8
            self.ev_cap = quantize_cap(self.npix // 4 + 1024,
                                       self.ev_cap_max)
            # worst element: the escape path (11 ones + 1 + bits value
            # bits, vlc_code_word) plus run/ladder elements
            self.nwords_max = (self.npix * 3 * max(25, p.bits + 13)
                               ) // 32 + 8
            self.nwords = quantize_cap(self.npix // 16 * 8 + 256,
                                       self.nwords_max, 8)

        # adaptive per-slice op-stream capacity (like tiles/cellrows):
        # start at a content-typical ~4 ops/pixel, grow on overflow, on
        # OP_GRAN-multiple rungs
        hmax = max(int(self.prefix[k][0].shape[1]) for k in (True, False))
        self.op_cap_max = -(-(self.npix * self.k_max + hmax + 8)
                            // OP_GRAN) * OP_GRAN
        self.op_cap = quantize_cap(self.npix * 4 + hmax + 1024,
                                   self.op_cap_max, OP_GRAN)
        # per-slice rendered-packet capacity (adaptive, like op_cap):
        # each rac op emits at most one staged byte (+ run fills), so
        # op_cap_max + slack bounds any slice; start at ~1 byte/pixel
        self.render_cap_max = self.op_cap_max + 16
        self.render_cap = quantize_cap(self.npix + 4096,
                                       self.render_cap_max, 4096)
        # adaptive unsort payload width (emission-order words carried
        # through the cells->stream sort): 2 words = 8 ops covers
        # |diff| <= 7; grows to the content's true ceil(maxops/4)
        self.unsort_words = min(2, n_ev_words(self.code_bits))
        self._shrinks = 2            # cap-tightening budget (see encode)
        self.picture_number = 0

    # -- jitted pipeline stages --------------------------------------------

    @functools.partial(jax.jit, static_argnames=("self",))
    def _phase_a(self, planes):
        """planes (device) -> per-slice streams (ctx, diff) int32
        (n_slices, npix) in coding order."""
        from .tpu import plane_context_diff, _wrap16
        p = self.p
        if p.colorspace == 1:
            # fixed 1,1 RCT (version <= 3 lbd path), then per-plane
            # modeling at depth bits+1; stream interleaves lines
            # (ffv1enc_template.c:175-198)
            rects = self.crop_plan[0]
            swap = (not p.use32bit and not p.transparency and p.bits > 8)
            order = ((1, 0, 2) if swap else (0, 1, 2)) \
                + ((3,) if p.transparency else ())
            crops = [jnp.stack([
                jax.lax.dynamic_slice(planes[k], (y, x), (h, w))
                for (x, y, w, h) in rects]).astype(jnp.int32)
                for k in order]
            g, b, r = crops[0], crops[1], crops[2]
            offset = 1 << max(p.bits, 8)
            b2 = b - g
            r2 = r - g
            g2 = g + ((b2 + r2) >> 2)
            coded = [g2, b2 + offset, r2 + offset] \
                + ([crops[3]] if p.transparency else [])
            # use32bit (RGB 16 bpc): int32 sample ring, no int16 wrap
            # (codec_py._Row wb=32; ffv1enc_template.c RGB48 path)
            wr = (lambda x: x) if p.use32bit else _wrap16
            fn = functools.partial(plane_context_diff, qt=self.qt,
                                   bits=self.code_bits, five=self.five)
            outs = [jax.vmap(fn)(wr(c)) for c in coded]
            ctx = jnp.stack([c for c, _ in outs], axis=2)
            diff = jnp.stack([d for _, d in outs], axis=2)
            return (ctx.reshape(self.S, -1),
                    diff.reshape(self.S, -1))
        ctx_parts, diff_parts = [], []
        for li, prects in enumerate(self.crop_plan):
            x0, y0, w, h = prects[0][0], prects[0][1], prects[0][2], prects[0][3]
            crops = jnp.stack([
                jax.lax.dynamic_slice(planes[li], (y, x), (h, w))
                for (x, y, w, h) in prects])
            crops = _wrap16(crops.astype(jnp.int32))
            fn = functools.partial(plane_context_diff, qt=self.qt,
                                   bits=p.bits, five=self.five)
            ctx, diff = jax.vmap(fn)(crops)
            ctx_parts.append(ctx.reshape(self.S, -1))
            diff_parts.append(diff.reshape(self.S, -1))
        return (jnp.concatenate(ctx_parts, axis=1),
                jnp.concatenate(diff_parts, axis=1))

    @functools.partial(jax.jit, static_argnames=("self",))
    def _phase_a_rct(self, planes, byc, ryc):
        """RGB phase A with PER-SLICE RCT coefficients (version 4;
        byc/ryc (S,) int32 from the device cost search below).  Same
        stream layout as _phase_a's fixed-1,1 branch."""
        from .tpu import plane_context_diff, _wrap16
        p = self.p
        rects = self.crop_plan[0]
        swap = (not p.use32bit and not p.transparency and p.bits > 8)
        order = ((1, 0, 2) if swap else (0, 1, 2)) \
            + ((3,) if p.transparency else ())
        crops = [jnp.stack([
            jax.lax.dynamic_slice(planes[k], (y, x), (h, w))
            for (x, y, w, h) in rects]).astype(jnp.int32)
            for k in order]
        g, b, r = crops[0], crops[1], crops[2]
        offset = 1 << max(p.bits, 8)
        b2 = b - g
        r2 = r - g
        g2 = g + ((b2 * byc[:, None, None]
                   + r2 * ryc[:, None, None]) >> 2)
        coded = [g2, b2 + offset, r2 + offset] \
            + ([crops[3]] if p.transparency else [])
        wr = (lambda x: x) if p.use32bit else _wrap16
        fn = functools.partial(plane_context_diff, qt=self.qt,
                               bits=self.code_bits, five=self.five)
        outs = [jax.vmap(fn)(wr(c)) for c in coded]
        ctx = jnp.stack([c for c, _ in outs], axis=2)
        diff = jnp.stack([d for _, d in outs], axis=2)
        return (ctx.reshape(self.S, -1), diff.reshape(self.S, -1))

    @functools.partial(jax.jit, static_argnames=("self",))
    def _rct_cost_parts(self, planes):
        """Per-slice per-candidate RCT cost partials (S, 15, hp-1):
        int32 ROW sums of |bg + ((br*ry + bb*by) >> 2)| over the second
        differences (choose_rct_params, ffv1enc.c:963-1043; scalar
        oracle in ffv1/rct.py).  Row-sized partials keep every partial
        within int32; the host combines rows in Python bignum, so the
        total matches the reference's uint64 arithmetic exactly."""
        rects = self.crop_plan[0]
        crops = [jnp.stack([
            jax.lax.dynamic_slice(planes[k], (y, x), (h, w))
            for (x, y, w, h) in rects]).astype(jnp.int32)
            for k in (0, 1, 2)]
        g, b, r = crops

        def hdiff(p_):
            return jnp.concatenate(
                [p_[:, :, :1], p_[:, :, 1:] - p_[:, :, :-1]], axis=2)

        ag, ab, ar = hdiff(g), hdiff(b), hdiff(r)
        bg = ag[:, 1:, 1:] - ag[:, :-1, 1:]
        bb = ab[:, 1:, 1:] - ab[:, :-1, 1:]
        br = ar[:, 1:, 1:] - ar[:, :-1, 1:]
        br = br - bg
        bb = bb - bg
        from .rct import RCT_Y_COEFF
        # per-candidate cost <= ~2^20 at 16 bpc, so int32 partials stay
        # exact only over <= 1024-column spans: chunk the width
        S_, hm, wm = bg.shape
        CW = 1024
        pad = -wm % CW
        if pad:
            z = jnp.zeros((S_, hm, pad), jnp.int32)
            bg, bb, br = (jnp.concatenate([a, z], axis=2)
                          for a in (bg, bb, br))
        outs = []
        for (ry, by) in RCT_Y_COEFF:
            cost = jnp.abs(bg + ((br * ry + bb * by) >> 2))
            outs.append(jnp.sum(
                cost.reshape(S_, hm, -1, CW), axis=3).reshape(S_, -1))
        return jnp.stack(outs, axis=1)

    def _pick_rct(self, planes_dev):
        """Device cost reduction + host argmin (first strict minimum,
        matching the reference's `<` scan) -> [(by, ry)] per slice."""
        from .rct import RCT_Y_COEFF
        rects = self.crop_plan[0]
        if rects[0][3] < 2 or rects[0][2] < 2:
            return [(1, 1)] * self.S
        parts = np.asarray(self._rct_cost_parts(planes_dev))
        totals = parts.astype(object).sum(axis=2)     # exact bignum
        out = []
        for li in range(self.S):
            stats = totals[li]
            best = 0
            for i in range(1, len(RCT_Y_COEFF)):
                if stats[i] < stats[best]:
                    best = i
            ry, by = RCT_Y_COEFF[best]
            out.append((by, ry))
        return out

    def _prefix_for_rct(self, keyframe: bool, rct_list):
        """Slice-header prefixes carrying the chosen per-slice RCT
        coefficients; hmax is bucketed to 16 so the downstream window
        jit keeps a stable shape across frames."""
        key = (keyframe, tuple(rct_list))
        hit = self._rct_prefix_cache.get(key)
        if hit is not None:
            return hit
        p = self.p
        rects = p.rects()
        svs, bits = [], []
        for li, si in enumerate(self.slice_ids):
            ss = SliceState(p)
            ss.slice_rct_by, ss.slice_rct_ry = rct_list[li]
            sv, bit = plan_slice_prefix(p, ss, si, rects[si], keyframe)
            svs.append(sv)
            bits.append(bit)
        hmax = -(-max(len(s) for s in svs) // 16) * 16
        svp = np.zeros((self.S, hmax), np.int32)
        btp = np.zeros((self.S, hmax), np.int32)
        for li, (s, b) in enumerate(zip(svs, bits)):
            svp[li, :len(s)] = s
            btp[li, :len(b)] = b
        hlen = np.array([len(s) for s in svs], np.int32)
        val = (jnp.asarray(svp), jnp.asarray(btp), jnp.asarray(hlen))
        if len(self._rct_prefix_cache) > 64:
            self._rct_prefix_cache.clear()
        self._rct_prefix_cache[key] = val
        return val

    @functools.partial(jax.jit, static_argnames=("self",))
    def _phase_a_rice(self, planes):
        """planes -> (ctx (S, npix), rice stream dict of (S, npix)).

        RGB: fixed 1,1 RCT then per-plane run planning at code_bits —
        runs never cross line ends (the encode_line flush,
        ffv1enc_template.c:110-119), so per-plane planning is exact —
        with the streams interleaved per line and ONE run-index ladder
        across the whole interleaved stream (ffv1enc_template.c:138)."""
        from .tpu import plane_context_diff, _wrap16
        from .device_rice import build_rice_streams
        p = self.p
        if p.colorspace == 1:
            rects = self.crop_plan[0]
            swap = (not p.use32bit and not p.transparency and p.bits > 8)
            order = ((1, 0, 2) if swap else (0, 1, 2)) \
                + ((3,) if p.transparency else ())
            crops = [jnp.stack([
                jax.lax.dynamic_slice(planes[k], (y, x), (h, w))
                for (x, y, w, h) in rects]).astype(jnp.int32)
                for k in order]
            g, b, r = crops[0], crops[1], crops[2]
            offset = 1 << max(p.bits, 8)
            b2 = b - g
            r2 = r - g
            g2 = g + ((b2 + r2) >> 2)
            coded = [g2, b2 + offset, r2 + offset] \
                + ([crops[3]] if p.transparency else [])
            wr = (lambda x: x) if p.use32bit else _wrap16
            fn = functools.partial(plane_context_diff, qt=self.qt,
                                   bits=self.code_bits, five=self.five)
            outs = [jax.vmap(fn)(wr(c)) for c in coded]
            ctx_pl = [c for c, _ in outs]
            diff_pl = [d for _, d in outs]
            streams = build_rice_streams(ctx_pl, diff_pl,
                                         pb=self._rice_pb,
                                         interleave=True)
            ctx = jnp.stack(ctx_pl, axis=2).reshape(self.S, -1)
            return ctx, streams
        ctx_pl, diff_pl = [], []
        for li, prects in enumerate(self.crop_plan):
            crops = jnp.stack([
                jax.lax.dynamic_slice(planes[li], (y, x), (h, w))
                for (x, y, w, h) in prects])
            crops = _wrap16(crops.astype(jnp.int32))
            fn = functools.partial(plane_context_diff, qt=self.qt,
                                   bits=p.bits, five=self.five)
            ctx, diff = jax.vmap(fn)(crops)
            ctx_pl.append(ctx)
            diff_pl.append(diff)
        streams = build_rice_streams(ctx_pl, diff_pl, pb=self._rice_pb)
        ctx = jnp.concatenate(
            [c.reshape(self.S, -1) for c in ctx_pl], axis=1)
        return ctx, streams

    # -- golomb-rice pipeline stages ---------------------------------------

    def _s_rice_layout(self, ctx, payload, tiles_cap, cellrows_cap):
        return self._disp(self._s_rice_layout_jit, self._s_rice_layout_impl,
                          ctx, payload, tiles_cap, cellrows_cap)

    @functools.partial(jax.jit, static_argnames=(
        "self", "tiles_cap", "cellrows_cap"))
    def _s_rice_layout_jit(self, ctx, payload, tiles_cap, cellrows_cap):
        return self._s_rice_layout_impl(ctx, payload, tiles_cap,
                                        cellrows_cap)

    def _s_rice_layout_impl(self, ctx, payload, tiles_cap, cellrows_cap):
        row_local = jnp.asarray(self.class_off_stream)[None, :] + ctx
        plan = layout_plan(row_local, payload, self.rows_per_slice,
                           tiles_cap * 128, tiles_cap,
                           payload_bits=self._rice_pb + 1)
        lim = cellrows_cap - 1024
        plan["tile_bases"] = jnp.minimum(plan["tile_bases"], lim)
        plan["tile_caps"] = jnp.minimum(
            plan["tile_caps"], lim - plan["tile_bases"])
        return plan

    def _s_vlc_walk(self, ch1c, plan, vcanon, keyframe, tiles_cap):
        return self._disp(self._s_vlc_walk_jit, self._s_vlc_walk_impl,
                          ch1c, plan, vcanon, keyframe, tiles_cap)

    @functools.partial(jax.jit, static_argnames=(
        "self", "keyframe", "tiles_cap"))
    def _s_vlc_walk_jit(self, ch1c, plan, vcanon, keyframe, tiles_cap):
        return self._s_vlc_walk_impl(ch1c, plan, vcanon, keyframe,
                                     tiles_cap)

    def _s_vlc_walk_impl(self, ch1c, plan, vcanon, keyframe, tiles_cap):
        from .device_rice import (VLC_INIT, build_vlc_s0,
                                  vlc_adapt_reference, writeback_vlc)
        if keyframe:
            vcanon = jnp.broadcast_to(
                jnp.asarray(VLC_INIT)[None, :], vcanon.shape).astype(
                jnp.int32)
        s0 = build_vlc_s0(plan, vcanon, tiles_cap)
        if self.plan.impl("vlc") == "kernel":
            from .device_rice import vlc_adapt_pallas
            code_cells, ends = vlc_adapt_pallas(
                ch1c, plan["tile_caps"], plan["tile_bases"],
                plan["tile_pred"], s0, tiles_cap,
                int(ch1c.shape[0]), self.code_bits)
        else:
            code_cells, ends = vlc_adapt_reference(
                ch1c, plan["tile_caps"], plan["tile_bases"],
                plan["tile_pred"], s0, tiles_cap, self.code_bits)
        vcanon = writeback_vlc(plan, vcanon, ends, tiles_cap)
        psizes = jnp.stack([plan["n_rows"], plan["n_tiles"],
                            plan["n_slots"]])
        return code_cells, vcanon, psizes

    def _s_rice_unsort(self, code_cells, ch2c, n_slices, sortrows_cap):
        return self._disp(self._s_rice_unsort_jit,
                          self._s_rice_unsort_impl,
                          code_cells, ch2c, n_slices, sortrows_cap)

    @functools.partial(jax.jit, static_argnames=(
        "self", "n_slices", "sortrows_cap"))
    def _s_rice_unsort_jit(self, code_cells, ch2c, n_slices,
                           sortrows_cap):
        return self._s_rice_unsort_impl(code_cells, ch2c, n_slices,
                                        sortrows_cap)

    def _s_rice_unsort_impl(self, code_cells, ch2c, n_slices,
                            sortrows_cap):
        n = n_slices * self.npix
        scap = sortrows_cap
        keys = ch2c[:scap].reshape(scap * 128)
        codes = code_cells[:scap].reshape(scap * 128)
        _, codes_s = jax.lax.sort((keys, codes), num_keys=1)
        return codes_s[:n].reshape(n_slices, self.npix)

    def _s_rice_bits(self, streams, vlc_codes, ev_cap, nwords):
        return self._disp(self._s_rice_bits_jit, self._s_rice_bits_impl,
                          streams, vlc_codes, ev_cap, nwords)

    @functools.partial(jax.jit, static_argnames=("self", "ev_cap",
                                                 "nwords"))
    def _s_rice_bits_jit(self, streams, vlc_codes, ev_cap, nwords):
        return self._s_rice_bits_impl(streams, vlc_codes, ev_cap, nwords)

    def _s_rice_bits_impl(self, streams, vlc_codes, ev_cap, nwords):
        from .device_rice import (assemble_bits, ladder_fields,
                                  rice_elements)
        ones, term_j, rem, n_lad = ladder_fields(streams, ev_cap)
        lens, vals = rice_elements(streams, vlc_codes, ones, term_j, rem)
        by, nbits = assemble_bits(lens, vals, nwords)
        return by, nbits, n_lad

    def _encode_rice(self, planes, keyframe: bool) -> bytes:
        """Golomb-rice frame encode on the device pipeline.

        Matches encoder.py:_encode_slice golomb mode byte for byte:
        [static rac header][bitstream] per slice + trailer/CRC."""
        p = self.p
        dev = [jnp.asarray(np.asarray(pl), jnp.int32) for pl in planes]
        vcanon0 = self.vcanon
        for _ in range(8):
            ctx, streams = self._phase_a_rice(dev)
            plan = self._s_rice_layout(ctx, streams["payload"],
                                       self.tiles_cap, self.cellrows_cap)
            ch1c, ch2c = self._s_scatter(plan, self.cellrows_cap)
            code_cells, vcanon, psizes = self._s_vlc_walk(
                ch1c, plan, vcanon0, keyframe, self.tiles_cap)
            vlc_codes = self._s_rice_unsort(
                code_cells, ch2c, self.S, self.sortrows_cap)
            by, nbits, n_lad = self._s_rice_bits(
                streams, vlc_codes, self.ev_cap, self.nwords)
            rows, tiles, slots = (int(v) for v in np.asarray(psizes))
            nb = np.asarray(nbits)
            nl = int(np.asarray(n_lad).max())
            if (rows + 1024 <= self.cellrows_cap
                    and rows <= self.sortrows_cap
                    and tiles <= self.tiles_cap
                    and slots <= self.tiles_cap * 128
                    and nl <= self.ev_cap
                    and int(nb.max()) <= self.nwords * 32):
                break
            if rows + 1024 > self.cellrows_cap or tiles > self.tiles_cap \
                    or slots > self.tiles_cap * 128:
                self.tiles_cap = quantize_cap(
                    max(tiles + 64, self.tiles_cap + 1), self.tiles_max)
                self.cellrows_cap = quantize_cap(
                    max(rows + 2048, self.cellrows_cap + 1),
                    self.cellrows_max)
            if rows > self.sortrows_cap:
                self.sortrows_cap = quantize_cap(rows + 512,
                                                 self.cellrows_max)
            self.sortrows_cap = min(self.sortrows_cap, self.cellrows_cap)
            if nl > self.ev_cap:
                self.ev_cap = quantize_cap(nl + 512, self.ev_cap_max)
            if int(nb.max()) > self.nwords * 32:
                self.nwords = quantize_cap(int(nb.max()) // 32 + 256,
                                           self.nwords_max, 8)
        else:
            raise RuntimeError("device rice exceeded worst-case caps")
        self.vcanon = vcanon
        by_h = np.asarray(by)
        hdrs = self.rice_headers[keyframe]
        return [hdrs[li] + by_h[li, :(int(nb[li]) + 7) // 8].tobytes()
                for li in range(self.S)]

    def _pipeline(self, planes, canonical, keyframe: bool, caps=None,
                  ev_words=None, prefix=None, rct=None):
        if rct is not None:
            ctx, diff = self._phase_a_rct(planes, *rct)
        else:
            ctx, diff = self._phase_a(planes)
        svp, btp, hlen = prefix if prefix is not None \
            else self.prefix[keyframe]
        return self.ops_from_streams(ctx, diff, canonical, svp, btp, hlen,
                                     keyframe, caps, ev_words)

    def ops_from_streams(self, ctx, diff, canonical, svp, btp, hlen,
                         keyframe: bool, caps=None, ev_words=None):
        """Streams -> per-slice packed op words + op counts.

        Returns (opw (S, op_cap) int32 [mode:2|bit:1|sv:8], n_ops (S,),
        canonical, sizes = [rows, tiles, slots, opmax, maxcount]).
        ev_words caps the unsort payload width (adaptive; sizes[-1] is
        the frame's true max ops/pixel for the validity check
        maxcount <= 4*ev_words).  Shard-friendly: n_slices is taken from
        ctx.shape (the multichip dryrun calls this inside shard_map on
        each device's slice subset; chain rows, the canonical state table
        and the layout are all local to the shard).

        On an accelerator the stages run as separate jitted dispatches
        (layout / scatter / s0 / adapt / writeback / unsort / expand),
        which keeps each XLA compile small and lets a cap retry recompile
        only the stages whose shapes changed; dispatches queue
        asynchronously.  On the CPU (tests, the virtual mesh) everything
        runs eagerly in the same order (accel.stage_plan)."""
        n_slices = ctx.shape[0]
        n = n_slices * self.npix
        if caps is None:
            n_buckets = self.npix // GCAP + 2
            tiles_cap = (n // GCAP + 2 * n_buckets
                         + (n_slices * self.rows_per_slice) // 128 + 8)
            cellrows_cap = (n // 128 + (n_buckets + 2) * GCAP
                            + tiles_cap + 128)
            op_cap = -(-(self.npix * self.k_max + int(svp.shape[1]) + 8)
                       // OP_GRAN) * OP_GRAN
            sortrows_cap = cellrows_cap
        elif len(caps) == 3:
            tiles_cap, cellrows_cap, op_cap = caps
            sortrows_cap = cellrows_cap
        else:
            tiles_cap, cellrows_cap, op_cap, sortrows_cap = caps
        sortrows_cap = min(sortrows_cap, cellrows_cap)

        nw = n_ev_words(self.code_bits)
        if ev_words is not None:
            nw = min(nw, ev_words)
        ev_cells, ch1c, ch2c, canonical, psizes = self._s_front(
            ctx, diff, canonical, keyframe, tiles_cap, cellrows_cap, nw)
        words_n, maxc = self._s_unsort(ev_cells, ch1c, ch2c, n_slices,
                                       sortrows_cap)
        opw, n_ops = self._s_expand(words_n, diff, svp, btp, hlen, op_cap)
        sizes = jnp.concatenate([psizes, jnp.max(n_ops)[None],
                                 maxc[None]])
        return opw, n_ops, canonical, sizes

    # -- pipeline stages ----------------------------------------------------

    def _disp(self, jit_fn, impl_fn, *args):
        return (jit_fn if self.plan.jit else impl_fn)(*args)

    def _s_front(self, ctx, diff, canonical, keyframe, tiles_cap,
                 cellrows_cap, ev_words):
        """Layout + scatter + s0 + adapt + writeback, as five separate
        jitted dispatches: XLA compile time is superlinear in graph size,
        and a cap retry only recompiles the pieces whose shapes
        changed."""
        plan = self._s_layout(ctx, diff, tiles_cap, cellrows_cap)
        ch1c, ch2c = self._s_scatter(plan, cellrows_cap)
        if keyframe:
            if self.p.initial_states is None:
                canonical = jnp.full_like(canonical, 128)
            else:
                reps = (canonical.shape[0] - 1) // self.rows_per_slice
                canonical = jnp.concatenate(
                    [jnp.tile(jnp.asarray(self._canonical_key1),
                              (reps, 1)),
                     jnp.full((1, 32), 128, jnp.uint8)], axis=0)
        s0 = self._s_s0(plan, canonical, tiles_cap)
        ev_cells, ends = self._s_adapt(ch1c, plan, s0, tiles_cap,
                                       cellrows_cap, ev_words)
        canonical, psizes = self._s_wb(plan, canonical, ends, tiles_cap)
        return ev_cells, ch1c, ch2c, canonical, psizes

    def _s_layout(self, ctx, diff, tiles_cap, cellrows_cap):
        return self._disp(self._s_layout_jit, self._s_layout_impl,
                          ctx, diff, tiles_cap, cellrows_cap)

    @functools.partial(jax.jit, static_argnames=(
        "self", "tiles_cap", "cellrows_cap"))
    def _s_layout_jit(self, ctx, diff, tiles_cap, cellrows_cap):
        return self._s_layout_impl(ctx, diff, tiles_cap, cellrows_cap)

    def _s_layout_impl(self, ctx, diff, tiles_cap, cellrows_cap):
        row_local = jnp.asarray(self.class_off_stream)[None, :] + ctx
        plan = layout_plan(row_local, diff, self.rows_per_slice,
                           tiles_cap * 128, tiles_cap,
                           wide=0 if self.code_bits <= 10
                           else payload_field(self.code_bits)[2])
        # under a cap overflow this frame's result is garbage (the caller
        # detects via the size outputs and retries larger); keep the
        # kernel's DMAs in range regardless
        lim = cellrows_cap - 1024
        plan["tile_bases"] = jnp.minimum(plan["tile_bases"], lim)
        plan["tile_caps"] = jnp.minimum(
            plan["tile_caps"], lim - plan["tile_bases"])
        return plan

    def _s_scatter(self, plan, cellrows_cap):
        return self._disp(self._s_scatter_jit, scatter_cells,
                          plan, cellrows_cap)

    @functools.partial(jax.jit, static_argnames=("self", "cellrows_cap"))
    def _s_scatter_jit(self, plan, cellrows_cap):
        return scatter_cells(plan, cellrows_cap)

    def _s_s0(self, plan, canonical, tiles_cap):
        return self._disp(self._s_s0_jit, build_s0_blocks,
                          plan, canonical, tiles_cap)

    @functools.partial(jax.jit, static_argnames=("self", "tiles_cap"))
    def _s_s0_jit(self, plan, canonical, tiles_cap):
        return build_s0_blocks(plan, canonical, tiles_cap)

    def _s_wb(self, plan, canonical, ends, tiles_cap):
        return self._disp(self._s_wb_jit, self._s_wb_impl,
                          plan, canonical, ends, tiles_cap)

    @functools.partial(jax.jit, static_argnames=("self", "tiles_cap"))
    def _s_wb_jit(self, plan, canonical, ends, tiles_cap):
        return self._s_wb_impl(plan, canonical, ends, tiles_cap)

    def _s_wb_impl(self, plan, canonical, ends, tiles_cap):
        canonical = writeback_canonical(plan, canonical, ends, tiles_cap)
        psizes = jnp.stack([plan["n_rows"], plan["n_tiles"],
                            plan["n_slots"]])
        return canonical, psizes

    def _s_unsort(self, ev_cells, ch1c, ch2c, n_slices, sortrows_cap):
        return self._disp(self._s_unsort_jit, self._s_unsort_impl,
                          ev_cells, ch1c, ch2c, n_slices, sortrows_cap)

    @functools.partial(jax.jit, static_argnames=(
        "self", "n_slices", "sortrows_cap"))
    def _s_unsort_jit(self, ev_cells, ch1c, ch2c, n_slices, sortrows_cap):
        return self._s_unsort_impl(ev_cells, ch1c, ch2c, n_slices,
                                   sortrows_cap)

    def _s_unsort_impl(self, ev_cells, ch1c, ch2c, n_slices,
                       sortrows_cap):
        # cells -> stream order: payload sort over the TIGHT cell domain.
        # Real cells occupy the dense prefix
        # [0, n_rows): the sort runs on the adaptive sortrows_cap prefix
        # (~n/128 * 9/8), not the DMA-slack-padded cell buffer; keys are
        # scatter_cells' ch2 (stream index per cell, empty = int32 max).
        # ev_cells arrive EMISSION-ORDER packed from the adapt kernel
        # (byte k of word k>>2 = the sv byte of the pixel's k-th op), so
        # the sort payload is the final n_ev operands directly.
        n = n_slices * self.npix
        scap = sortrows_cap
        wide = self.code_bits > 10
        mask, bias, vbit_w = payload_field(self.code_bits)
        if not wide:
            mask = 0x1FFF
        diff_c = (ch1c[:scap] & mask) - bias
        nw = ev_cells.shape[1]
        words = [ev_cells[:scap, j, :].reshape(scap * 128)
                 for j in range(nw)]
        keys = ch2c[:scap].reshape(scap * 128)
        sorted_ops = jax.lax.sort((keys, *words), num_keys=1)
        # the frame's true worst-case op count (VALID cells only —
        # empty cells carry payload 0): the caller checks it against
        # 4*ev_words and retries wider when the cap was too narrow
        vbit = vbit_w if wide else 13
        maxc = jnp.max(jnp.where((ch1c[:scap] >> vbit) & 1 == 1,
                                 event_count(diff_c), 0))
        return tuple(w[:n].reshape(n_slices, self.npix)
                     for w in sorted_ops[1:]), maxc

    def _s_expand(self, words_n, diff, svp, btp, hlen, op_cap):
        """Per-pixel sv words (stream order) -> packed compacted op
        stream (S, op_cap) through the emission grids."""
        return self._disp(self._s_expand_jit, self._s_expand_impl,
                          words_n, diff, svp, btp, hlen, op_cap)

    @functools.partial(jax.jit, static_argnames=("self", "op_cap"))
    def _s_expand_jit(self, words_n, diff, svp, btp, hlen, op_cap):
        return self._s_expand_impl(words_n, diff, svp, btp, hlen, op_cap)

    def _s_expand_impl(self, words_n, diff, svp, btp, hlen, op_cap):
        return expand_ops_reference(words_n, diff, svp, btp, hlen,
                                    op_cap, self.code_bits)

    def _s_adapt(self, ch1c, plan, s0, tiles_cap, cellrows_cap, ev_words):
        return self._disp(self._s_adapt_jit, self._s_adapt_impl,
                          ch1c, plan, s0, tiles_cap, cellrows_cap, ev_words)

    @functools.partial(jax.jit, static_argnames=(
        "self", "tiles_cap", "cellrows_cap", "ev_words"))
    def _s_adapt_jit(self, ch1c, plan, s0, tiles_cap, cellrows_cap,
                     ev_words):
        return self._s_adapt_impl(ch1c, plan, s0, tiles_cap, cellrows_cap,
                                  ev_words)

    def _s_adapt_impl(self, ch1c, plan, s0, tiles_cap, cellrows_cap,
                      ev_words):
        """Adaptation walk (slot-packed sv words) + repack to
        EMISSION-ORDER packed ev words per cell."""
        args = (ch1c, plan["tile_caps"], plan["tile_bases"],
                plan["tile_pred"], s0, jnp.asarray(self.table))
        if self.plan.impl("adapt") == "kernel":
            from .adapt_pallas import adapt_pallas
            sv_cells, ends = adapt_pallas(*args, tiles_cap, cellrows_cap,
                                          code_bits=self.code_bits)
        else:
            sv_cells, ends = adapt_reference(*args, tiles_cap,
                                             code_bits=self.code_bits)
        mask, bias, _ = payload_field(self.code_bits)
        diff_c = (ch1c & mask) - bias
        ev = repack_emission_order(sv_cells, diff_c, self.code_bits,
                                   ev_words)
        return ev, ends

    def _code_render(self, opw, steps, buf_cap, fast=True):
        """Arithmetic coding + packet-byte rendering, fully on device.

        opw: (S, op_cap) packed op words from the pipeline.  Returns
        (bytes uint8 (S, buf_cap), true lengths int32 (S,), fc_max) —
        the only data the host ever fetches.  fast uses the packed
        staged-event compaction; the caller re-renders with fast=False
        if fc_max > 1023 (fill-run field overflow, see
        render_bytes_fast).  On an accelerator the coder and the render
        are separate jitted dispatches."""
        if self.plan.jit:
            f, c, v = self._coder_jit(opw, steps)
            return self._render_jit(f, c, v, int(opw.shape[0]), steps,
                                    buf_cap, fast)
        return self._code_render_impl(opw, steps, buf_cap, fast)

    @functools.partial(jax.jit, static_argnames=("self", "steps"))
    def _coder_jit(self, opw, steps):
        return self._coder_impl(opw, steps)

    def _coder_impl(self, opw, steps):
        from .pallas_coder import LANE_BLOCK, rac_pallas_packed
        S = opw.shape[0]
        lanes = -(-S // LANE_BLOCK) * LANE_BLOCK
        opT = jnp.pad(opw[:, :steps].T, ((0, 0), (0, lanes - S)))
        if self.plan.impl("coder") == "kernel":
            return rac_pallas_packed(opT)
        from .tpu_coder import rac_scan_lanes
        return rac_scan_lanes(opT & 0xFF, (opT >> 8) & 1, (opT >> 9) & 3)

    @functools.partial(jax.jit,
                       static_argnames=("self", "S", "steps", "buf_cap",
                                        "fast"))
    def _render_jit(self, f, c, v, S, steps, buf_cap, fast):
        # f/c/v are (steps, lanes); true slice rows are the leading S
        if fast and steps < (1 << 20):
            return render_bytes_fast(f.T[:S], c.T[:S], v.T[:S], buf_cap)
        by, ln = render_bytes(f.T[:S], c.T[:S], v.T[:S], buf_cap)
        return by, ln, jnp.zeros((), jnp.int32)

    def _code_render_impl(self, opw, steps, buf_cap, fast):
        S = opw.shape[0]
        f, c, v = self._coder_impl(opw, steps)
        if fast and steps < (1 << 20):
            return render_bytes_fast(f.T[:S], c.T[:S], v.T[:S], buf_cap)
        by, ln = render_bytes(f.T[:S], c.T[:S], v.T[:S], buf_cap)
        return by, ln, jnp.zeros((), jnp.int32)

    def _render_retry(self, opw, steps):
        """code+render with buffer-growth and fcount-overflow retries;
        returns (bytes device array, host lengths)."""
        for _ in range(6):
            by, ln, fcm = self._code_render(opw, steps, self.render_cap)
            ln_h = np.asarray(ln)
            if int(np.asarray(fcm)) > 1023:
                by, ln, _ = self._code_render(opw, steps,
                                              self.render_cap,
                                              fast=False)
                ln_h = np.asarray(ln)
            if int(ln_h.max()) <= self.render_cap:
                return by, ln_h
            self.render_cap = quantize_cap(
                max(int(ln_h.max()) + 4096, self.render_cap + 1),
                self.render_cap_max, 4096)
        raise RuntimeError("render buffer exceeded worst-case cap")

    # -- public API -----------------------------------------------------------

    def encode(self, planes, force_keyframe=None) -> bytes:
        p = self.p
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        if self._banks is not None:
            # non-uniform geometry: one pipeline per slice-shape group,
            # packet assembled in global slice order
            chunks = [None] * p.slice_count
            for bank in self._banks:
                datas = bank._encode_frame_data(planes, keyframe)
                for li, si in enumerate(bank.slice_ids):
                    chunks[si] = datas[li]
            self.picture_number += 1
            return self._finish_packet(chunks)
        datas = self._encode_frame_data(planes, keyframe)
        chunks = [None] * p.slice_count
        for li, si in enumerate(self.slice_ids):
            chunks[si] = datas[li]
        self.picture_number += 1
        return self._finish_packet(chunks)

    def _finish_packet(self, chunks) -> bytes:
        """Per-GLOBAL-slice raw data -> packet: 3-byte BE size trailer +
        optional CRC per slice (ffv1enc.c:1236-1262 layout)."""
        p = self.p
        out = []
        for si, data in enumerate(chunks):
            if si > 0 or p.version > 2:
                assert len(data) < (1 << 24)
                data += len(data).to_bytes(3, "big")
                if p.ec:
                    data += b"\x00"
                    data += crc32_trailer(data)
            out.append(data)
        return b"".join(out)

    def _encode_frame_data(self, planes, keyframe: bool) -> list:
        """This bank's slices -> list of raw slice payloads (local
        order, no trailers)."""
        p = self.p
        if self.golomb:
            return self._encode_rice(planes, keyframe)
        dev = [jnp.asarray(np.asarray(pl), jnp.int32) for pl in planes]
        canon0 = self.canonical
        prefix = rct = None
        if self._v4rgb:
            rct_list = self._pick_rct(dev)
            prefix = self._prefix_for_rct(keyframe, rct_list)
            rct = (jnp.asarray([b for b, _ in rct_list], jnp.int32),
                   jnp.asarray([r for _, r in rct_list], jnp.int32))
        # check the sizes first, then code at the smallest pow2 step
        # bucket that holds the longest slice (measured on the GPU: as
        # fast as coding all op_cap steps behind one sync — PERF.md)
        for _ in range(8):
            opw, n_ops, canon, sizes = self._pipeline(
                dev, canon0, keyframe,
                (self.tiles_cap, self.cellrows_cap, self.op_cap,
                 self.sortrows_cap), self.unsort_words,
                prefix=prefix, rct=rct)
            rows, tiles, slots, opmax, maxc = (
                int(v) for v in np.asarray(sizes))
            if (rows + 1024 <= self.cellrows_cap
                    and rows <= self.sortrows_cap
                    and tiles <= self.tiles_cap
                    and slots <= self.tiles_cap * 128
                    and opmax <= self.op_cap
                    and maxc <= 4 * self.unsort_words):
                # tighten fat working domains to the content's measured
                # scale (+25% headroom): the expand and the unsort run
                # over the full op_cap / sortrows_cap, so slack is wasted
                # time.  At most twice per session (first frames), so
                # caps settle instead of oscillating; a later spike
                # regrows them.
                if self._shrinks > 0:
                    tight_op = quantize_cap(opmax * 5 // 4 + 512,
                                            self.op_cap_max, OP_GRAN)
                    tight_sort = quantize_cap(
                        rows + max(512, rows // 16), self.cellrows_max)
                    if (tight_op < self.op_cap
                            or tight_sort < self.sortrows_cap):
                        self._shrinks -= 1
                        self.op_cap = min(self.op_cap, tight_op)
                        self.sortrows_cap = min(self.sortrows_cap,
                                                tight_sort)
                steps = 1 << int(np.max(np.asarray(n_ops))).bit_length()
                steps = max(512, min(steps, int(opw.shape[1])))
                by, ln_h = self._render_retry(opw, steps)
                break
            # grow the adaptive working sizes and retrace (rare; the
            # canonical table was not consumed destructively).  Growth
            # targets the measured need (+slack) snapped up a rung, so
            # one retry normally suffices and the new shapes still come
            # from the shared rung set.
            if rows + 1024 > self.cellrows_cap or tiles > self.tiles_cap \
                    or slots > self.tiles_cap * 128:
                self.tiles_cap = quantize_cap(
                    max(tiles + 64, self.tiles_cap + 1), self.tiles_max)
                self.cellrows_cap = quantize_cap(
                    max(rows + 2048, self.cellrows_cap + 1),
                    self.cellrows_max)
            if rows > self.sortrows_cap:
                self.sortrows_cap = quantize_cap(rows + 512,
                                                 self.cellrows_max)
            self.sortrows_cap = min(self.sortrows_cap, self.cellrows_cap)
            if opmax > self.op_cap:
                self.op_cap = quantize_cap(opmax + 512, self.op_cap_max,
                                           OP_GRAN)
            if maxc > 4 * self.unsort_words:
                self.unsort_words = min(n_ev_words(self.code_bits),
                                        (maxc + 3) // 4)
        else:
            raise RuntimeError("device layout exceeded worst-case caps")
        self.canonical = canon
        by_h = np.asarray(by)
        return [by_h[li, :int(ln_h[li])].tobytes()
                for li in range(self.S)]

    # -- all-intra batch encode --------------------------------------------
    #
    # Keyframes reset every slice's context state (ffv1.c:182), so intra
    # frames are independent coding units: a batch of B frames becomes
    # B * slice_count slices in ONE fused device program — the device
    # analogue of frame-parallel encoding (pthread_frame.c), and extra
    # lanes for the arithmetic coder.

    def _batch_state(self, B: int):
        if not hasattr(self, "_bstate"):
            self._bstate = {}
        if B not in self._bstate:
            p = self.p
            n = B * self.S * self.npix
            chains = B * self.n_chain_rows
            n_buckets = self.npix // GCAP + 2
            tiles_max = (n // GCAP + 2 * n_buckets + chains // 128 + 8)
            cellrows_max = (n // 128 + (n_buckets + 2) * GCAP
                            + tiles_max + 128)
            self._bstate[B] = dict(
                tiles=quantize_cap(n // GCAP + chains // 128 + 72,
                                   tiles_max),
                cellrows=quantize_cap(n // 128 * 5 // 4 + 2 * GCAP + 256,
                                      cellrows_max),
                sort=quantize_cap(n // 128 * 9 // 8 + 1024, cellrows_max),
                tiles_max=tiles_max, cellrows_max=cellrows_max,
                canon=jnp.full((chains + 1, 32), 128, jnp.uint8))
        return self._bstate[B]

    def _pipeline_batch(self, frames, canonical, caps):
        # NOT wrapped in an outer jit: ops_from_streams dispatches its
        # stages as separate jitted programs (a monolithic wrapper would
        # inline them back into one graph, whose compile time is
        # superlinear in its size)
        parts = [self._phase_a(pls) for pls in frames]
        ctx = jnp.concatenate([c for c, _ in parts], axis=0)
        diff = jnp.concatenate([d for _, d in parts], axis=0)
        svp, btp, hlen = self.prefix[True]
        B = len(frames)
        return self.ops_from_streams(
            ctx, diff, canonical, jnp.tile(svp, (B, 1)),
            jnp.tile(btp, (B, 1)), jnp.tile(hlen, B), True, caps,
            self.unsort_words)

    def encode_batch(self, frames_list) -> list:
        """Encode B intra (key) frames in one fused device program;
        returns their packets.  Does not touch the session's inter-frame
        context state."""
        p = self.p
        if self._banks is not None:
            raise NotImplementedError(
                "batch encode with a non-uniform slice geometry: use "
                "encode() (per-shape banks) or a uniform frame size")
        if self._v4rgb:
            raise NotImplementedError(
                "batch encode with v4 RGB: the per-slice RCT search "
                "re-plans headers per frame; use encode()")
        B = len(frames_list)
        S = self.S
        dev = [[jnp.asarray(np.asarray(pl), jnp.int32) for pl in f]
               for f in frames_list]
        st = self._batch_state(B)
        for _ in range(8):
            caps = (st["tiles"], st["cellrows"], self.op_cap, st["sort"])
            opw, n_ops, _, sizes = self._pipeline_batch(
                dev, st["canon"], caps)
            rows, tiles, slots, opmax, maxc = (
                int(v) for v in np.asarray(sizes))
            if (rows + 1024 <= st["cellrows"] and rows <= st["sort"]
                    and tiles <= st["tiles"]
                    and slots <= st["tiles"] * 128
                    and opmax <= self.op_cap
                    and maxc <= 4 * self.unsort_words):
                break
            if rows + 1024 > st["cellrows"] or tiles > st["tiles"] \
                    or slots > st["tiles"] * 128:
                st["tiles"] = quantize_cap(
                    max(tiles + 64, st["tiles"] + 1), st["tiles_max"])
                st["cellrows"] = quantize_cap(
                    max(rows + 2048, st["cellrows"] + 1),
                    st["cellrows_max"])
            if rows > st["sort"]:
                st["sort"] = quantize_cap(rows + 512, st["cellrows_max"])
            st["sort"] = min(st["sort"], st["cellrows"])
            if opmax > self.op_cap:
                self.op_cap = quantize_cap(opmax + 512, self.op_cap_max,
                                           OP_GRAN)
            if maxc > 4 * self.unsort_words:
                self.unsort_words = min(n_ev_words(self.code_bits),
                                        (maxc + 3) // 4)
        else:
            raise RuntimeError("device layout exceeded worst-case caps")
        steps = 1 << int(np.max(np.asarray(n_ops))).bit_length()
        steps = max(512, min(steps, int(opw.shape[1])))
        by, ln_h = self._render_retry(opw, steps)
        by_h = np.asarray(by)
        pkts = []
        for b in range(B):
            chunks = []
            for si in range(S):
                row = b * S + si
                data = by_h[row, :int(ln_h[row])].tobytes()
                if si > 0 or p.version > 2:
                    assert len(data) < (1 << 24)
                    data += len(data).to_bytes(3, "big")
                    if p.ec:
                        data += b"\x00"
                        data += crc32_trailer(data)
                chunks.append(data)
            pkts.append(b"".join(chunks))
        return pkts


def shift_expand(channels, valid, dest, out_len: int):
    """Stable right-expansion along axis -1: moves valid elements to
    strictly-increasing dest >= index.

    PRECONDITION: valid elements form a dense prefix (e.g. the output of
    shift_compact with rank destinations).  Then the move distances
    dest[r] - r are non-decreasing, which makes the bit-by-bit shifts
    collision-free (the masked-delta difference of two elements never
    exceeds their index distance)."""
    m = channels[0].shape[-1]
    pad = out_len - m
    if pad > 0:
        def rpad(a, fill):
            return jnp.concatenate(
                [a, jnp.full(a.shape[:-1] + (pad,), fill, a.dtype)], axis=-1)
        channels = [rpad(a, 0) for a in channels]
        valid = rpad(valid, False)
        dest = rpad(dest, 0)
    idx = jnp.arange(out_len, dtype=jnp.int32)
    delta = jnp.where(valid, dest - idx, 0)
    arrs = [jnp.where(valid, c, 0) for c in channels]
    val = valid
    nbits = max(1, int(out_len - 1).bit_length())
    # right moves must process delta bits HIGH to LOW: the moved-so-far
    # part is then the (monotone) top of delta, keeping positions strictly
    # ordered; low-to-high is only collision-free for left moves.
    for b in reversed(range(nbits)):
        step = 1 << b
        move = val & (((delta >> b) & 1) == 1)

        def shr(a, fill=0):
            padv = jnp.full(a.shape[:-1] + (step,), fill, a.dtype)
            return jnp.concatenate([padv, a[..., :-step]], axis=-1)

        move_in = shr(move, False)
        arrs = [jnp.where(move_in, shr(a), jnp.where(move, 0, a))
                for a in arrs]
        delta = jnp.where(move_in, shr(delta) - step,
                          jnp.where(move, 0, delta))
        val = jnp.where(move_in, True, val & ~move)
    return arrs, val


def render_bytes_fast(first, fcount, fval, buf_cap: int):
    """Packed-channel render_bytes: both staged-event compactions ride
    shift_compact_packed (one int32 array each) instead of the 5-array
    log-shift — ~10x less traffic on the steps-domain pass, which
    dominated the device encode tail.

    Returns (bytes, lengths, fc_max).  Valid only while every fill run
    is < 1024 bytes (10-bit fcount field) and steps < 2^20 (delta
    field): the caller checks fc_max and re-renders via render_bytes on
    overflow (loud; fill runs are carry chains, essentially never that
    long).  The event byte offsets are reconstructed after compaction
    as rank + exclusive-cumsum(fcount), so they never ride the shift."""
    i32 = jnp.int32
    m = first.shape[-1]
    emit = first >= 0
    nbytes = jnp.where(emit, 1 + fcount, 0)
    endo = jnp.cumsum(nbytes, axis=-1)
    total = endo[..., -1]
    rank = jnp.cumsum(emit.astype(i32), axis=-1) - 1
    idx = jnp.arange(m, dtype=i32)
    delta = jnp.where(emit, idx - rank, 0)
    fv1 = fval & 1                       # fval is 0x00 or 0xFF
    pA = jnp.where(emit, (delta << 10) | (1 << 9) | (fv1 << 8)
                   | (first & 0xFF), 0)
    pB = jnp.where(emit, (delta << 11) | (1 << 10)
                   | jnp.minimum(fcount, 1023), 0)
    fcmax = jnp.max(jnp.where(emit, fcount, 0))
    pA = shift_compact_packed(pA, buf_cap, data_bits=9)
    pB = shift_compact_packed(pB, buf_cap, data_bits=10)
    vmask = ((pA >> 9) & 1) != 0
    fst_d = pA & 0xFF
    fvl_d = ((pA >> 8) & 1) * 0xFF
    fc_d = pB & 0x3FF
    off_d = (jnp.arange(buf_cap, dtype=i32)
             + jnp.cumsum(fc_d, axis=-1) - fc_d)
    (fst_p, fvl_p), at_event = shift_expand(
        [fst_d + 1, fvl_d + 1], vmask, off_d, buf_cap)
    pos = jnp.arange(buf_cap, dtype=i32)[None, :]
    enc = jnp.where(at_event, pos * 256 + (fvl_p - 1), -1)
    ffill = jax.lax.cummax(enc, axis=enc.ndim - 1)
    byte = jnp.where(at_event, fst_p - 1, ffill % 256)
    byte = jnp.where(pos < total[..., None], byte, 0)
    return byte.astype(jnp.uint8), total, fcmax


def render_bytes(first, fcount, fval, buf_cap: int):
    """Device packet rendering: the arithmetic coder's staged emissions
    (per-slice rows) -> byte streams + lengths (compact_lane semantics:
    each emitting step appends its first byte then fcount copies of fval).

    first/fcount/fval: (n_slices, steps) int32 (first < 0 = no emission).
    Returns (bytes uint8 (n_slices, buf_cap), lengths int32 (n_slices,)).
    """
    emit = first >= 0
    nbytes = jnp.where(emit, 1 + fcount, 0)
    endo = jnp.cumsum(nbytes, axis=-1)
    off = endo - nbytes
    total = endo[..., -1]
    rank = jnp.cumsum(emit.astype(jnp.int32), axis=-1) - 1
    (fst_d, fvl_d, off_d), vmask = shift_compact(
        [first, fval, off], emit, jnp.maximum(rank, 0), buf_cap)
    (fst_p, fvl_p), at_event = shift_expand(
        [fst_d + 1, fvl_d + 1], vmask, off_d, buf_cap)
    # forward-fill the most recent event's fval over the gap bytes
    pos = jnp.arange(buf_cap, dtype=jnp.int32)[None, :]
    enc = jnp.where(at_event, pos * 256 + (fvl_p - 1), -1)
    ffill = jax.lax.cummax(enc, axis=enc.ndim - 1)
    byte = jnp.where(at_event, fst_p - 1, ffill % 256)
    byte = jnp.where(pos < total[..., None], byte, 0)
    return byte.astype(jnp.uint8), total
