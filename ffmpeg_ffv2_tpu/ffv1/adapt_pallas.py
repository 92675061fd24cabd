"""Pallas (Triton) kernel for the FFV1 range-coder adaptation walk.

Same semantics as device_coder.adapt_reference (the plain XLA reference):
the cell layout holds 128 lanes per row, tiles of rows one after another.
A lane's chain depends only on its own column, and a split group's
sub-lane continues from ``carry[pred]`` at the SAME lane, in a tile that
comes earlier.  So one program per block of lanes walks every tile and
every cell row in order, with its lanes' 32 slot states in registers, and
programs need no ordering among themselves: they run in parallel, in any
order.

The 32 slot states of a lane are held as four (8, lanes) tensors, one
per byte of the packed output words: tensor b, row w holds slot 4*w + b,
which is permuted row 8*b + w of the reference's SLOT_AT_ROW order.  A
row's packed sv words are then four shifted ORs, with no reshape.  Each
state transition is one gather from the 512-entry (zero ++ one) table.

A tile's end states go to ``carry[t]``; the program itself reads them
back when a later tile of the same lanes continues the group.  A block
barrier after the write makes it visible to every thread of the program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..accel import check_kernel_platform
from .device_coder import n_sv_words, payload_field

LANE_BLOCK = 16          # lanes per program
SLOT10 = (2, 2)          # (byte tensor, row) of slot 10
SLOT31 = (3, 7)          # (byte tensor, row) of slot 31


def unpack_table(packed_table):
    """128 packed words (device_coder.packed_transition_table) -> the
    512 transition bytes (zero ++ one) as int32."""
    idx = jnp.arange(512, dtype=jnp.int32)
    word = jnp.take(jnp.asarray(packed_table, jnp.int32), idx >> 2)
    return (word >> ((idx & 3) * 8)) & 0xFF


def _exponent(a):
    f = a.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


def _adapt_kernel(caps_ref, bases_ref, preds_ref, ch1_ref, s0_ref,
                  table_ref, sv_ref, carry_ref, *, tiles: int,
                  code_bits: int, lane_block: int, barrier: bool):
    lb = lane_block
    lanes = pl.ds(pl.program_id(0) * lb, lb)
    R = max(0, code_bits - 10)
    if code_bits > 10:
        mask, bias, vbit = payload_field(code_bits)
    else:
        mask, bias, vbit = 0xFFF, 2048, 13
    w_id = jax.lax.broadcasted_iota(jnp.int32, (8, lb), 0)
    slots = [4 * w_id + b for b in range(4)]

    def row_step(cur, S):
        v = ((cur & mask) - bias)[None, :]
        ok = (((cur >> vbit) & 1) == 1)[None, :]
        a = jnp.abs(v)
        e = jnp.where(v != 0, _exponent(a), -1)
        nz = v != 0
        eE = jnp.minimum(e + 1, 10)
        eM = jnp.minimum(e, 10)
        words = jnp.zeros((8, lb), jnp.int32)
        new = []
        for b in range(4):
            sl = slots[b]
            is0 = sl == 0
            isexp = (sl >= 1) & (sl <= eE)
            ismant = (sl >= 22) & (sl <= 21 + eM)
            issign = sl == 11 + eM
            valid = (is0 | (nz & (isexp | ismant | issign))) & ok
            msh = jnp.where((sl == 31) & (e > 9), e - 1, sl - 22)
            bit = jnp.where(
                is0, (~nz).astype(jnp.int32),
                jnp.where(isexp, (sl <= e).astype(jnp.int32),
                          jnp.where(ismant, (a >> jnp.maximum(msh, 0)) & 1,
                                    (v < 0).astype(jnp.int32))))
            words = words | (jnp.where(valid, S[b], 0) << (8 * b))
            ns = table_ref[bit * 256 + S[b]]
            new.append(jnp.where(valid, ns, S[b]))
        ext = []
        if R > 0:
            # repeat hits of slots 10/31 (e > 9): sub-step j is hit j+1;
            # the pre-update pair packs 2 pairs per extra word
            a1, e1, ok1 = a[0], e[0], ok[0]
            pairs = []
            for j in range(1, R + 1):
                v10 = ok1 & (e1 >= 9 + j)
                v31 = ok1 & (e1 >= 10 + j)
                b10 = (e1 >= j + 10).astype(jnp.int32)
                b31 = (a1 >> jnp.maximum(e1 - 1 - j, 0)) & 1
                r10 = w_id == SLOT10[1]
                r31 = w_id == SLOT31[1]
                s10 = jnp.sum(jnp.where(r10, new[SLOT10[0]], 0), axis=0)
                s31 = jnp.sum(jnp.where(r31, new[SLOT31[0]], 0), axis=0)
                pairs.append(jnp.where(v10, s10, 0)
                             | (jnp.where(v31, s31, 0) << 8))
                n10 = table_ref[b10 * 256 + s10]
                n31 = table_ref[b31 * 256 + s31]
                new[SLOT10[0]] = jnp.where(r10 & v10[None, :], n10[None, :],
                                           new[SLOT10[0]])
                new[SLOT31[0]] = jnp.where(r31 & v31[None, :], n31[None, :],
                                           new[SLOT31[0]])
            if len(pairs) % 2:
                pairs.append(jnp.zeros_like(pairs[0]))
            ext = [pairs[2 * w] | (pairs[2 * w + 1] << 16)
                   for w in range(len(pairs) // 2)]
        return tuple(new), words, ext

    def tile_body(t, carry):
        cap = caps_ref[t]
        base = bases_ref[t]
        pred = preds_ref[t]
        cont = ((s0_ref[t, 32, lanes] > 0) & (pred >= 0))[None, :]
        pr = jnp.maximum(pred, 0)
        S = tuple(jnp.where(cont, carry_ref[pr, pl.ds(8 * b, 8), lanes],
                            s0_ref[t, pl.ds(8 * b, 8), lanes])
                  for b in range(4))

        def row_body(r, c):
            S, cur = c[:4], c[4]
            nxt = ch1_ref[base + r + 1, lanes]          # prefetch
            S, words, ext = row_step(cur, S)
            sv_ref[base + r, pl.ds(0, 8), lanes] = words
            for w, x in enumerate(ext):
                sv_ref[base + r, 8 + w, lanes] = x
            return (*S, nxt)

        out = jax.lax.fori_loop(0, cap, row_body,
                                (*S, ch1_ref[base, lanes]))
        for b in range(4):
            carry_ref[t, pl.ds(8 * b, 8), lanes] = jnp.where(
                cap > 0, out[b], 0)
        if barrier:
            plgpu.debug_barrier()
        return carry

    jax.lax.fori_loop(0, tiles, tile_body, 0)


@functools.partial(jax.jit,
                   static_argnames=("tiles_cap", "cellrows_cap",
                                    "code_bits", "interpret"))
def adapt_pallas(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
                 packed_table, tiles_cap: int, cellrows_cap: int,
                 code_bits: int = 10, interpret: bool = False):
    """Adaptation walk -> (sv_words (CELLROWS_CAP, W, 128) int32 slot-packed
    pre-update states, W = n_sv_words; end_states (TILES_CAP, 32, 128)
    int32 in SLOT_AT_ROW row order).

    Rows past the last tile are not written; callers read only the
    layout's live rows.  The layout must leave at least one row of slack
    past its last tile (device_coder clamps tiles 1024 rows short of
    CELLROWS_CAP), because each row prefetches the next."""
    check_kernel_platform("adapt_pallas", interpret)
    W = n_sv_words(code_bits)
    kern = functools.partial(_adapt_kernel, tiles=tiles_cap,
                             code_bits=code_bits, lane_block=LANE_BLOCK,
                             barrier=not interpret)
    return pl.pallas_call(
        kern,
        grid=(128 // LANE_BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((cellrows_cap, W, 128), jnp.int32),
                   jax.ShapeDtypeStruct((tiles_cap, 32, 128), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ffv1_adapt_walk",
    )(tile_caps, tile_bases, tile_pred, ch1_cells, s0_blocks,
      unpack_table(packed_table))
