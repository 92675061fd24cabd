"""Pallas (Triton) kernel for the lane-parallel range-coder arithmetic.

Same recursion as tpu_coder.rac_scan_lanes (the plain XLA reference),
written for a GPU: one program per block of ``LANE_BLOCK`` lanes (a lane
is one slice; in a batch, one slice of one frame).  Each thread keeps its
lane's (low, range, pending, pending_count) in registers and a
``fori_loop`` inside the kernel walks every op step, so the whole stream
is one launch instead of one while-loop iteration per op.  Programs share
nothing, so they run in any order.

The op words are packed [mode:2 | bit:1 | sv:8] (bits [10:9], [8],
[7:0]) and load in chunks of ``STEP_CHUNK`` steps: the next chunk's words
are requested before the current chunk's steps run, so their memory
latency hides behind the arithmetic instead of stalling every step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..accel import check_kernel_platform

MODE_OP = 1
MODE_FLUSH1 = 2
MODE_FLUSH2 = 3

LANE_BLOCK = 32          # lanes per program: one warp, one lane per thread
STEP_CHUNK = 32          # op steps per load chunk (PERF.md: 16 -> 39 ms,
                         # 32 -> 32 ms at 1080p; per-step loads 110 ms)


def coder_step(w, low, rng, pending, pcount):
    """One op of the recursion on a vector of lanes.  Returns the new
    (low, range, pending, pcount) and the staged (first, fcount, fval)."""
    s = w & 0xFF
    b = (w >> 8) & 1
    m = (w >> 9) & 3
    is_op = m == MODE_OP
    is_flush1 = m == MODE_FLUSH1
    is_flush = is_flush1 | (m == MODE_FLUSH2)

    r1 = (rng * s) >> 8
    low_op = jnp.where(b != 0, low + rng - r1, low)
    rng_op = jnp.where(b != 0, r1, rng - r1)
    low1 = jnp.where(is_op, low_op, jnp.where(is_flush1, low + 0xFF, low))
    rng1 = jnp.where(is_op, rng_op, jnp.where(is_flush, 0xFF, rng))

    renorm = (rng1 < 0x100) & (is_op | is_flush)
    case_b = pending < 0
    case_c = low1 <= 0xFF00
    case_d = low1 >= 0x10000

    emit = renorm & (~case_b) & (case_c | case_d)
    first = jnp.where(emit, jnp.where(case_c, pending, pending + 1) & 0xFF,
                      -1)
    fcount = jnp.where(emit, pcount, 0)
    fval = jnp.where(case_c, 0xFF, 0x00)

    pending2 = jnp.where(
        renorm,
        jnp.where(case_b | case_c, low1 >> 8,
                  jnp.where(case_d, (low1 >> 8) & 0xFF, pending)),
        pending)
    pcount2 = jnp.where(
        renorm,
        jnp.where(case_b | case_c | case_d,
                  jnp.where(case_b, pcount, 0), pcount + 1),
        pcount)
    low2 = jnp.where(renorm, (low1 & 0xFF) << 8, low1)
    rng2 = jnp.where(renorm, rng1 << 8, rng1)
    return (low2, rng2, pending2, pcount2), (first, fcount, fval)


def _coder_kernel(op_ref, first_ref, fcount_ref, fval_ref, *, steps: int,
                  chunk: int):
    lanes = op_ref.shape[1]
    nchunks = steps // chunk

    def load_chunk(c):
        base = jnp.minimum(c, nchunks - 1) * chunk
        return tuple(op_ref[base + k, :] for k in range(chunk))

    def body(c, carry):
        words, state = carry[:chunk], carry[chunk:]
        nxt = load_chunk(c + 1)                         # prefetch
        for k in range(chunk):
            state, (first, fcount, fval) = coder_step(words[k], *state)
            i = c * chunk + k
            first_ref[i, :] = first
            fcount_ref[i, :] = fcount
            fval_ref[i, :] = fval
        return (*nxt, *state)

    init = (*load_chunk(0),
            jnp.zeros((lanes,), jnp.int32),
            jnp.full((lanes,), 0xFF00, jnp.int32),
            jnp.full((lanes,), -1, jnp.int32),
            jnp.zeros((lanes,), jnp.int32))
    jax.lax.fori_loop(0, nchunks, body, init)


@functools.partial(jax.jit, static_argnames=("interpret",))
def rac_pallas_packed(opw, interpret: bool = False):
    """opw int32 [steps, lanes] packed op words (lanes % LANE_BLOCK == 0)
    -> staged (first, fcount, fval) int32 [steps, lanes], identical to
    rac_scan_lanes on the unpacked words."""
    check_kernel_platform("rac_pallas_packed", interpret)
    n, lanes = opw.shape
    if lanes % LANE_BLOCK:
        raise ValueError(f"lanes={lanes} is not a multiple of {LANE_BLOCK}")
    steps = -(-n // STEP_CHUNK) * STEP_CHUNK      # NOP-padded tail
    opw = jnp.pad(opw, ((0, steps - n), (0, 0)))
    spec = pl.BlockSpec((steps, LANE_BLOCK), lambda j: (0, j))
    out = pl.pallas_call(
        functools.partial(_coder_kernel, steps=steps, chunk=STEP_CHUNK),
        grid=(lanes // LANE_BLOCK,),
        in_specs=[spec],
        out_specs=(spec, spec, spec),
        out_shape=(jax.ShapeDtypeStruct((steps, lanes), jnp.int32),) * 3,
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ffv1_rac_coder",
    )(opw)
    return tuple(o[:n] for o in out)
