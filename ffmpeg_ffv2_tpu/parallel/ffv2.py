"""Multi-device sharding for the FFV2 device front-end.

FFV2's parallel unit is the superblock: transforms, zigzag, and PVQ
quantization are per-SB-block, but the lapped pre-filter crosses SB
boundaries with a 32-sample (16 each side) support
(/root/reference/libavcodec/ffv2enc.c:345-366 runs the frame-wide
lap_filter_frame_{hor,ver} before the per-SB transform loop).  Sharding
the frame into contiguous SB-row bands therefore needs exactly ONE halo
exchange: the vertical lapped filter at each inter-shard boundary reads
16 rows from each neighbour.  The exchange rides ``jax.lax.ppermute``
over the mesh's ``slice`` axis — the ICI-native form of the boundary
region the reference's threaded filter would share through memory.

Byte-identity contract: the sharded front returns the SAME
(dc, pulses, igain) arrays as ``ffv2.tpu.encode_front_q`` on one device
(same Q12 arithmetic, same filter support, same block raster order —
shard bands are contiguous row bands, so concatenating per-shard block
streams IS the global raster order), hence the entropy coder emits
byte-identical packets.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ffv2 import dsp
from ..ffv2.tpu import (_jx_frame_hor, _jx_frame_ver, _jx_lap_prefilter,
                        _tx_batch, _quantize_streams)

RADIUS = 32
HALF = RADIUS // 2


def _filter_slab(slab):
    """Vertical lapped prefilter of one 32-row boundary slab
    [P, 32, W] (the transpose dance of _jx_frame_ver for a single
    boundary)."""
    x = jnp.swapaxes(slab, -1, -2)            # [P, W, 32]
    return jnp.swapaxes(_jx_lap_prefilter(x, RADIUS), -1, -2)


def _front_q_local(c, idx, n_shards, sb, n, qp, bands):
    """One shard's [P, Hloc, W] Q12+hor-filtered band -> packed
    quantized streams (mirrors tpu._encode_front_q after the filters).

    The halo exchange: shard k sends its bottom 16 PRE-filter rows down
    (k -> k+1) and its top 16 up (k -> k-1); each shard then owns both
    of its boundary slabs and keeps its half of the filtered result.
    Interior SB boundaries are local (sb >= 32 keeps interior and
    boundary supports disjoint)."""
    P_, hl, w = c.shape
    up = jax.lax.ppermute(          # shard k receives k-1's bottom rows
        c[:, hl - HALF:, :], "slice",
        [(i, i + 1) for i in range(n_shards - 1)])
    dn = jax.lax.ppermute(          # shard k receives k+1's top rows
        c[:, :HALF, :], "slice",
        [(i + 1, i) for i in range(n_shards - 1)])
    top_slab = _filter_slab(jnp.concatenate([up, c[:, :HALF, :]], axis=1))
    bot_slab = _filter_slab(jnp.concatenate([c[:, hl - HALF:, :], dn],
                                            axis=1))
    c = _jx_frame_ver(c, sb, RADIUS, True)          # interior boundaries
    c = c.at[:, :HALF, :].set(
        jnp.where(idx > 0, top_slab[:, HALF:, :], c[:, :HALF, :]))
    c = c.at[:, hl - HALF:, :].set(
        jnp.where(idx < n_shards - 1, bot_slab[:, :HALF, :],
                  c[:, hl - HALF:, :]))

    nby, nbx = hl // n, w // n
    blocks = c.reshape(P_, nby, n, nbx, n).transpose(1, 3, 0, 2, 4)
    streams = _tx_batch(blocks.reshape(-1, n, n), n, dsp.TX_DCT, False)
    order = jnp.asarray(dsp.scan_order(n))
    streams = streams.reshape(streams.shape[0], -1)[:, order]
    dc, pulses, sums = _quantize_streams(streams, qp, bands, n)
    nb = dc.shape[0]
    head = jnp.concatenate(
        [jax.lax.bitcast_convert_type(dc, jnp.uint8).reshape(nb, -1),
         jax.lax.bitcast_convert_type(sums, jnp.uint8).reshape(nb, -1)],
        axis=1)
    return jnp.concatenate([head, pulses.astype(jnp.uint8)], axis=1)


def encode_front_q_sharded(planes_padded: np.ndarray, depth: int,
                           qp: int, band_starts, mesh: Mesh,
                           sb: int | None = None, n: int | None = None):
    """Sharded twin of ``ffv2.tpu.encode_front_q``: the frame's SB rows
    are banded over the mesh's ``slice`` axis; returns identical
    (dc, pulses, igain).  planes_padded: int [P, ph, pw] with ph a
    multiple of n_shards * sb."""
    sb = sb or dsp.SB_SIZE
    n = n or sb
    n_shards = mesh.shape["slice"]
    P_, ph, pw = planes_padded.shape
    assert ph % (n_shards * sb) == 0, (
        f"plane height {ph} must split into {n_shards} SB-row bands")
    bands = tuple(band_starts)
    qp = int(qp)

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(None, "slice", None),),
        out_specs=P("slice", None))
    def run(pl):
        c = (pl.astype(jnp.int32) << (12 - depth)) - 2048
        c = _jx_frame_hor(c, sb, RADIUS, True)
        idx = jax.lax.axis_index("slice")
        return _front_q_local(c, idx, n_shards, sb, n, qp, bands)

    packed = np.asarray(jax.jit(run)(jnp.asarray(planes_padded)))
    nbands = len(bands) - 1            # band_starts carries the end mark
    nb = packed.shape[0]
    dc = packed[:, :4].copy().view(np.int32).reshape(nb)
    sums = packed[:, 4:4 + nbands * 12].copy().view(np.int32) \
        .reshape(nb, nbands, 3).astype(np.int64)
    pulses = packed[:, 4 + nbands * 12:].view(np.int8)
    igain = (sums[..., 0] << 18) + (sums[..., 1] << 10) + sums[..., 2]
    return dc, pulses, igain
