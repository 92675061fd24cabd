"""Multi-device sharding for the FFV1 device pipeline.

The codec's natural parallel axes map onto the mesh as:

* ``data``  — frame batching (the DP axis): independent frames/GOPs on
  different devices.
* ``slice`` — FFV1 slice partitioning (the "sequence/spatial parallel"
  axis): slices are independent coding units *by format design* (each has
  its own predictor ring, context states, and range coder; SURVEY.md
  section 2.3), so sharding them over devices needs no halo exchange at
  all for phase A, and per-slice bitstreams concatenate on the host —
  mirroring the slice-trailer assembly of the reference
  (ffv1enc.c:1236-1262).

Non-uniform slice rects are padded to a common shape by **edge
replication**, which is bit-exact: the only guard FFV1 reads beyond the
right edge is RT(x=w-1) := T(w-1) — exactly what a replicated column
provides; bottom padding is never read by the causal template.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ffv1.tpu import plane_context_diff, _wrap16


def make_mesh(devices=None, data: int = 1, slices: int | None = None):
    """Build a ("data", "slice") mesh over the given devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if slices is None:
        slices = n // data
    assert data * slices == n, f"{data}x{slices} != {n} devices"
    arr = np.array(devices).reshape(data, slices)
    return Mesh(arr, ("data", "slice"))


def uniform_slice_stack(plane: np.ndarray, prects, pad_to=None):
    """Stack per-slice crops of ``plane`` into [S, H, W] with edge-replicated
    padding to a common (or given) shape."""
    hs = [r[3] for r in prects]
    ws = [r[2] for r in prects]
    H = pad_to[0] if pad_to else max(hs)
    W = pad_to[1] if pad_to else max(ws)
    out = np.empty((len(prects), H, W), dtype=np.int32)
    for i, (x, y, w, h) in enumerate(prects):
        crop = plane[y:y + h, x:x + w]
        out[i, :h, :w] = crop
        if w < W:
            out[i, :h, w:] = crop[:, -1:]
        if h < H:
            out[i, h:, :] = out[i, h - 1:h, :]
    return out


def unstack_slices(stacked: np.ndarray, prects):
    """Undo uniform_slice_stack: list of [h, w] crops."""
    return [np.asarray(stacked[i, :h, :w])
            for i, (x, y, w, h) in enumerate(prects)]


@functools.partial(jax.jit,
                   static_argnames=("bits", "five", "mesh", "data_axis"))
def phase_a_sharded(crops, qt, bits, five, mesh, data_axis=False):
    """Phase A over a stacked slice batch, sharded across the mesh.

    ``crops``: int32 [S, H, W] (or [B, S, H, W] with data_axis=True),
    already int16-wrapped.  Each device computes its slice shard locally;
    there is no cross-device communication in phase A (slices are
    independent), which is the point: the ICI is reserved for the
    bitstream gather.
    """
    if data_axis:
        spec = P("data", "slice", None, None)
        vmapped = jax.vmap(jax.vmap(
            lambda s: plane_context_diff(s, qt, bits, five)))
    else:
        spec = P("slice", None, None)
        vmapped = jax.vmap(lambda s: plane_context_diff(s, qt, bits, five))

    fn = shard_map(vmapped, mesh=mesh, in_specs=(spec,),
                   out_specs=(spec, spec))
    return fn(crops)


def gather_slice_bytes(by, ln, axis="slice"):
    """The bitstream-assembly collective: every device contributes its
    local slices' padded byte buffers + exact lengths, and receives the
    full set, so any device (or the host, after one fetch) can lay the
    3-byte-trailer packet out — the parallel analogue of the reference's
    sequential slice-trailer walk (ffv1enc.c:1236-1262).

    Call from inside a shard_map body whose mesh has ``axis``; this is
    the collective `__graft_entry__.dryrun_multichip` and the sharded
    encode paths use (byte-identical assembly asserted there).
    """
    return (jax.lax.all_gather(by, axis), jax.lax.all_gather(ln, axis))
