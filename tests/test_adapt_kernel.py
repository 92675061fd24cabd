"""The Triton adaptation-walk kernel (interpret mode) against the plain
XLA reference walk, on the device encoder's own layouts."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import device_coder as dc
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config


def _walk_inputs(dev, planes):
    """A real adaptation-walk input: the encoder's own layout, placement
    and start states for one key frame (caps already grown by an
    encode of the same frame)."""
    import jax.numpy as jnp
    dev.encode(planes, force_keyframe=True)
    ctx, diff = dev._phase_a([jnp.asarray(q, jnp.int32) for q in planes])
    plan = dev._s_layout(ctx, diff, dev.tiles_cap, dev.cellrows_cap)
    ch1c, _ = dev._s_scatter(plan, dev.cellrows_cap)
    s0 = dev._s_s0(plan, jnp.full_like(dev.canonical, 128), dev.tiles_cap)
    return plan, (ch1c, plan["tile_caps"], plan["tile_bases"],
                  plan["tile_pred"], s0, jnp.asarray(dev.table))


@pytest.mark.parametrize("pix,wh,code_bits,gcap", [
    ("yuv420p", (64, 48), 8, None),
    ("yuv420p10", (48, 32), 10, None),
    ("yuv444p16", (24, 16), 16, None),          # slot 10/31 repeat steps
    ("yuv420p", (64, 48), 8, 64),               # split groups: carry[pred]
])
def test_adapt_pallas_interpret_matches_reference(monkeypatch, pix, wh,
                                                  code_bits, gcap):
    """Triton adaptation-walk kernel (interpret mode) == the XLA
    reference walk on the encoder's own layout: sv words of every live
    row and every tile's end states."""
    from ffmpeg_ffv2_tpu.ffv1.adapt_pallas import adapt_pallas
    if gcap:
        monkeypatch.setattr(dc, "GCAP", gcap)
    w, h = wh
    cfg = FFV1Config(level=3, coder=1, slices=4)
    dev = dc.DeviceFFV1Encoder(w, h, pix, cfg)
    assert dev.code_bits == code_bits
    p = dev.p
    shapes = [(h, w)]
    if p.chroma_planes:
        shapes += [(h >> p.chroma_v_shift, w >> p.chroma_h_shift)] * 2
    if gcap:          # gradients: few large context groups that split
        planes = [(np.mgrid[0:s[0], 0:s[1]][1] // 8 * 8 % 256)
                  .astype(np.int32) for s in shapes]
    else:
        rng = np.random.RandomState(5)
        planes = [rng.randint(0, 1 << p.bits, s).astype(np.int32)
                  for s in shapes]
    plan, args = _walk_inputs(dev, planes)
    if gcap:
        assert int(np.max(np.asarray(plan["tile_pred"]))) >= 0
    ref_sv, ref_end = dc.adapt_reference(*args, dev.tiles_cap,
                                         code_bits=code_bits)
    got_sv, got_end = adapt_pallas(*args, dev.tiles_cap, dev.cellrows_cap,
                                   code_bits=code_bits, interpret=True)
    nr = int(np.asarray(plan["n_rows"]))
    assert np.array_equal(np.asarray(got_sv)[:nr], np.asarray(ref_sv)[:nr])
    assert np.array_equal(np.asarray(got_end), np.asarray(ref_end))
