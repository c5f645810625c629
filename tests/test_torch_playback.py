"""Port parity: cached-order playback (`ops/playback.py`).

* The float-bits (tile, depth) key, its dequantization and the f16
  transport of the record rows, bitwise against the JAX package.
* `build_cache` against JAX's: the same tile segments (starts, counts) and,
  per tile, the same set of gaussian ids (the sorts are unstable, so equal
  keys may come in another order; the port keeps only the live pairs).
* `render_playback` against JAX's (its Pallas kernel in interpret mode) on a
  fresh cache, a stale one and with a background and extra channels:
  rgb, alpha and extra within 2e-4, depth within 1e-3. Both transport the
  conic, opacity and channels in f16; a float32 rounding difference in the
  projection can move one f16 rounding step (~5e-4 relative), which shows
  as a few 1e-5 in the image. `n_active` and `log_t` are not compared
  (JAX's interpret-mode stop rule, ROADMAP.md §3).
* Fresh playback against the port's exact render within one 8-bit quantum
  (3.9e-3; depth 2e-2 + 1e-3 relative), the bounds of
  tests/test_playback.py.
* `orbit_render(resort_every=2)` against JAX's frame by frame (uint8, one
  level), and against the exact orbit at JAX's PSNR bounds (min > 35 dB,
  mean > 50 dB).

Small sizes: 300 gaussians, 64x48, tile 8, chunk 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import playback as jpb
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.ops import sorted_raster as jsr
from dynamic3dgaussians_tpu.viz import render as jvr
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import playback as tpb
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops import sorted_raster as tsr
from dynamic3dgaussians_tpu_torch.viz import render as tvr
from tests.scenes import random_scene

torch.set_num_threads(1)

JCFG = jrast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                          max_tiles_per_gaussian=16)
TCFG = trast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                          max_tiles_per_gaussian=16)
ATOL_JAX, ATOL_JAX_DEPTH = 2e-4, 1e-3
QUANTUM = 3.9e-3


def _cams(dx=0.0, w=64, h=48):
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    w2c[0, 3] = dx
    k = [[60, 0, w / 2], [0, 60, h / 2], [0, 0, 1]]
    return jcam.make_camera(w, h, k, w2c), tcam.make_camera(w, h, k, w2c,
                                                            device="cpu")


def _geom(a):
    return a[0], a[2], a[3], a[4]


def _caches(a, jc, tc):
    j = jpb.build_cache(jc, *map(jnp.asarray, _geom(a)), config=JCFG)
    t = tpb.build_cache(tc, *_geom(a), config=TCFG, device="cpu")
    return j, t


@pytest.mark.parametrize("bits_z", [18, 21, 27])
def test_float_bits_key_and_f16_transport_bitwise(bits_z):
    rng = np.random.RandomState(bits_z)
    depth = rng.uniform(0.01, 100.0, 2000).astype(np.float32)
    depth[:6] = [0.0, -1.0, np.inf, 1e-40, 3e38, 65519.0]
    tile = rng.randint(0, 1 << (31 - bits_z), 2000).astype(np.int32)
    jk = np.asarray(jsr.fuse_tile_depth_key(jnp.asarray(tile),
                                            jnp.asarray(depth), bits_z))
    tk = tsr.fuse_tile_depth_key(torch.as_tensor(tile),
                                 torch.as_tensor(depth), bits_z)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(
        tsr.dequantize_depth_key(tk, bits_z).numpy(),
        np.asarray(jsr.dequantize_depth_key(jnp.asarray(jk), bits_z)))
    # f16 round trip: conic rows past 65504 overflow to inf on both sides
    x = np.concatenate([rng.normal(0, 300, 999), [7e4, -7e4, 65519.0,
                                                  65520.0, 1e-8]])
    x = x.astype(np.float32)
    ja, jb = jsr.unpack2_f16(jsr.pack2_f16(jnp.asarray(x[:502]),
                                           jnp.asarray(x[502:])))
    want = np.concatenate([np.asarray(ja), np.asarray(jb)])
    got = tsr.round_f16(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_build_cache_matches_jax():
    a = random_scene(300, seed=0)
    jc, tc = _cams()
    j, t = _caches(a, jc, tc)
    np.testing.assert_array_equal(t.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert int(t.n_dropped_rect) == int(j.n_dropped_rect) == 0
    n_live = int(t.counts.sum())
    assert t.gidx.shape == (n_live,) and n_live > 300
    jg, tg = np.asarray(j.gidx), t.gidx.numpy()
    for s, c in zip(t.starts.numpy(), t.counts.numpy()):
        assert sorted(tg[s:s + c]) == sorted(jg[s:s + c])


@pytest.mark.parametrize("case", ["fresh", "stale", "bg_extra"])
def test_render_playback_matches_jax(case):
    a = random_scene(300, seed=3)
    jc, tc = _cams()
    j_cache, t_cache = _caches(a, jc, tc)
    kw_j, kw_t = {}, {}
    if case == "stale":     # ~ one orbit step of camera motion
        jc, tc = _cams(0.01)
    if case == "bg_extra":
        bg = np.array([0.2, 0.1, 0.3], np.float32)
        seg = np.random.RandomState(0).rand(300, 3).astype(np.float32)
        kw_j = dict(bg=jnp.asarray(bg), extra_channels=jnp.asarray(seg))
        kw_t = dict(bg=bg, extra_channels=seg)
    j = jpb.render_playback(jc, *map(jnp.asarray, a), j_cache, config=JCFG,
                            **kw_j)
    t = tpb.render_playback(tc, *a, t_cache, config=TCFG, device="cpu",
                            **kw_t)
    for key in ("rgb", "alpha") + (("extra",) if kw_t else ()):
        np.testing.assert_allclose(getattr(t, key).numpy(),
                                   np.asarray(getattr(j, key)),
                                   atol=ATOL_JAX, err_msg=key)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth),
                               atol=ATOL_JAX_DEPTH)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    assert float(t.alpha.max()) > 0.5


def test_fresh_playback_matches_exact_render():
    a = random_scene(300, seed=0)
    _, tc = _cams()
    bg = [0.2, 0.1, 0.3]
    seg = np.random.RandomState(1).rand(300, 3).astype(np.float32)
    cache = tpb.build_cache(tc, *_geom(a), config=TCFG, device="cpu")
    pb = tpb.render_playback(tc, *a, cache, config=TCFG, bg=bg,
                             extra_channels=seg, device="cpu")
    exact = trast.render(tc, *a, config=TCFG, bg=bg, extra_channels=seg,
                         device="cpu")
    for key in ("rgb", "alpha", "extra"):
        np.testing.assert_allclose(getattr(pb, key).numpy(),
                                   getattr(exact, key).numpy(),
                                   atol=QUANTUM, err_msg=key)
    np.testing.assert_allclose(pb.depth.numpy(), exact.depth.numpy(),
                               atol=2e-2, rtol=1e-3)


def _orbit_scene():
    rng = np.random.RandomState(0)
    n = 150
    return {
        "means3D": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.uniform(0, 2, (n, 1)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.03, 0.1, (n, 3))
                             ).astype(np.float32),
    }


def test_orbit_render_resort_every_matches_jax_and_exact():
    stacked = _orbit_scene()
    kw = dict(n_frames=48, w=64, h=48, f=55.0, radius=3.0)
    jfast = jvr.orbit_render(stacked, method="pallas", resort_every=2,
                             config=JCFG, **kw)
    fast = tvr.orbit_render(stacked, resort_every=2, config=TCFG,
                            device="cpu", **kw)
    exact = tvr.orbit_render(stacked, config=TCFG, device="cpu", **kw)
    assert len(fast) == len(jfast) == 48
    for a, b in zip(fast, jfast):
        assert np.abs(a.astype(np.int16) - b).max() <= 1
    ps = []
    for a, b in zip(exact, fast):
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        ps.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
    assert min(ps) > 35.0 and float(np.mean(ps)) > 50.0, (min(ps),
                                                          np.mean(ps))
