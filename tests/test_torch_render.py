"""Port parity: whole renders against the JAX package and the fixtures.

* `render(method="torch")` against the JAX `render(method="pallas")` (its
  Pallas kernel in interpret mode) with the total depth order, so that the
  unstable sorts cannot order equal keys differently, and with the default
  quantized key;
* `method="reference"` on both sides (the O(N*H*W) oracle);
* the frozen `tests/fixtures/golden_render_*.npz` forward outputs, at the
  CPU rows of `tests/fixtures/TOLERANCES.md` (RGB/alpha 3e-5, depth 3e-4,
  radii exact).

Every reference-side render asserts n_dropped_rect == 0: a render with
drops is no valid target.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.ops import sorted_raster as jsr
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops import sorted_raster as tsr
from tests.scenes import random_scene

torch.set_num_threads(1)

ATOL_RGB, ATOL_DEPTH = 3e-5, 3e-4
FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "golden_render_*.npz")))


def _scene(n=150, seed=0, w=64, h=48, f=50.0):
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    arrays = random_scene(n, seed=seed)
    seg = np.random.RandomState(seed + 100).rand(n, 3).astype(np.float32)
    return (jcam.make_camera(w, h, k, w2c),
            tcam.make_camera(w, h, k, w2c, device="cpu"), arrays, seg)


def _compare(t, j, extra=True):
    np.testing.assert_allclose(t.rgb.numpy(), np.asarray(j.rgb),
                               atol=ATOL_RGB)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha),
                               atol=ATOL_RGB)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth),
                               atol=ATOL_DEPTH)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    if extra:
        np.testing.assert_allclose(t.extra.numpy(), np.asarray(j.extra),
                                   atol=ATOL_RGB)
    assert int(j.n_dropped_rect) == 0
    assert int(t.n_dropped_rect) == 0


@pytest.mark.parametrize("depth_mode,fused_key", [
    ("total", True), ("quantized", True), ("total", False)])
def test_torch_matches_pallas(depth_mode, fused_key):
    jc, tc, arrays, seg = _scene()
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    jcfg = jrast.RasterConfig(depth_mode=depth_mode, fused_key=fused_key)
    tcfg = trast.RasterConfig(depth_mode=depth_mode, fused_key=fused_key)
    j = jrast.render(jc, *map(jnp.asarray, arrays), method="pallas",
                     config=jcfg, bg=jnp.asarray(bg),
                     extra_channels=jnp.asarray(seg))
    t = trast.render(tc, *map(torch.as_tensor, arrays), method="torch",
                     config=tcfg, bg=torch.as_tensor(bg),
                     extra_channels=torch.as_tensor(seg), device="cpu")
    _compare(t, j)
    assert float(t.alpha.max()) > 0.5


def test_reference_matches_jax_reference_and_torch_path():
    jc, tc, arrays, seg = _scene(n=120, seed=1)
    j = jrast.render(jc, *map(jnp.asarray, arrays), method="reference",
                     extra_channels=jnp.asarray(seg))
    t = trast.render(tc, *map(torch.as_tensor, arrays), method="reference",
                     extra_channels=torch.as_tensor(seg), device="cpu")
    _compare(t, j)
    s = trast.render(tc, *map(torch.as_tensor, arrays), method="torch",
                     extra_channels=torch.as_tensor(seg), device="cpu")
    for name in ("rgb", "alpha", "extra"):
        torch.testing.assert_close(getattr(s, name), getattr(t, name),
                                   atol=ATOL_RGB, rtol=0)
    torch.testing.assert_close(s.depth, t.depth, atol=ATOL_DEPTH, rtol=0)


@pytest.mark.parametrize("variant", ["sh3", "cov3d_precomp",
                                     "scale_modifier"])
def test_render_inputs_match_jax_reference(variant):
    jc, tc, (means, colors, opac, scales, quats), _ = _scene(n=100, seed=2)
    kw_j, kw_t = {}, {}
    if variant == "sh3":
        sh = np.random.RandomState(7).normal(0, 0.4, (100, 16, 3))
        kw_j = dict(sh=jnp.asarray(sh, jnp.float32), sh_degree=3)
        kw_t = dict(sh=torch.as_tensor(sh, dtype=torch.float32),
                    sh_degree=3)
    elif variant == "cov3d_precomp":
        from dynamic3dgaussians_tpu.ops.projection import build_cov3d
        cov = np.array(build_cov3d(jnp.asarray(scales), jnp.asarray(quats)))
        kw_j = dict(cov3d_precomp=jnp.asarray(cov))
        kw_t = dict(cov3d_precomp=torch.as_tensor(cov))
        scales = quats = None
    else:
        kw_j = kw_t = dict(scale_modifier=0.7)

    def j_(a):
        return None if a is None else jnp.asarray(a)

    def t_(a):
        return None if a is None else torch.as_tensor(a)
    j = jrast.render(jc, j_(means), j_(colors), j_(opac), j_(scales),
                     j_(quats), method="reference", **kw_j)
    t = trast.render(tc, t_(means), t_(colors), t_(opac), t_(scales),
                     t_(quats), method="torch", device="cpu", **kw_t)
    _compare(t, j, extra=False)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_matches_frozen_fixture(path):
    fx = dict(np.load(path))
    w, h, f = int(fx["w"]), int(fx["h"]), float(fx["f"])
    cam = tcam.make_camera(w, h, [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                           fx["w2c"], device="cpu")
    cfg = trast.RasterConfig(tile_h=16, tile_w=16, chunk=128,
                             max_tiles_per_gaussian=int(fx["k_cap"]))
    kw = {}
    if "extra_in" in fx:
        kw["extra_channels"] = torch.as_tensor(fx["extra_in"])
    args = [torch.as_tensor(fx[k]) for k in ("means", "colors", "opac",
                                             "scales", "quats")]
    out = trast.render(cam, *args, method="torch", config=cfg, device="cpu",
                       **kw)
    assert int(out.n_dropped_rect) == 0
    np.testing.assert_allclose(out.rgb.numpy(), fx["rgb"], atol=ATOL_RGB)
    np.testing.assert_allclose(out.alpha.numpy(), fx["alpha"], atol=ATOL_RGB)
    np.testing.assert_allclose(out.depth.numpy(), fx["depth"],
                               atol=ATOL_DEPTH)
    np.testing.assert_array_equal(out.radii.numpy(), fx["radii"])
    if "extra" in fx:
        np.testing.assert_allclose(out.extra.numpy(), fx["extra"],
                                   atol=ATOL_RGB * 3)


@pytest.mark.parametrize("num_tiles", [1, 12, 920, 3600, 2 ** 13 - 1,
                                       2 ** 13])
def test_depth_key_bits_matches(num_tiles):
    assert tsr.depth_key_bits(num_tiles) == jsr.depth_key_bits(num_tiles)


@pytest.mark.parametrize("bits_z", [18, 21, 25])
def test_affine_key_matches(bits_z):
    rng = np.random.RandomState(bits_z)
    n = 400
    tiles = rng.randint(0, 40, n).astype(np.int32)
    depth = rng.uniform(0.5, 9.0, n).astype(np.float32)
    depth[:3] = [0.5, 9.0, 9.0]          # extremes, u == 0 and u == 1
    live = rng.uniform(size=n) > 0.1
    live[:3] = True
    jd, jw = jsr.affine_depth_range(jnp.asarray(live), jnp.asarray(depth))
    td, tw = tsr.affine_depth_range(torch.as_tensor(live),
                                    torch.as_tensor(depth))
    assert float(td) == float(jd) and float(tw) == float(jw)
    jk = jsr.fuse_tile_depth_key_affine(jnp.asarray(tiles),
                                        jnp.asarray(depth), bits_z, jd, jw)
    tk = tsr.fuse_tile_depth_key_affine(torch.as_tensor(tiles),
                                        torch.as_tensor(depth), bits_z, td,
                                        tw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(tk.min()) >= 0
    assert ((tk.numpy() >> bits_z) == tiles).all()   # no overflow into tiles
    np.testing.assert_array_equal(
        tsr.dequantize_depth_key_affine(tk, bits_z, td, tw).numpy(),
        np.asarray(jsr.dequantize_depth_key_affine(jk, bits_z, jd, jw)))


def test_render_refuses_gradients():
    """Under torch.no_grad() a render carries no graph, even from inputs
    that require grad, so asking it for gradients raises."""
    _, tc, arrays, _ = _scene(n=20)
    means = torch.as_tensor(arrays[0]).requires_grad_(True)
    rest = [torch.as_tensor(a) for a in arrays[1:]]
    with torch.no_grad():
        out = trast.render(tc, means, *rest, device="cpu")
    assert not out.rgb.requires_grad and out.rgb.grad_fn is None
    with pytest.raises(RuntimeError):
        torch.autograd.grad(out.rgb.sum(), means)


def test_render_gradients_flow_to_inputs():
    """With gradients on, the render carries a graph back to its inputs;
    its values are those of the render under no_grad (test_torch_grad.py
    holds the gradients themselves)."""
    _, tc, arrays, _ = _scene(n=20)
    means = torch.as_tensor(arrays[0]).requires_grad_(True)
    rest = [torch.as_tensor(a) for a in arrays[1:]]
    with torch.no_grad():
        out = trast.render(tc, means, *rest, device="cpu")
    live = trast.render(tc, means, *rest, device="cpu")
    assert live.rgb.requires_grad
    torch.testing.assert_close(live.rgb.detach(), out.rgb, atol=0, rtol=0)
    (g,) = torch.autograd.grad(live.rgb.sum(), means)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.parametrize("kwargs,exc", [
    (dict(method="cuda"), ValueError),
    (dict(method="pallas"), ValueError),
    (dict(config="depth_mode"), ValueError),
])
def test_render_rejects_bad_options(kwargs, exc):
    _, tc, arrays, _ = _scene(n=20)
    if kwargs.get("config") == "depth_mode":
        with pytest.raises(exc):
            trast.RasterConfig(depth_mode="float")
        return
    with pytest.raises(exc):
        trast.render(tc, *map(torch.as_tensor, arrays), device="cpu",
                     **kwargs)
