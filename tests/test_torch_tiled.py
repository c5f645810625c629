"""Port parity: the plain "tiled" render method (`ops/rasterize.py`
`_record_table`, `_gather_and_composite`; `ops/binning.py` `sort_pairs`,
`bin_gaussians`) against the JAX package's `render(method="tiled")`.

* Images: rgb, alpha and extra within 3e-5, depth within 3e-4 (the CPU
  rows of tests/fixtures/TOLERANCES.md), radii equal; also where each of
  the three drop counters is non-zero (a small pair capacity, a small
  per-tile list, few emission slots): both sides then drop the same pairs.
* The drop counters equal.
* `bin_gaussians` equal (starts, counts, the id lists per tile, counts of
  pairs and drops).
* Gradients of a weighted sum of rgb, depth and extra with respect to
  every input within 1e-4 of the largest |gradient| of their array (the
  sums over chunks and pixels run in another order).
* A training step config with method "tiled" renders through it.

Small sizes: 200-300 gaussians, 64x48, tile 8, chunk 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import binning as jbin
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import projection as jproj
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu_torch.ops import binning as tbin
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import projection as tproj
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.train.config import RasterSettings
from tests.scenes import random_scene

torch.set_num_threads(1)

ATOL_RGB, ATOL_DEPTH, GRAD_REL = 3e-5, 3e-4, 1e-4
BASE = dict(tile_h=8, tile_w=8, chunk=64, max_tiles_per_gaussian=16)
# each case drives one drop counter above zero, or none
CASES = {
    "lossless": dict(),
    "capacity": dict(pairs_per_gaussian=1),
    "tile_overflow": dict(max_per_tile=64),
    "rect": dict(max_tiles_per_gaussian=2),
}
COUNTER = {"capacity": "n_dropped_capacity",
           "tile_overflow": "n_dropped_tile_overflow",
           "rect": "n_dropped_rect"}
COUNTERS = ("n_dropped_capacity", "n_dropped_rect", "n_dropped_tile_overflow")


def _setup(n=300, seed=0, w=64, h=48, f=50.0):
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    arrays = random_scene(n, seed=seed, scale_hi=0.2)
    seg = np.random.RandomState(seed + 100).rand(n, 3).astype(np.float32)
    return (jcam.make_camera(w, h, k, w2c),
            tcam.make_camera(w, h, k, w2c, device="cpu"), arrays, seg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_image_and_counters_match_jax(case):
    jc, tc, arrays, seg = _setup(n=1500 if case == "capacity" else 300)
    kw = dict(BASE, **CASES[case])
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    j = jrast.render(jc, *map(jnp.asarray, arrays), method="tiled",
                     extra_channels=jnp.asarray(seg), bg=jnp.asarray(bg),
                     config=jrast.RasterConfig(**kw))
    t = trast.render(tc, *arrays, method="tiled", extra_channels=seg, bg=bg,
                     config=trast.RasterConfig(**kw), device="cpu")
    for key in COUNTERS:
        assert int(getattr(t, key)) == int(getattr(j, key)), key
    if case in COUNTER:
        assert int(getattr(t, COUNTER[case])) > 0
    else:
        assert all(int(getattr(t, key)) == 0 for key in COUNTERS)
    for key in ("rgb", "alpha", "extra"):
        np.testing.assert_allclose(getattr(t, key).numpy(),
                                   np.asarray(getattr(j, key)),
                                   atol=ATOL_RGB, err_msg=key)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth),
                               atol=ATOL_DEPTH)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))


def test_bin_gaussians_matches_jax():
    jc, tc, (means, _, _, scales, quats), _ = _setup()
    for cap, k in ((1024, 16), (2048, 4)):
        jb = jbin.bin_gaussians(
            jproj.project(jnp.asarray(means), jnp.asarray(scales),
                          jnp.asarray(quats), jc), 8, 8, 6, 8, cap, k)
        tb = tbin.bin_gaussians(
            tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                          torch.as_tensor(quats), tc), 8, 8, 6, 8, cap, k)
        for key in ("tile_starts", "tile_counts", "num_pairs",
                    "n_dropped_capacity", "n_dropped_rect"):
            np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                          np.asarray(getattr(jb, key)), key)
        assert tb.gaussian_ids.shape == (cap,)
        live = int(tb.tile_counts.sum())
        np.testing.assert_array_equal(tb.gaussian_ids[:live].numpy(),
                                      np.asarray(jb.gaussian_ids)[:live])


def test_tiled_gradients_match_jax():
    jc, tc, arrays, seg = _setup(n=200, seed=2)
    cfg = dict(BASE)
    rng = np.random.RandomState(7)
    ct_rgb = rng.normal(size=(48, 64, 3)).astype(np.float32)
    ct_depth = rng.normal(size=(48, 64)).astype(np.float32)
    ct_extra = rng.normal(size=(48, 64, 3)).astype(np.float32)

    def jloss(m, c, o, s, q, e):
        out = jrast.render(jc, m, c, o, s, q, extra_channels=e,
                           method="tiled", config=jrast.RasterConfig(**cfg))
        return (jnp.sum(out.rgb * ct_rgb) + jnp.sum(out.depth * ct_depth)
                + jnp.sum(out.extra * ct_extra))

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays), jnp.asarray(seg))
    ts = [torch.tensor(a, requires_grad=True) for a in (*arrays, seg)]
    out = trast.render(tc, *ts[:5], extra_channels=ts[5], method="tiled",
                       config=trast.RasterConfig(**cfg), device="cpu")
    loss = (torch.sum(out.rgb * torch.as_tensor(ct_rgb))
            + torch.sum(out.depth * torch.as_tensor(ct_depth))
            + torch.sum(out.extra * torch.as_tensor(ct_extra)))
    tgrads = torch.autograd.grad(loss, ts)
    for name, t, j in zip(("means", "colors", "opac", "scales", "quats",
                           "extra"), tgrads, jgrads):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-6)
        assert float(np.abs(j).max()) > 0, name
        np.testing.assert_allclose(t.numpy(), j, atol=GRAD_REL * scale,
                                   err_msg=name)


def test_train_config_takes_tiled():
    r = RasterSettings(method="tiled", max_per_tile=256,
                       pairs_per_gaussian=4)
    assert r.render_method() == "tiled"
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    from dynamic3dgaussians_tpu_torch.train.trainer import raster_config
    rc = raster_config(TrainConfig(raster=r))
    assert (rc.max_per_tile, rc.pairs_per_gaussian) == (256, 4)
    assert rc.pair_capacity(300) == jrast.RasterConfig(
        pairs_per_gaussian=4).pair_capacity(300)
