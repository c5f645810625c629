"""Port parity: checkpoints, parameter conversion and the offline renders.

The stacked params.npz layout is shared with the JAX package both ways;
`orbit_render` frames agree with the JAX package's (its Pallas kernel in
interpret mode) within one uint8 level, exact and through cached-order
playback; trajectory tails, rotation whiskers, the RGB-D point-cloud lift
and the line drawing agree with JAX's (float64 host maths: 1e-6; drawn
frames equal); the timestep playback generator's frames agree with JAX's
within one uint8 level (depth colormaps: 2 % of the pixels may differ by
the colormap's percentile stretch); the port's `cli visualize` writes a GIF
on the CPU, with --resort-every too.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.models import gaussians as jg
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.viz import export as jexp
from dynamic3dgaussians_tpu.viz import render as jvr
from dynamic3dgaussians_tpu_torch import cli, convert
from dynamic3dgaussians_tpu_torch.models import gaussians as tg
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.viz import export as texp
from dynamic3dgaussians_tpu_torch.viz import render as tvr

torch.set_num_threads(1)


def _steps(n=50, seed=2, timesteps=3):
    rng = np.random.RandomState(seed)
    t0 = {"means3D": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
          "rgb_colors": rng.rand(n, 3).astype(np.float32),
          "seg_colors": rng.rand(n, 3).astype(np.float32),
          "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
          "logit_opacities": rng.uniform(-1, 2, (n, 1)).astype(np.float32),
          "log_scales": np.log(rng.uniform(0.03, 0.1, (n, 3))
                               ).astype(np.float32),
          "cam_m": np.zeros((5, 3), np.float32),
          "cam_c": np.zeros((5, 3), np.float32)}
    steps = [t0]
    for i in range(1, timesteps):
        steps.append({"means3D": t0["means3D"] + 0.05 * i,
                      "rgb_colors": t0["rgb_colors"],
                      "unnorm_rotations": t0["unnorm_rotations"]})
    return steps


def test_params_npz_layout_shared_with_jax(tmp_path):
    steps = _steps()
    p_t = texp.save_params(steps, str(tmp_path / "t"))
    p_j = jexp.save_params(steps, str(tmp_path / "j"))
    a, b = texp.load_params(p_t), jexp.load_params(p_j)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    # stacked keys carry a leading T axis, t0-only keys do not
    assert a["means3D"].shape == (3, 50, 3)
    assert a["log_scales"].shape == (50, 3)
    # each side reads the other's file
    for k, v in texp.load_params(p_j).items():
        np.testing.assert_array_equal(v, jexp.load_params(p_t)[k])


def test_params_at_t_matches_jax():
    stacked = {k: v for k, v in _stack(_steps()).items()}
    for t in range(3):
        a, b = tvr.params_at_t(stacked, t), jvr.params_at_t(stacked, t)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _stack(steps):
    later = set(steps[1])
    return {k: (np.stack([s[k] for s in steps]) if k in later else v)
            for k, v in steps[0].items()}


def test_params_from_jax_and_activated_match():
    steps = _steps(n=40)
    jparams = {k: jnp.asarray(v) for k, v in steps[0].items()}
    host = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_jax(host, device="cpu")
    for k, v in tparams.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), host[k])
    alive = np.arange(40) < 35
    ja = jg.activated(jparams, jnp.asarray(alive))
    ta = tg.activated(tparams, torch.as_tensor(alive))
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    x = np.array([0.1, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(tg.inverse_sigmoid(torch.as_tensor(x)).numpy(),
                               np.asarray(jg.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6)
    assert tg.GAUSSIAN_KEYS == jg.GAUSSIAN_KEYS


def test_raster_config_from_jax():
    jcfg = jrast.RasterConfig(tile_h=8, chunk=64, max_tiles_per_gaussian=16,
                              depth_mode="total", exact_cull=False,
                              scan_impl="matmul_highest", tile_batch=4)
    tcfg = convert.raster_config_from_jax(jcfg)
    for f in dataclasses.fields(trast.RasterConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert convert.raster_config_from_jax(jrast.RasterConfig()) == \
        trast.RasterConfig()


@pytest.mark.parametrize("override", [dict(pack_records=True),
                                      dict(power_impl="mxu_fused"),
                                      dict(kernel_precision="default")])
def test_raster_config_from_jax_refuses_numeric_changes(override):
    """The settings that change the numerics, refused before they were
    ported, are carried, and a render with each matches the reference's
    (its Pallas kernels in interpret mode): RGB and alpha within 3e-5 (the
    CPU row of tests/fixtures/TOLERANCES.md). kernel_precision="default"
    is a single bf16 pass of the value product in the port, but float32
    in the reference's CPU run (XLA ignores the precision there): each
    output then differs by at most 2 2^-8 sum |w| |v| <= 2^-7 (sum w <= 1,
    colours and the ones row in [0, 1]), plus the 3e-5."""
    from tests.scenes import random_scene
    jcfg = jrast.RasterConfig(depth_mode="total").replace(**override)
    tcfg = convert.raster_config_from_jax(jcfg)
    for name, value in override.items():
        assert getattr(tcfg, name) == value
    k = [[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    arrays = random_scene(120, seed=5)
    j = jrast.render(jcam.make_camera(64, 48, k, w2c),
                     *map(jnp.asarray, arrays), method="pallas", config=jcfg)
    t = trast.render(tcam.make_camera(64, 48, k, w2c, device="cpu"),
                     *map(torch.as_tensor, arrays), method="torch",
                     config=tcfg, device="cpu")
    atol = 3e-5 + (2.0 ** -7 if "kernel_precision" in override else 0.0)
    for key in ("rgb", "alpha"):
        np.testing.assert_allclose(getattr(t, key).numpy(),
                                   np.asarray(getattr(j, key)), atol=atol,
                                   err_msg=key)
    assert int(j.n_dropped_rect) == int(t.n_dropped_rect) == 0
    assert float(t.alpha.max()) > 0.5


def test_orbit_render_matches_jax():
    stacked = _stack(_steps(n=60, seed=5, timesteps=2))
    kw = dict(n_frames=3, w=64, h=48, f=40.0, radius=3.5)
    j = jvr.orbit_render(stacked, method="pallas", **kw)
    t = tvr.orbit_render(stacked, device="cpu", **kw)
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert a.dtype == np.uint8 and a.shape == (48, 64, 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1
    assert max(f.max() for f in t) > 0


def test_orbit_render_refuses_cached_playback():
    """resort_every > 1, which the port refused before cached-order
    playback was ported, now renders through it and matches JAX frame by
    frame: cached frames at a fixed timestep (the viewer's case), and a
    timestep per frame (every frame rebuilds the cache, as in JAX)."""
    stacked = _stack(_steps(n=60, seed=5, timesteps=2))
    for per_frame in (False, True):
        kw = dict(n_frames=5, w=64, h=48, f=40.0, radius=3.5,
                  resort_every=2, timestep_per_frame=per_frame)
        j = jvr.orbit_render(stacked, **kw)
        t = tvr.orbit_render(stacked, device="cpu", **kw)
        assert len(t) == len(j) == 5
        for a, b in zip(t, j):
            assert a.shape == (48, 64, 3)
            assert np.abs(a.astype(np.int16) - b).max() <= 1
        assert max(f.max() for f in t) > 0


def _fg_stack(n=120, timesteps=4, seed=7):
    rng = np.random.RandomState(seed)
    steps = _steps(n=n, seed=seed, timesteps=timesteps)
    for i, s in enumerate(steps[1:], 1):
        s["unnorm_rotations"] = rng.normal(size=(n, 4)).astype(np.float32)
        s["means3D"] = (steps[0]["means3D"]
                        + rng.normal(0, 0.05 * i, (n, 3))).astype(np.float32)
    stacked = _stack(steps)
    stacked["seg_colors"][:, 0] = (np.arange(n) % 3 != 0).astype(np.float32)
    return stacked


@pytest.mark.parametrize("t", [0, 2, 3])
def test_line_overlays_match_jax(t):
    stacked = _fg_stack()
    for kw in (dict(), dict(traj_length=2, stride=5)):
        a = tvr.trajectory_lines(stacked, t, **kw)
        b = jvr.trajectory_lines(stacked, t, **kw)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6)
    a = tvr.rotation_vector_lines(stacked, t, stride=4)
    b = jvr.rotation_vector_lines(stacked, t, stride=4)
    assert a.shape == b.shape and a.shape[1:] == (2, 3)
    np.testing.assert_allclose(a, b, atol=1e-6)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    k = [[40, 0, 32], [0, 40, 24], [0, 0, 1]]
    tc = tcam.make_camera(64, 48, k, w2c, device="cpu")
    jc = jcam.make_camera(64, 48, k, w2c)
    img = np.random.RandomState(t).randint(0, 255, (48, 64, 3), np.uint8)
    segs = np.concatenate([tvr.trajectory_lines(stacked, 3, stride=3), a])
    np.testing.assert_array_equal(tvr.draw_lines(img, segs, tc),
                                  jvr.draw_lines(img, segs, jc))


def test_rgbd_to_pointcloud_matches_jax():
    rng = np.random.RandomState(4)
    rgb = rng.rand(12, 16, 3).astype(np.float32)
    depth = rng.uniform(1, 5, (12, 16)).astype(np.float32)
    alpha = rng.uniform(0, 1, (12, 16)).astype(np.float32)
    k = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]])
    c2w = np.linalg.inv(np.array([[0, 1, 0, 0.3], [-1, 0, 0, 0.1],
                                  [0, 0, 1, 2.0], [0, 0, 0, 1]]))
    for kw in (dict(), dict(alpha=alpha, c2w=c2w)):
        pa, ca = tvr.rgbd_to_pointcloud(
            torch.as_tensor(rgb), torch.as_tensor(depth), k,
            **{n: torch.as_tensor(v) for n, v in kw.items()})
        pb, cb = jvr.rgbd_to_pointcloud(rgb, depth, k, **kw)
        assert pa.shape == pb.shape and pa.shape[0] > 0
        np.testing.assert_allclose(pa, pb, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("mode", ["color", "depth", "centers"])
def test_playback_generator_matches_jax(mode):
    stacked = _fg_stack(n=80, timesteps=3)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    k = [[40, 0, 32], [0, 40, 24], [0, 0, 1]]
    kw = dict(mode=mode, show_trajectories=True, show_rotations=True,
              max_frames=2, fps=1000.0, realtime=True)
    jf = list(jvr.playback(stacked, jcam.make_camera(64, 48, k, w2c),
                           config=jrast.RasterConfig(
                               max_tiles_per_gaussian=64), **kw))
    tf = list(tvr.playback(stacked, tcam.make_camera(64, 48, k, w2c,
                                                     device="cpu"),
                           config=trast.RasterConfig(
                               max_tiles_per_gaussian=64), **kw))
    assert len(tf) == len(jf) == 2
    for a, b in zip(tf, jf):
        assert a.shape == b.shape == (48, 64, 3) and a.dtype == np.uint8
        diff = np.abs(a.astype(np.int16) - b)
        if mode == "depth":
            assert (diff > 1).mean() <= 0.02
        else:
            assert diff.max() <= 1


def test_viz_helpers_match():
    rng = np.random.RandomState(9)
    img = rng.uniform(-0.2, 1.2, (8, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvr.to_uint8(torch.as_tensor(img)),
                                  jvr.to_uint8(img))
    depth = rng.uniform(0, 5, (8, 10)).astype(np.float32)
    alpha = rng.uniform(0, 1, (8, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        tvr.colormap_depth(torch.as_tensor(depth), torch.as_tensor(alpha)),
        jvr.colormap_depth(depth, alpha))


def test_cli_visualize_writes_gif(tmp_path):
    path = texp.save_params(_steps(n=40), str(tmp_path))
    out = str(tmp_path / "orbit.gif")
    assert cli.main(["visualize", "--params", path, "--out", out,
                     "--frames", "3", "--width", "48", "--height", "32",
                     "--focal", "30", "--radius", "3", "--device",
                     "cpu"]) == 0
    assert os.path.getsize(out) > 100
    from PIL import Image
    with Image.open(out) as im:
        assert im.n_frames == 3 and im.size == (48, 32)
    assert cli.main(["visualize", "--params", path, "--out", out,
                     "--frames", "4", "--width", "48", "--height", "32",
                     "--focal", "30", "--radius", "3", "--resort-every", "2",
                     "--device", "cpu"]) == 0
    with Image.open(out) as im:
        assert im.n_frames == 4
