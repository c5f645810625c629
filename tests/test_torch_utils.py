"""Port parity: the render utilities (`utils/pose_utils.py`,
`utils/image_utils.py`, `utils/timing.py`, `ops/debug.py`).

* Pose maths (NumPy float64 on both sides): equal to 1e-12; the camera
  paths' float32 matrices within 1e-5.
* Image utilities in float32: Sobel edges, normals and the viewer's render
  modes within 1e-5 (depth colormap: equal bytes); the label palette
  equal; feature PCA with a shared basis within 1e-5, and its own basis
  equal up to the sign of each component.
* `pipelined_ms` calls the function as JAX's does (one warm-up, then
  `iters` calls with distinct scalars).
* `mark_visible` equal; `render_debug` passes a finite render through and
  dumps the same snapshot keys and inputs as JAX's for a non-finite one.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import debug as jdebug
from dynamic3dgaussians_tpu.utils import image_utils as jiu
from dynamic3dgaussians_tpu.utils import pose_utils as jpu
from dynamic3dgaussians_tpu.utils import timing as jtiming
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import debug as tdebug
from dynamic3dgaussians_tpu_torch.utils import image_utils as tiu
from dynamic3dgaussians_tpu_torch.utils import pose_utils as tpu
from dynamic3dgaussians_tpu_torch.utils import timing as ttiming
from tests.scenes import random_scene

torch.set_num_threads(1)


def _rot(seed):
    q = np.random.RandomState(seed).normal(size=4)
    return jpu.matrix_from_quat(q / np.linalg.norm(q))


def _cam_pair(seed, w=40, h=30):
    rng = np.random.RandomState(seed)
    w2c = np.eye(4)
    w2c[:3, :3] = _rot(seed)
    w2c[:3, 3] = rng.normal(size=3) + [0, 0, 4]
    k = [[35.0, 0, 20.0], [0, 36.0, 15.5], [0, 0, 1]]
    return (tcam.make_camera(w, h, k, w2c, near=0.05, far=50.0,
                             device="cpu"),
            jcam.make_camera(w, h, k, w2c, near=0.05, far=50.0))


def _same_cameras(ts, js):
    assert len(ts) == len(js) > 0
    for t, j in zip(ts, js):
        for key in ("w2c", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(t, key).numpy(),
                                       np.asarray(getattr(j, key)),
                                       atol=1e-5, err_msg=key)
        assert (t.width, t.height, t.near, t.far) == (j.width, j.height,
                                                      j.near, j.far)
        assert float(t.fx) == float(j.fx) and float(t.cy) == float(j.cy)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pose_maths_match_jax(seed):
    r = _rot(seed)
    for m in (r, np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
              np.diag([-1.0, -1, 1])):
        np.testing.assert_allclose(tpu.quat_from_matrix(m),
                                   jpu.quat_from_matrix(m), atol=1e-12)
    q0, q1 = jpu.quat_from_matrix(r), jpu.quat_from_matrix(_rot(seed + 9))
    np.testing.assert_allclose(tpu.matrix_from_quat(q0),
                               jpu.matrix_from_quat(q0), atol=1e-12)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(tpu.slerp(q0, q1, t),
                                   jpu.slerp(q0, q1, t), atol=1e-12)
        np.testing.assert_allclose(tpu.slerp(q0, q0 * 1.0000001, t),
                                   jpu.slerp(q0, q0 * 1.0000001, t),
                                   atol=1e-12)


def test_camera_paths_match_jax():
    (t0, j0), (t1, j1), (t2, j2) = (_cam_pair(s) for s in (0, 1, 2))
    _same_cameras(tpu.interpolate_cameras(t0, t1, 5),
                  jpu.interpolate_cameras(j0, j1, 5))
    _same_cameras(tpu.spiral_path(t0, n=6), jpu.spiral_path(j0, n=6))
    _same_cameras(tpu.spherify_path([t0, t1, t2], n=6),
                  jpu.spherify_path([j0, j1, j2], n=6))


def _out(seed, h=20, w=24, feat=6):
    rng = np.random.RandomState(seed)
    arrays = dict(rgb=rng.rand(h, w, 3), alpha=rng.uniform(0.3, 1, (h, w)),
                  extra=rng.rand(h, w, feat))
    arrays["depth"] = rng.uniform(1, 4, (h, w)) * arrays["alpha"]
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (types.SimpleNamespace(**{k: torch.as_tensor(v)
                                     for k, v in arrays.items()}),
            types.SimpleNamespace(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}))


@pytest.mark.parametrize("mode", ["RGB", "Depth", "Alpha", "Edges",
                                  "Normals", "Features", "Segmentation"])
def test_render_net_image_matches_jax(mode):
    t_out, j_out = _out(0)
    t = tiu.render_net_image(t_out, mode, fx=30.0, fy=31.0)
    j = np.asarray(jiu.render_net_image(j_out, mode, fx=30.0, fy=31.0))
    assert tuple(t.shape) == j.shape == (20, 24, 3)
    if mode == "Features":     # the basis's signs are the SVD's own
        j_basis = jiu.feature_pca(j_out.extra)[1]
        t = tiu.feature_pca(t_out.extra,
                            basis=torch.as_tensor(np.asarray(j_basis)))[0]
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)


def test_image_utils_match_jax():
    t_out, j_out = _out(1, feat=8)
    for img in (t_out.rgb, t_out.depth):
        np.testing.assert_allclose(
            tiu.sobel_edges(img).numpy(),
            np.asarray(jiu.sobel_edges(jnp.asarray(img.numpy()))), atol=1e-5)
    np.testing.assert_allclose(
        tiu.depth_to_normal(t_out.depth, 30.0, 31.0).numpy(),
        np.asarray(jiu.depth_to_normal(j_out.depth, 30.0, 31.0)), atol=1e-5)
    np.testing.assert_array_equal(tiu.label_colormap(), jiu.label_colormap())
    np.testing.assert_array_equal(tiu.label_colormap(10),
                                  jiu.label_colormap(10))
    t_rgb, t_basis = tiu.feature_pca(t_out.extra)
    j_rgb, j_basis = jiu.feature_pca(j_out.extra)
    t_basis, j_basis = t_basis.numpy(), np.asarray(j_basis)
    sign = np.sign(np.sum(t_basis * j_basis, axis=0))
    np.testing.assert_allclose(t_basis * sign, j_basis, atol=1e-4)
    for c in range(3):
        want = np.asarray(j_rgb)[..., c]
        got = t_rgb.numpy()[..., c]
        np.testing.assert_allclose(got if sign[c] > 0 else 1 - got, want,
                                   atol=1e-4)


def test_pipelined_ms_calls_like_jax():
    seen = {"jax": [], "torch": []}

    def fn(side):
        def f(s):
            seen[side].append(float(s))
            return jnp.asarray(s) if side == "jax" else torch.tensor(s)
        return f

    jtiming.pipelined_ms(fn("jax"), iters=7)
    ms = ttiming.pipelined_ms(fn("torch"), iters=7)
    assert ms > 0 and seen["torch"] == seen["jax"]
    assert len(seen["torch"]) == 8 and len(set(seen["torch"])) == 8


def test_mark_visible_and_render_debug_match_jax(tmp_path):
    means, colors, opac, scales, quats = random_scene(80, seed=4)
    means[:10, 2] = -5.0                         # behind the camera
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    k = [[40, 0, 24], [0, 40, 16], [0, 0, 1]]
    tc = tcam.make_camera(48, 32, k, w2c, device="cpu")
    jc = jcam.make_camera(48, 32, k, w2c)
    vis = tdebug.mark_visible(tc, torch.as_tensor(means))
    np.testing.assert_array_equal(
        vis.numpy(), np.asarray(jdebug.mark_visible(jc, jnp.asarray(means))))
    assert 0 < int(vis.sum()) < 80

    args = [means, colors, opac, scales, quats]
    out, ok = tdebug.render_debug(tc, *map(torch.as_tensor, args),
                                  method="reference", device="cpu",
                                  snapshot_path=str(tmp_path / "t.npz"))
    assert ok and not os.path.exists(tmp_path / "t.npz")
    assert tuple(out.rgb.shape) == (32, 48, 3)

    bad = [a.copy() for a in args]
    bad[0][3] = np.nan
    seg = np.ones((80, 3), np.float32)
    _, ok_t = tdebug.render_debug(
        tc, *map(torch.as_tensor, bad), extra_channels=torch.as_tensor(seg),
        method="reference", device="cpu",
        snapshot_path=str(tmp_path / "t.npz"))
    _, ok_j = jdebug.render_debug(
        jc, *map(jnp.asarray, bad), extra_channels=jnp.asarray(seg),
        method="reference", snapshot_path=str(tmp_path / "j.npz"))
    assert not ok_t and not ok_j
    t_snap, j_snap = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(t_snap.files) == sorted(j_snap.files)
    for key in j_snap.files:
        np.testing.assert_allclose(t_snap[key], j_snap[key], err_msg=key)
