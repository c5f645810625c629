"""Port parity: camera and EWA projection against the JAX package.

Same numpy inputs through `dynamic3dgaussians_tpu` and
`dynamic3dgaussians_tpu_torch` on the CPU. Floats within rtol/atol 1e-5
(the same float32 formulas in the same order; only libm ulps may differ),
integer radii, validity and tile rects exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import projection as jproj
from dynamic3dgaussians_tpu.ops import quat as jquat
from dynamic3dgaussians_tpu.ops import sh as jsh
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import projection as tproj
from dynamic3dgaussians_tpu_torch.ops import quat as tquat
from dynamic3dgaussians_tpu_torch.ops import sh as tsh
from tests.scenes import random_scene

torch.set_num_threads(1)

FLOAT_FIELDS = ("x2d", "y2d", "conic_a", "conic_b", "conic_c", "depth")


def _cameras(kind):
    w, h, f = 64, 48, 50.0
    if kind == "orbit":
        j = jcam.orbit_cameras([0.1, -0.2, 0.0], 3.5, -1.0, 5, w, h, f)[2]
        t = tcam.orbit_cameras([0.1, -0.2, 0.0], 3.5, -1.0, 5, w, h, f,
                               device="cpu")[2]
        return j, t
    cx, cy = (w / 2, h / 2) if kind != "offcenter" else (20.0, 31.0)
    k = [[f, 0, cx], [0, f * 1.1, cy], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0 if kind != "near" else 0.9
    return (jcam.make_camera(w, h, k, w2c),
            tcam.make_camera(w, h, k, w2c, device="cpu"))


def _assert_proj_equal(jp, tp):
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert tp.radius.dtype == torch.int32 and tp.valid.dtype == torch.bool


@pytest.mark.parametrize("kind", ["centered", "offcenter", "orbit", "near"])
def test_camera_matches(kind):
    j, t = _cameras(kind)
    for name in ("w2c", "proj", "full_proj", "cam_center", "fx", "fy", "cx",
                 "cy"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (t.width, t.height, t.near, t.far) == (j.width, j.height, j.near,
                                                  j.far)


@pytest.mark.parametrize("kind,scale_modifier", [
    ("centered", 1.0), ("offcenter", 1.0), ("orbit", 1.0), ("near", 1.0),
    ("centered", 0.6), ("orbit", 1.7)])
def test_project_matches(kind, scale_modifier):
    jc, tc = _cameras(kind)
    # spread past the view frustum: some gaussians are culled
    means, _, _, scales, quats = random_scene(300, seed=11, spread=2.5,
                                              scale_lo=0.01, scale_hi=0.4)
    jp = jproj.project(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), jc, scale_modifier=scale_modifier)
    tp = tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                       torch.as_tensor(quats), tc,
                       scale_modifier=scale_modifier)
    _assert_proj_equal(jp, tp)
    assert 0 < int(tp.valid.sum()) < 300


def test_project_cov3d_precomp_matches():
    jc, tc = _cameras("offcenter")
    means, _, _, scales, quats = random_scene(200, seed=12)
    cov6 = np.stack(jproj._cov3d_components(jnp.asarray(scales),
                                            jnp.asarray(quats), 1.3), -1)
    cov6 = np.asarray(cov6)
    jp = jproj.project(jnp.asarray(means), None, None, jc,
                       cov3d_precomp=jnp.asarray(cov6))
    tp = tproj.project(torch.as_tensor(means), None, None, tc,
                       cov3d_precomp=torch.as_tensor(cov6))
    _assert_proj_equal(jp, tp)
    # the precomputed path equals the scale/rotation path it was built from
    tp2 = tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                        torch.as_tensor(quats), tc, scale_modifier=1.3)
    _assert_proj_equal(tp2, tp)


@pytest.mark.parametrize("grid", [(16, 16), (8, 16)])
def test_tile_rect_matches(grid):
    th, tw = grid
    jc, tc = _cameras("offcenter")
    means, _, _, scales, quats = random_scene(300, seed=13, scale_hi=0.3)
    jp = jproj.project(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), jc)
    tp = tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                       torch.as_tensor(quats), tc)
    gh, gw = -(-48 // th), -(-64 // tw)
    for a, b in zip(jproj.tile_rect(jp, th, tw, gh, gw),
                    tproj.tile_rect(tp, th, tw, gh, gw)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_quat_helpers_match():
    rng = np.random.RandomState(3)
    q1 = rng.normal(size=(50, 4)).astype(np.float32)
    q2 = rng.normal(size=(50, 4)).astype(np.float32)
    q1[0] = 0.0                        # padding row stays finite
    pairs = [
        (jquat.normalize(jnp.asarray(q1)), tquat.normalize(
            torch.as_tensor(q1))),
        (jquat.quat_mult(jnp.asarray(q1), jnp.asarray(q2)),
         tquat.quat_mult(torch.as_tensor(q1), torch.as_tensor(q2))),
        (jquat.conjugate(jnp.asarray(q1)), tquat.conjugate(
            torch.as_tensor(q1))),
        (jquat.quat_to_rotmat(jnp.asarray(q1)),
         tquat.quat_to_rotmat(torch.as_tensor(q1))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_color_matches(deg):
    rng = np.random.RandomState(4 + deg)
    sh = rng.normal(0, 0.5, (40, 16, 3)).astype(np.float32)
    means = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    center = np.array([0.2, -0.3, -4.0], np.float32)
    a = jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(means),
                        jnp.asarray(center))
    b = tsh.sh_to_color(deg, torch.as_tensor(sh), torch.as_tensor(means),
                        torch.as_tensor(center))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tsh.rgb_to_sh(torch.as_tensor(means)).numpy(),
        np.asarray(jsh.rgb_to_sh(jnp.asarray(means))), rtol=1e-6)
