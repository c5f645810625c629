"""Port parity: the leaf ops `quat.rotate`, `sh.sh_to_rgb`,
`projection.build_cov3d` / `unpack_sym3` and `camera.stack_cameras`.

Each against its JAX counterpart on the same numpy-seeded inputs. The
tolerance is 1e-6 relative (plus 1e-7 absolute where a value cancels to
near 0): float32 elementwise formulas, the same in both packages up to
operation order. `rotate`'s components are sums of three products that
cancel in places, and XLA's dot may fuse them with FMA: each rotated
vector is held within 1e-6 of its length. `stack_cameras` is compared
field by field, and mixed image sizes must raise the reference's
assertion.
"""

import dataclasses

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

torch.set_num_threads(1)

RTOL = 1e-6
ATOL = 1e-7


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


@pytest.mark.parametrize("shape,unit", [((64,), True), ((5, 7), False),
                                        ((3,), False)])
def test_rotate_matches(shape, unit):
    """Unit and unnormalised quaternions (rotate normalises through
    quat_to_rotmat), over batch shapes of rank 1 and 2."""
    rng = np.random.RandomState(0)
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.uniform(-2, 2, shape + (3,)).astype(np.float32)
    got = tquat.rotate(torch.as_tensor(q), torch.as_tensor(v)).numpy()
    want = np.asarray(jquat.rotate(jnp.asarray(q), jnp.asarray(v)))
    assert got.shape == want.shape == shape + (3,)
    err = np.linalg.norm(got - want, axis=-1)
    assert (err <= RTOL * np.linalg.norm(v, axis=-1)).all(), err.max()
    # a rotation keeps lengths
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1),
                               np.linalg.norm(v, axis=-1), rtol=1e-5)


def test_sh_to_rgb_matches_and_inverts_rgb_to_sh():
    rng = np.random.RandomState(1)
    sh = rng.normal(0, 2, (50, 3)).astype(np.float32)
    got = tsh.sh_to_rgb(torch.as_tensor(sh)).numpy()
    _close(got, jsh.sh_to_rgb(jnp.asarray(sh)))
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    back = tsh.sh_to_rgb(tsh.rgb_to_sh(torch.as_tensor(rgb))).numpy()
    np.testing.assert_allclose(back, rgb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("modifier", [1.0, 0.5])
def test_build_cov3d_and_unpack_sym3_match(modifier):
    rng = np.random.RandomState(2)
    n = 200
    scales = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    packed = tproj.build_cov3d(torch.as_tensor(scales), torch.as_tensor(q),
                               modifier)
    jpacked = jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(q),
                                modifier)
    assert tuple(packed.shape) == (n, 6)
    _close(packed.numpy(), jpacked, "build_cov3d")
    full = tproj.unpack_sym3(packed)
    _close(full.numpy(), jproj.unpack_sym3(jpacked), "unpack_sym3")
    # R diag(s)^2 R^T itself, in float64
    R = np.asarray(tquat.quat_to_rotmat(torch.as_tensor(q),
                                        normalized=True), np.float64)
    s2 = (modifier * scales.astype(np.float64)) ** 2
    want = np.einsum("nik,nk,njk->nij", R, s2, R)
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-7)


def test_build_cov3d_is_what_project_uses():
    """The public function stacks the same components `project` takes, so
    the two cannot drift apart."""
    rng = np.random.RandomState(4)
    s = torch.as_tensor(rng.uniform(0.05, 0.2, (9, 3)).astype(np.float32))
    q = tquat.normalize(torch.as_tensor(rng.normal(size=(9, 4))
                                        .astype(np.float32)))
    comps = tproj._cov3d_components(s, q, 1.0)
    assert torch.equal(tproj.build_cov3d(s, q), torch.stack(comps, -1))


def test_stack_cameras_matches_field_by_field():
    args = ([0.1, -0.2, 0.0], 3.5, -1.0, 4, 64, 48, 50.0)
    j = jcam.stack_cameras(jcam.orbit_cameras(*args))
    cams = tcam.orbit_cameras(*args, device="cpu")
    t = tcam.stack_cameras(cams)
    for f in dataclasses.fields(tcam.Camera):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("height", "width", "near", "far"):
            assert got == want == getattr(cams[0], f.name), f.name
            continue
        assert tuple(got.shape) == tuple(np.shape(want)), f.name
        assert tuple(got.shape) == (4,) + tuple(
            getattr(cams[0], f.name).shape), f.name
        _close(got.numpy(), want, f.name)
        for i, c in enumerate(cams):
            assert torch.equal(got[i], getattr(c, f.name)), (f.name, i)


def test_stack_cameras_mixed_sizes_raise():
    k = [[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    a = tcam.make_camera(64, 48, k, w2c, device="cpu")
    b = tcam.make_camera(32, 48, k, w2c, device="cpu")
    with pytest.raises(AssertionError, match="mixed image sizes"):
        tcam.stack_cameras([a, b])
    with pytest.raises(AssertionError, match="mixed image sizes"):
        jcam.stack_cameras([jcam.make_camera(64, 48, k, w2c),
                            jcam.make_camera(32, 48, k, w2c)])
