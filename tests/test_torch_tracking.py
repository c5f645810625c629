"""Port parity: tracking by persistent gaussians (`eval/tracking.py`).

Every function against its JAX counterpart on the same inputs: the
attachment (an even k, whose median `jnp.median` takes as the mean of the
middle pair and `torch.median` as the lower one, an odd k, and a given
sigma), 3D and rotation tracks over a rigidly moving stack with per-point
jitter, the projection, the lift of pixel queries (coordinates truncated
toward zero and clipped at the image border) and `track_pixels` end to
end through the plain render path; and the rigid ground truth itself.

Tolerances, each with its reason: attachment weights and offsets, 3D
tracks and quaternions atol 1e-5 (float32 products of the same formulas
in other summation orders, over coordinates of order 1); pixel tracks atol
1e-3 px (the same at focal length 60, and the inverse of w2c by LU in each
package); `track_pixels` atol 1e-3 px as well: the lift reads the rendered
depth / alpha, and the two render paths agree to ~1e-6 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.eval import tracking as JT
from dynamic3dgaussians_tpu.eval.metrics import pck as jpck
from dynamic3dgaussians_tpu_torch.eval import tracking as TT
from dynamic3dgaussians_tpu_torch.eval.metrics import pck
from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
from tests.scenes import lookat_camera

torch.set_num_threads(1)

ATOL = 1e-5
ATOL_PX = 1e-3
NUM_T = 5


def _rigid_stack(seed=0, n=60, jitter=0.0):
    """Gaussians moving rigidly (rotation about y and a translation per
    step), optionally with per-point jitter so that no track is exact."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means, rots = [], []
    q0 = rng.normal(size=(n, 4)).astype(np.float32)
    for t in range(NUM_T):
        ang = 0.15 * t
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        shift = np.array([0.1 * t, 0.05 * t, 0.0], np.float32)
        means.append(base @ r.T + shift + rng.normal(0, jitter, base.shape))
        rot = np.tile(np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0],
                               np.float32), (n, 1))
        rots.append(rot + jitter * q0 if jitter else rot)
    seg = (np.arange(n) % 5 != 0).astype(np.float32)
    return {
        "means3D": np.stack(means).astype(np.float32),
        "unnorm_rotations": np.stack(rots).astype(np.float32),
        "seg_colors": np.stack([seg, np.zeros(n), 1 - seg],
                               -1).astype(np.float32),
        "rgb_colors": rng.rand(n, 3).astype(np.float32),
        "logit_opacities": np.full((n, 1), 2.0, np.float32),
        "log_scales": np.full((n, 3), -2.5, np.float32),
    }, base


def _queries(base, seed=1, q=12):
    rng = np.random.RandomState(seed)
    return (base[:q] + rng.normal(0, 0.03, (q, 3))).astype(np.float32)


def _cams():
    jcam, k, w2c = lookat_camera(w=64, h=64, f=60.0, dist=4.0)
    tcam = make_camera(64, 64, k, w2c, near=0.01, far=100.0, device="cpu")
    return jcam, tcam


def test_median_of_an_even_k_is_the_mean_of_the_middle_pair():
    x = np.random.RandomState(3).uniform(0, 1, (7, 8)).astype(np.float32)
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1, keepdims=True))
    got = TT._median_lastdim(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    lower = torch.median(torch.as_tensor(x), dim=1, keepdim=True).values
    assert (lower.numpy() < want).all()
    odd = x[:, :7]
    np.testing.assert_array_equal(
        TT._median_lastdim(torch.as_tensor(odd)).numpy(),
        np.asarray(jnp.median(jnp.asarray(odd), axis=1, keepdims=True)))


@pytest.mark.parametrize("k,sigma", [(8, None), (5, None), (6, 0.2)])
def test_attach_queries_matches(k, sigma):
    stacked, base = _rigid_stack(jitter=0.02)
    q = _queries(base)
    means0 = stacked["means3D"][0]
    rots0 = stacked["unnorm_rotations"][0]
    rots0 = rots0 / np.linalg.norm(rots0, axis=-1, keepdims=True)
    fg = stacked["seg_colors"][:, 0] > 0.5
    ji, jw, jl = JT.attach_queries(jnp.asarray(means0), jnp.asarray(rots0),
                                   jnp.asarray(fg), jnp.asarray(q), k=k,
                                   sigma=sigma)
    ti, tw, tl = TT.attach_queries(torch.as_tensor(means0),
                                   torch.as_tensor(rots0),
                                   torch.as_tensor(fg), torch.as_tensor(q),
                                   k=k, sigma=sigma)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert fg[ti.numpy()].all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_tracks_match(jitter):
    stacked, base = _rigid_stack(jitter=jitter)
    q = _queries(base)
    for fn, k in (("track_points_3d", 6), ("track_rotations", 4)):
        want = np.asarray(getattr(JT, fn)(stacked, jnp.asarray(q), k=k))
        got = getattr(TT, fn)(stacked, torch.as_tensor(q), k=k)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=fn)
    if jitter == 0.0:
        # the rigid ground truth: the queries move with the gaussians
        tracks = TT.track_points_3d(stacked, torch.as_tensor(q), k=6).numpy()
        for t in range(NUM_T):
            ang = 0.15 * t
            c, s = np.cos(ang), np.sin(ang)
            r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            gt = q @ r.T + np.array([0.1 * t, 0.05 * t, 0.0])
            np.testing.assert_allclose(tracks[t], gt, atol=5e-3)


def test_project_and_unproject_match():
    stacked, base = _rigid_stack(jitter=0.02)
    jcam, tcam = _cams()
    tracks = np.array(JT.track_points_3d(stacked, jnp.asarray(
        _queries(base)), k=6))
    np.testing.assert_allclose(
        TT.project_tracks(torch.as_tensor(tracks), tcam).numpy(),
        np.asarray(JT.project_tracks(jnp.asarray(tracks), jcam)),
        atol=ATOL_PX, rtol=0)
    rng = np.random.RandomState(5)
    depth = rng.uniform(1.0, 5.0, (64, 64)).astype(np.float32)
    alpha = rng.uniform(0.2, 1.0, (64, 64)).astype(np.float32)
    # fractional pixels (truncated toward zero), and ones past each border
    px = np.concatenate([rng.uniform(0, 64, (20, 2)),
                         [[-0.7, 3.2], [63.9, 70.0], [-5.0, -5.0]]]
                        ).astype(np.float32)
    want = np.asarray(JT.unproject_queries(jnp.asarray(px),
                                           jnp.asarray(depth),
                                           jnp.asarray(alpha), jcam))
    got = TT.unproject_queries(torch.as_tensor(px), torch.as_tensor(depth),
                               torch.as_tensor(alpha), tcam).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_track_pixels_matches_plain_path():
    stacked, _ = _rigid_stack()
    jcam, tcam = _cams()
    px = np.array([[32.0, 32.0], [28.5, 36.2], [40.0, 30.0], [33.7, 25.1]],
                  np.float32)
    want = np.asarray(JT.track_pixels(stacked, jcam, jnp.asarray(px), k=6,
                                      method="tiled"))
    got = TT.track_pixels(stacked, tcam, px, k=6, method="torch",
                          device="cpu")
    assert tuple(got.shape) == (NUM_T, 4, 2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_PX, rtol=0)
    # t = 0 lands on the queries; the motion moves the tracks
    np.testing.assert_allclose(got[0].numpy(), px, atol=1.5)
    assert float(pck(got[0], torch.as_tensor(px), (64, 64))) == \
        float(jpck(jnp.asarray(want[0]), jnp.asarray(px), (64, 64))) == 1.0
    assert float((got[-1] - torch.as_tensor(px)).abs().max()) > 2.0
