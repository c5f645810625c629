"""Port parity: the motion-basis path's building blocks -- `ops/quat.py`'s
rotation forms and `models/motion_bases.py` -- against the JAX package on
the CPU (the trainer: tests/test_torch_motion_trainer.py).

The reference's random draws are replayed: its `init_motion_bases` noise
and its k-means / spectral sample indices are drawn with its keys here and
passed to the port (`noise=`, `init_idx=`, `sample_idx=`).

Tolerances, each with its reason:
* the rotation forms: atol 1e-6 (float32 formulas in the same order),
  times the Gram-Schmidt step's condition |a2| / |a2 - (a2.b1) b1| for a
  6D row (its square for the gradients): a 6D vector whose halves are
  nearly parallel amplifies the ulp differences of rsqrt (seen 1.5e-6 at
  a condition of 8); the gradients at a zero 6D row (the clamp makes them
  ~1e12) rel 1e-6;
* motion bases: k-means / spectral labels equal, centres, coefficients,
  Procrustes R and t within 1e-5 (sums of up to a few hundred float32
  terms in another order; SVD and eigh of other LAPACK builds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.models import motion_bases as JMB
from dynamic3dgaussians_tpu.ops import quat as jquat
from dynamic3dgaussians_tpu_torch.models import motion_bases as TMB
from dynamic3dgaussians_tpu_torch.ops import quat as tquat

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

ATOL = 1e-6
BASES_TOL = 1e-5


def _t(a, grad=False):
    return torch.tensor(np.array(a, np.float32), requires_grad=grad)


# ------------------------------------------------------- rotation forms

def _rotmats(n, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q)))
    # each Shepperd case wins somewhere: the identity (w), and 180 degree
    # turns about x, y and z (the x, y, z cases)
    special = np.stack([np.eye(3), np.diag([1.0, -1, -1]),
                        np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    return np.concatenate([R, special.astype(np.float32)])


def _gram_schmidt_condition(d6):
    """|a2| / |a2 - (a2.b1) b1| per row, in float64: how much the second
    Gram-Schmidt step amplifies a rounding difference when a2 is nearly
    parallel to a1."""
    d = d6.astype(np.float64)
    b1 = d[:, :3] / np.linalg.norm(d[:, :3], axis=-1, keepdims=True)
    a2 = d[:, 3:]
    a2p = a2 - np.sum(b1 * a2, -1, keepdims=True) * b1
    return np.maximum(np.linalg.norm(a2, axis=-1)
                      / np.linalg.norm(a2p, axis=-1), 1.0)


@pytest.mark.parametrize("name", ["cont_6d_to_rotmat", "rotmat_to_cont_6d",
                                  "rotmat_to_quat"])
def test_rotation_forms_match(name):
    rng = np.random.RandomState(1)
    if name == "cont_6d_to_rotmat":
        x = rng.normal(size=(40, 6)).astype(np.float32)
        x[:3] = 0.0                                 # capacity-padding rows
    else:
        x = _rotmats(40, 2)
    jf, tf = getattr(jquat, name), getattr(tquat, name)
    jy = np.asarray(jf(jnp.asarray(x)))
    xt = _t(x, grad=True)
    ty = tf(xt)
    tol = np.full((len(x), 1), ATOL)
    if name == "cont_6d_to_rotmat":
        tol[3:, 0] *= _gram_schmidt_condition(x[3:])
    err = np.abs(ty.detach().numpy() - jy).reshape(len(x), -1)
    assert (err <= tol).all(), (err.max(1), tol[:, 0])
    w = rng.normal(size=jy.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * w))(jnp.asarray(x)))
    (tg,) = torch.autograd.grad(torch.sum(ty * _t(w)), xt)
    tg = tg.numpy()
    assert np.isfinite(tg).all() and np.isfinite(jg).all()
    if name == "cont_6d_to_rotmat":
        np.testing.assert_allclose(tg[:3], jg[:3], rtol=1e-6, atol=0)
        gerr = np.abs(tg - jg)[3:]
        assert (gerr <= tol[3:] ** 2 / ATOL).all(), (gerr.max(1), tol)
        # a zero row maps to the zero matrix, not to NaN
        assert np.all(ty.detach().numpy()[:3] == 0.0)
    else:
        np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=0)


def test_rotmat_to_quat_sign_and_roundtrip():
    R = _rotmats(64, 3)
    q = tquat.rotmat_to_quat(_t(R))
    np.testing.assert_allclose(tquat.quat_to_rotmat(q).numpy(), R,
                               atol=1e-5)
    # the chosen sign is the reference's, not merely the same rotation
    np.testing.assert_array_equal(
        np.sign(q.numpy()),
        np.sign(np.asarray(jquat.rotmat_to_quat(jnp.asarray(R)))))


# ---------------------------------------------------------- motion bases

def test_init_compute_apply_transforms_match():
    key = jax.random.PRNGKey(3)
    K, F, G = 3, 5, 16
    jb = JMB.init_motion_bases(K, F, key)
    noise = np.array(jax.random.normal(key, (K, F, 6)))
    tb = TMB.init_motion_bases(K, F, noise=noise, device="cpu")
    for k in ("rots", "transls"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    rng = np.random.RandomState(4)
    jb["transls"] = jnp.asarray(rng.normal(size=(K, F, 3)), jnp.float32)
    tb["transls"] = _t(jb["transls"])
    coefs = rng.uniform(0, 2, (G, K)).astype(np.float32)
    coefs[:2] = 0.0                                 # padding rows
    pts = rng.normal(size=(G, 3)).astype(np.float32)
    ts = np.array([4, 0, 2])
    jT = JMB.compute_transforms(jb, jnp.asarray(ts), jnp.asarray(coefs))
    tT = TMB.compute_transforms(tb, torch.as_tensor(ts), _t(coefs))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=ATOL)
    np.testing.assert_allclose(
        TMB.apply_transforms(tT, _t(pts)).numpy(),
        np.asarray(JMB.apply_transforms(jT, jnp.asarray(pts))), atol=ATOL)


def _blobs(n_per, centers, seed, spread=0.3):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.normal(c, spread, (n_per, len(c)))
                           for c in centers]).astype(np.float32)


def test_kmeans_and_coefs_match():
    x = _blobs(50, [(0, 0, 0), (3, 0, 0), (0, 3, 0), (0, 0, 3)], 5)
    key = jax.random.PRNGKey(6)
    idx = np.array(jax.random.choice(key, x.shape[0], (4,), replace=False))
    jc, jl = JMB.kmeans(jnp.asarray(x), 4, key)
    tc, tl = TMB.kmeans(_t(x), 4, init_idx=idx)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=BASES_TOL)
    np.testing.assert_allclose(
        TMB.coefs_from_features(_t(x), 4, init_idx=idx).numpy(),
        np.asarray(JMB.coefs_from_features(jnp.asarray(x), 4, key)),
        atol=BASES_TOL)
    # drawn from a generator: k distinct rows, reproducible
    g = torch.Generator().manual_seed(0)
    a = TMB.kmeans(_t(x), 4, g)[1]
    b = TMB.kmeans(_t(x), 4, torch.Generator().manual_seed(0))[1]
    assert torch.equal(a, b)


def test_kmeans_empty_cluster_goes_to_origin():
    """Two initial centres on one point: argmin takes the first on the
    tie, the second centre's cluster stays empty and its centre moves to
    the origin (the reference's counts clamped to 1), in both packages."""
    x = _blobs(30, [(2, 2), (-2, 3)], 7)
    x[5] = x[6]
    key = jax.random.PRNGKey(0)
    jc, jl = JMB.kmeans(jnp.asarray(x), 3, key)
    j_idx = np.array(jax.random.choice(key, x.shape[0], (3,),
                                       replace=False))
    idx = np.array([5, 6, 40])
    tc, tl = TMB.kmeans(_t(x), 3, init_idx=idx)
    np.testing.assert_array_equal(tc.numpy()[1], 0.0)
    assert not (tl.numpy() == 1).any()
    # the reference's own draw, replayed, agrees too
    tc2, tl2 = TMB.kmeans(_t(x), 3, init_idx=j_idx)
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc), atol=BASES_TOL)


@pytest.mark.parametrize("method", ["spectral", "kmeans"])
def test_spectral_and_feature_clusters_match(method):
    feats = _blobs(60, [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0)], 8,
                   spread=0.1)
    key = jax.random.PRNGKey(9)
    n, k, sample = feats.shape[0], 3, 128
    sample_idx = np.array(jax.random.choice(key, n, (sample,),
                                            replace=False))
    if method == "spectral":
        init_idx = np.array(jax.random.choice(key, sample, (k,),
                                              replace=False))
        jc, jl = JMB.spectral_cluster(jnp.asarray(feats), k, key,
                                      sample=sample)
        tc, tl = TMB.spectral_cluster(_t(feats), k, sample=sample,
                                      sample_idx=sample_idx,
                                      init_idx=init_idx)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                   atol=BASES_TOL)
    # coefs_from_feature_clusters at the default sample (no subsample)
    full_idx = np.array(jax.random.choice(key, n, (k,), replace=False))
    jcoef = JMB.coefs_from_feature_clusters(jnp.asarray(feats), k, key,
                                            method=method)
    tcoef = TMB.coefs_from_feature_clusters(_t(feats), k, method=method,
                                            init_idx=full_idx)
    np.testing.assert_allclose(tcoef.numpy(), np.asarray(jcoef),
                               atol=BASES_TOL)


def _two_cluster_tracks(noise=1e-3):
    """tests/test_motion_feature.py's two rigid clusters."""
    rng = np.random.RandomState(0)
    f, n_half = 12, 120
    base_a = rng.uniform(-0.5, 0.5, (n_half, 3)) + np.array([2.0, 0, 0])
    base_b = rng.uniform(-0.5, 0.5, (n_half, 3)) + np.array([-2.0, 0, 0])

    def rigid_traj(base, axis, rate, vel):
        out = []
        for t in range(f):
            c, s = np.cos(rate * t), np.sin(rate * t)
            R = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) if axis == "z"
                 else np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
            out.append(base @ R.T + np.asarray(vel) * t)
        return np.stack(out, 1)

    tracks = np.concatenate([
        rigid_traj(base_a, "z", 0.05, [0.02, 0, 0]),
        rigid_traj(base_b, "x", -0.04, [0, 0.03, 0])], 0).astype(np.float32)
    return tracks + rng.normal(0, noise, tracks.shape).astype(np.float32)


def test_procrustes_solve_and_features_match():
    rng = np.random.RandomState(10)
    src = rng.normal(size=(2, 3, 50, 3)).astype(np.float32)
    dst = src @ np.asarray(jquat.quat_to_rotmat(jnp.asarray(
        rng.normal(size=(4,)), jnp.float32))).T + 0.3
    w = rng.uniform(0, 1, (2, 3, 50)).astype(np.float32)
    jR, jt, jw = JMB.solve_procrustes_batched(*map(jnp.asarray,
                                                   (src, dst, w)))
    tR, tt, tw = TMB.solve_procrustes_batched(_t(src), _t(dst), _t(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=BASES_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=BASES_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    tracks = _two_cluster_tracks()
    np.testing.assert_allclose(
        TMB.velocity_direction_features(_t(tracks), 3).numpy(),
        np.asarray(JMB.velocity_direction_features(jnp.asarray(tracks), 3)),
        atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_procrustes_init_matches(case):
    """The two-cluster tracks; "masked" adds visibility and confidences
    with frames 9-11 of every track invisible, so those frames fall below
    the weight floor and take the forward sweep's carried transform, and
    cano_t = 4 so that both sweeps run."""
    tracks = _two_cluster_tracks()
    n, f = tracks.shape[:2]
    key = jax.random.PRNGKey(0)
    kw_j, kw_t, cano = {}, {}, 0
    if case == "masked":
        rng = np.random.RandomState(11)
        vis = np.ones((n, f), bool)
        vis[:, 9:] = False
        vis[rng.rand(n, f) < 0.1] = False
        conf = rng.uniform(0.2, 1.0, (n, f)).astype(np.float32)
        kw_j = dict(visibles=jnp.asarray(vis), confidences=jnp.asarray(conf))
        kw_t = dict(visibles=torch.as_tensor(vis), confidences=_t(conf))
        cano = 4
    idx = np.array(jax.random.choice(key, n, (2,), replace=False))
    jb, jc, jv = JMB.init_motion_params_with_procrustes(
        jnp.asarray(tracks), 2, cano, key, **kw_j)
    tb, tc, tv = TMB.init_motion_params_with_procrustes(
        _t(tracks), 2, cano, init_idx=idx, **kw_t)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=BASES_TOL)
    jR = np.asarray(jquat.cont_6d_to_rotmat(jb["rots"]))
    tR = tquat.cont_6d_to_rotmat(tb["rots"]).numpy()
    np.testing.assert_allclose(tR, jR, atol=BASES_TOL)
    np.testing.assert_allclose(tb["transls"].numpy(),
                               np.asarray(jb["transls"]), atol=BASES_TOL)
    if case == "masked":
        # the low-weight frames carry frame 8's transform
        for fr in (9, 10, 11):
            np.testing.assert_array_equal(tb["rots"][:, fr].numpy(),
                                          tb["rots"][:, 8].numpy())


def test_procrustes_outliers_use_the_mean_of_the_middle_pair():
    """An even number of tracks whose canonical x has a wide gap between
    the two middle values: the median is their mean (jnp.median); the
    lower one (torch.median) would move the centre and flip `valid`."""
    f = 3
    xs = np.array([0.0, 0.1, 0.2, 0.3, 10.0, 10.1, 10.2, 30.0],
                  np.float32)
    cano = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], -1)
    tracks = np.stack([cano + 0.01 * t for t in range(f)], 1)
    key = jax.random.PRNGKey(1)
    idx = np.array(jax.random.choice(key, len(xs), (2,), replace=False))
    _, _, jv = JMB.init_motion_params_with_procrustes(
        jnp.asarray(tracks), 2, 0, key, outlier_quantile=0.5)
    _, _, tv = TMB.init_motion_params_with_procrustes(
        _t(tracks), 2, 0, init_idx=idx, outlier_quantile=0.5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the case bites: the lower median gives another mask
    low = torch.median(_t(cano), dim=0).values
    d = torch.linalg.vector_norm(_t(cano) - low, dim=-1)
    assert not torch.equal(d < torch.quantile(d, 0.5), tv)
