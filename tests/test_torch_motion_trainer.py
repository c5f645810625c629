"""Port parity: the motion-basis trainer (`train/motion_trainer.py`)
against the JAX package on the CPU: `train_motion` from the k-means and
from the Procrustes init, `train_motion_windowed`, `posed_gaussians` on
the reference's trained parameters and `reverse_window_schedule`.

The reference's init draws are replayed (`bases_noise=`, `kmeans_idx=`);
the reference renders with its tiled path, the port with the plain
versions of K1 and K2.

Tolerances, each with its reason:
* `posed_gaussians` on the reference's trained parameters: atol 1e-6
  (float32 values of size ~1), background rows bitwise canonical;
* the runs: each step's loss rel 1e-5 and PSNR within 1e-4 dB (seen at
  most 1.0e-6 relative); the output parameters each group within a
  fraction of lr x steps, the most one element can move per step being
  lr. Adam turns rounding-level gradients into steps of +-lr, so elements
  whose gradient is ~0 (the rotations of near-isotropic gaussians, the 6D
  rotations of a basis few gaussians follow, the scales of gaussians at
  the image border) drift by whole steps: unnorm_rotations 1.0 (seen
  0.54, the windowed run), motion_rots 0.25 (seen 0.076), every other
  group 0.05 (seen 0.030, log_scales). An update in the wrong direction
  moves an element by up to 2 x lr x steps; the per-step losses carry the
  tight check. The Procrustes run is held more loosely, for the reason in
  its docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import motion_trainer as JM
from dynamic3dgaussians_tpu_torch.convert import params_from_jax
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import motion_trainer as TM

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

ATOL = 1e-6
INIT_TOL = 1e-5


def _t(a):
    return torch.tensor(np.array(a, np.float32))


RS = dict(chunk=64, max_per_tile=256, max_tiles_per_gaussian=64,
          pairs_per_gaussian=16)


def _scene(n_fg, n_bg, seed, num_t, num_cams, w, h, f):
    scene = tsyn.make_gt_scene(n_fg=n_fg, n_bg=n_bg, seed=seed)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=num_t, num_cams=num_cams,
                                    w=w, h=h, f=f, device="cpu")
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    jds = [[dict(camera=jcam.make_camera(
        w, h, k, np.asarray(fr["camera"].w2c.numpy(), np.float64)),
        im=jnp.asarray(fr["im"].numpy()), seg=jnp.asarray(fr["seg"].numpy()))
        for fr in frames] for frames in tds]
    return scene, tds, jds, w2c


def _cfgs(capacity, rs=RS):
    kw = dict(capacity=capacity, report_every=1, seed=0)
    return (jconf.TrainConfig(raster=jconf.RasterSettings(**rs), **kw),
            tconf.TrainConfig(raster=tconf.RasterSettings(**rs), **kw))


def _draws(seed, k, f, n):
    """The reference's init draws: the bases' noise from the first of its
    two keys, the k-means rows of n from the second (or, for the
    Procrustes init, from the first)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.normal(k1, (k, f, 6))),
            np.array(jax.random.choice(k2, n, (k,), replace=False)),
            np.array(jax.random.choice(k1, n, (k,), replace=False)))


def _rec(log):
    return {"on_step": lambda a, i, m: log.append(
        (a, i, float(m["loss"]), float(m["psnr"])))}


PARAM_FRAC = {"unnorm_rotations": 1.0, "motion_rots": 0.25}
# the Procrustes run (see test_train_motion_procrustes_init_matches)
PROCRUSTES_FRAC = {"unnorm_rotations": 0.75, "motion_rots": 0.75,
                   "motion_coefs": 0.25, "means3D": 0.15}


def _lr(k, tcfg, radius):
    if k.startswith("motion_"):
        return TM.MOTION_LRS[k[len("motion_"):]]
    return tcfg.lrs.get(k, 0.0) * (radius if k == "means3D" else 1.0)


def _hold(jlog, tlog, jp, tp, tcfg, radius, steps, loss_rtol=1e-5,
          psnr_atol=1e-4, frac=PARAM_FRAC, frac_default=0.05):
    assert [x[:2] for x in tlog] == [x[:2] for x in jlog]
    for (a, i, tl_, tpsnr), (_, _, jl_, jpsnr) in zip(tlog, jlog):
        assert abs(tl_ - jl_) <= loss_rtol * abs(jl_), (a, i, tl_, jl_)
        assert abs(tpsnr - jpsnr) <= psnr_atol, (a, i, tpsnr, jpsnr)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(v),
            atol=frac.get(k, frac_default) * _lr(k, tcfg, radius) * steps
            + 1e-6, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def kmeans_runs():
    """tests/test_motion_feature.py's motion scene, 30 steps of both
    packages from the k-means init."""
    scene, tds, jds, w2c = _scene(40, 60, 1, 3, 3, 48, 32, 40.0)
    pt = tsyn.init_point_cloud(scene, noise=0.02)
    jcfg, tcfg = _cfgs(128)
    noise, idx, _ = _draws(0, 4, 3, pt.shape[0])
    jlog, tlog = [], []
    jp, jv = JM.train_motion(jds, jcfg, pt, w2c, num_bases=4, num_iters=30,
                             callbacks=_rec(jlog))
    tp, tv = TM.train_motion(tds, tcfg, pt, w2c, num_bases=4, num_iters=30,
                             bases_noise=noise, kmeans_idx=idx,
                             callbacks=_rec(tlog), device="cpu")
    return dict(jlog=jlog, tlog=tlog, jp=jp, tp=tp, tcfg=tcfg, jv=jv, tv=tv)


def test_train_motion_kmeans_init_matches(kmeans_runs):
    r = kmeans_runs
    assert len(r["tlog"]) == 30
    assert r["tp"]["motion_rots"].shape == (4, 3, 6)
    assert r["tp"]["motion_coefs"].shape == (128, 4)
    _hold(r["jlog"], r["tlog"], r["jp"], r["tp"], r["tcfg"],
          float(r["tv"]["scene_radius"]), 30)
    assert torch.equal(r["tv"]["alive"],
                       torch.as_tensor(np.array(r["jv"]["alive"])))


def test_params_from_jax_carries_motion_keys(kmeans_runs):
    jp = jax.tree.map(np.asarray, kmeans_runs["jp"])
    tp = params_from_jax(jp, "cpu")
    for k in ("motion_rots", "motion_transls", "motion_coefs", "label"):
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])


def test_posed_gaussians_match_on_reference_params(kmeans_runs):
    jp = kmeans_runs["jp"]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    bg = tp["label"].numpy() <= 0.5
    assert bg.any() and (~bg).any()
    for t in range(3):
        jpos = JM.posed_gaussians(jp, jnp.int32(t))
        tpos = TM.posed_gaussians(tp, t)
        for k in ("means3D", "rotations"):
            np.testing.assert_allclose(tpos[k].numpy(), np.asarray(jpos[k]),
                                       atol=ATOL, err_msg=(t, k))
        np.testing.assert_array_equal(tpos["means3D"].numpy()[bg],
                                      tp["means3D"].numpy()[bg])


@pytest.mark.parametrize("args", [(12, 3, 6), (6, 3, 6), (5, 2, 3),
                                  (7, 1, 1), (1, 3, 6)])
def test_reverse_window_schedule_matches(args):
    assert list(TM.reverse_window_schedule(*args)) == \
        list(JM.reverse_window_schedule(*args))


def test_train_motion_procrustes_init_matches():
    """tests/test_motion_feature.py's tracks case: 4 frames, the first 40
    points' animated positions as tracks, coefficients mapped to the
    gaussians by the nearest canonical track (chunked here at 16 rows).

    The init (0 steps) agrees within 1e-5. The run is held more loosely:
    at the canonical frame (the first step's) every basis is the identity,
    so the blend does not depend on the coefficients and their gradients
    there, and those of the bases' frame-0 rotations, are rounding
    residuals; Adam's first step turns them into +-lr of either sign
    (seen: a coefficient 2 lr = 0.02 apart after step 0). The losses then
    differ by up to 5.2e-4 relative (held at 2e-3), the PSNR by 0.013 dB
    (held at 0.05), and the parameters by these fractions of lr x steps:
    motion_rots 0.33 and unnorm_rotations 0.34 (held at 0.75),
    motion_coefs 0.10 (0.25), means3D 0.051 (0.15), the rest 0.021
    (0.05)."""
    num_t = 4
    scene, tds, jds, w2c = _scene(20, 30, 0, num_t, 2, 32, 32, 28.0)
    pt = tsyn.init_point_cloud(scene, noise=0.02)
    tracks = np.stack([tsyn.animate(scene, t, num_t) for t in range(num_t)],
                      axis=1)[:40]
    rs = dict(RS, max_tiles_per_gaussian=16)
    jcfg, tcfg = _cfgs(64, rs)
    _, _, idx = _draws(0, 4, num_t, tracks.shape[0])
    runs = {}
    for iters in (0, 20):
        jlog, tlog = [], []
        jp, _ = JM.train_motion(jds, jcfg, pt, w2c, num_bases=4,
                                num_iters=iters, tracks_3d=tracks,
                                callbacks=_rec(jlog))
        tp, tv = TM.train_motion(tds, tcfg, pt, w2c, num_bases=4,
                                 num_iters=iters, tracks_3d=tracks,
                                 kmeans_idx=idx, callbacks=_rec(tlog),
                                 device="cpu")
        runs[iters] = (jlog, tlog, jp, tp)
    _, _, jp0, tp0 = runs[0]
    assert set(tp0) == set(jp0)
    for k, v in jp0.items():
        np.testing.assert_allclose(tp0[k].numpy(), np.asarray(v),
                                   atol=INIT_TOL, rtol=0, err_msg=k)
    _hold(*runs[20], tcfg, float(tv["scene_radius"]), 20, loss_rtol=2e-3,
          psnr_atol=0.05, frac=PROCRUSTES_FRAC)
    # the nearest-track map is the reference's exact argmin, whatever the
    # chunk of rows
    pts = _t(pt[:, :3])
    anchors = _t(tracks[:, 0])
    d2 = ((pt[:, None, :3] - tracks[None, :, 0]) ** 2).sum(-1)
    for chunk in (7, 16, TM.NEAREST_CHUNK):
        np.testing.assert_array_equal(
            TM.nearest_rows(pts, anchors, chunk=chunk).numpy(),
            d2.argmin(-1))


def test_train_motion_windowed_matches():
    """5 frames, windows of 3 frames every 2 (anchors 4, 2, 0), 8 steps
    per window."""
    scene, tds, jds, w2c = _scene(30, 40, 2, 5, 2, 40, 32, 32.0)
    pt = tsyn.init_point_cloud(scene, noise=0.02)
    jcfg, tcfg = _cfgs(128)
    noise, idx, _ = _draws(0, 3, 5, pt.shape[0])
    jlog, tlog = [], []
    kw = dict(num_bases=3, iters_per_window=8, window_step=2, window=3)
    jp, _ = JM.train_motion_windowed(jds, jcfg, pt, w2c,
                                     callbacks=_rec(jlog), **kw)
    tp, tv = TM.train_motion_windowed(tds, tcfg, pt, w2c,
                                      callbacks=_rec(tlog),
                                      bases_noise=noise, kmeans_idx=idx,
                                      device="cpu", **kw)
    assert [a for a, _, _, _ in tlog[::8]] == [4, 2, 0]
    _hold(jlog, tlog, jp, tp, tcfg, float(tv["scene_radius"]), 24)
