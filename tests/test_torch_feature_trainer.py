"""Port parity: the Feature-3DGS OO trainer (`train/feature_trainer.py`).

The reference's trainer (its render through method "auto": the tiled path
off the TPU) against the port's (`device="cpu"`: the plain versions of K1
and K2) on one numpy-seeded scene: the feature-map resize both ways at
non-integer ratios, the decoder, one step's loss, `feature_l1` and
gradients (gaussians, decoder and the mean2d probe) with and without the
decoder at an SH ramp, a 20-iteration `training` run with a densify (the
reference's split noise injected), an opacity reset and SH steps, and one
network-GUI poll over loopback. Both models start from the reference's
`capture()` and the port's decoder from the reference's weights, loaded
through `convert.gaussian_model_from_jax` and `FeatureDecoder.from_jax`.

Tolerances, each with its reason:
* resize: atol 1e-5 on values of order 1 (the same triangle kernel, its
  float32 weights computed by other formulas: up to ~6e-6 at 14x);
* decoder: atol 1e-5 (float32 matmuls of width 64);
* one step: the loss and feature_l1 rel 1e-5, gradients rel 1e-3 against
  max(|g|, 1) (the render's sums in other orders, as
  tests/test_torch_train.py's first-step gradients);
* the run: the loss per iteration rel 2e-4 (20 Adam steps, a densify and
  an opacity reset compound the per-step rounding; an element whose
  gradient is at rounding level moves by +-lr in either package, see
  tests/test_torch_train.py), the final alive count and densify
  statistics exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.models import gaussian_model as JGM
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.train import feature_trainer as JFT
from dynamic3dgaussians_tpu_torch import convert
from dynamic3dgaussians_tpu_torch.models import gaussian_model as TGM
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.train import feature_trainer as TFT
from dynamic3dgaussians_tpu_torch.train.trainer import resize_feature_map
from dynamic3dgaussians_tpu_torch.viz import live_viewer as tlv
from dynamic3dgaussians_tpu_torch.viz import network_gui as tng
from tests.scenes import lookat_camera

torch.set_num_threads(1)

W, H, F = 48, 32, 40.0
CAP = 256
JCFG = jrast.RasterConfig(chunk=64, max_per_tile=256,
                          max_tiles_per_gaussian=16, pairs_per_gaussian=16)
TCFG = trast.RasterConfig(chunk=64, max_tiles_per_gaussian=16)
SETUP = dict(position_lr_init=0.002, feature_lr=0.02, opacity_lr=0.05,
             scaling_lr=0.005, semantic_feature_lr=0.01)


def _models(sh_degree=2, semantic_dim=4):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.6, 0.6, (60, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, (60, 3)).astype(np.float32)
    j = JGM.GaussianModel(sh_degree, semantic_dim)
    j.create_from_pcd(pts, cols, spatial_lr_scale=1.0, capacity=CAP)
    # SH of every degree, so that the ramp matters
    rest = np.asarray(j.params["features_rest"]).copy()
    rest[:60] = 0.2 * rng.normal(size=rest[:60].shape)
    j.params["features_rest"] = jnp.asarray(rest)
    t = convert.gaussian_model_from_jax(j.capture(), device="cpu")
    return j.training_setup(**SETUP), t.training_setup(**SETUP)


def _frames(gt_hw=(16, 24), gt_dim=8, n_cams=3):
    rng = np.random.RandomState(1)
    jf, tf = [], []
    for i in range(n_cams):
        jcam, k, w2c = lookat_camera(w=W, h=H, f=F, dist=4.0 + 0.4 * i)
        im = rng.rand(H, W, 3).astype(np.float32)
        gt = (rng.rand(*gt_hw, gt_dim) * 0.1).astype(np.float32)
        jf.append({"camera": jcam, "im": jnp.asarray(im),
                   "gt_feature": jnp.asarray(gt)})
        tf.append({"camera": tcam.make_camera(W, H, k, w2c, device="cpu"),
                   "im": torch.as_tensor(im),
                   "gt_feature": torch.as_tensor(gt)})
    return jf, tf


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


@pytest.mark.parametrize("src,dst", [((32, 48), (25, 45)),
                                     ((25, 45), (32, 48)),
                                     ((360, 640), (25, 45)),
                                     ((25, 45), (360, 640))])
def test_feature_resize_matches_jax(src, dst):
    x = np.random.RandomState(2).normal(size=src + (5,)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst + (5,), "bilinear")
    got = resize_feature_map(torch.as_tensor(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_decoder_from_jax_matches():
    dec = JFT.init_feature_decoder(jax.random.PRNGKey(0), 4, 8)
    fmap = np.random.RandomState(3).normal(size=(8, 8, 4)).astype(np.float32)
    want = JFT.apply_feature_decoder(dec, jnp.asarray(fmap))
    tdec = TFT.FeatureDecoder.from_jax(jax.tree.map(np.asarray, dec),
                                       device="cpu")
    got = tdec(torch.as_tensor(fmap))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for k, v in tdec.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(dec[k]))
    own = TFT.init_feature_decoder(torch.Generator().manual_seed(0), 4, 8,
                                   device="cpu")
    assert own.w1.shape == (4, 64) and own.w2.shape == (64, 8)
    assert float(own.b1.detach().abs().max()) == 0.0
    assert 0.3 < float(own.w1.detach().std()) < 1.0   # He: sqrt(2/4)


@pytest.mark.parametrize("use_decoder,gt_hw", [(False, (20, 30)),
                                               (True, (20, 30)),
                                               (False, (40, 60))])
def test_one_step_matches_jax(use_decoder, gt_hw):
    """Loss, feature_l1 and every gradient of one step, SH degree 2 with
    degree 1 active; the GT feature map smaller (or larger) than the render
    at a non-integer ratio."""
    j, t = _models()
    gt_dim = 8 if use_decoder else 4
    jf, tf = _frames(gt_hw, gt_dim)
    jdec = (JFT.init_feature_decoder(jax.random.PRNGKey(0), 4, gt_dim)
            if use_decoder else {"w1": jnp.zeros((1, 1)),
                                 "b1": jnp.zeros((1,)),
                                 "w2": jnp.zeros((1, 1)),
                                 "b2": jnp.zeros((1,))})
    tdec = (TFT.FeatureDecoder.from_jax(jax.tree.map(np.asarray, jdec),
                                        device="cpu")
            if use_decoder else None)
    jstep = JFT.make_feature_train_step(JCFG, sh_degree=2,
                                        use_decoder=use_decoder)
    tstep = TFT.make_feature_train_step(TCFG, sh_degree=2,
                                        use_decoder=use_decoder)
    jl, jaux, jgp, jgd, jgq = jstep(j.params, j.variables, jdec, jf[0],
                                    jnp.int32(1))
    tl, taux, tgp, tgd, tgq = tstep(t.params, t.variables, tdec, tf[0], 1)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("l1", "ssim", "feature_l1"):
        assert abs(float(taux[k]) - float(jaux[k])) <= \
            1e-5 * abs(float(jaux[k])), k
    np.testing.assert_array_equal(taux["radii"].numpy(),
                                  np.asarray(jaux["radii"]))
    for k in jgp:
        assert _rel(tgp[k].numpy(), jgp[k]) <= 1e-3, k
    assert np.abs(np.asarray(jgp["semantic_feature"])).max() > 0
    # the coefficients above the active degree get no gradient
    assert float(tgp["features_rest"][:, 3:].abs().max()) == 0.0
    assert float(tgp["features_rest"][:, :3].abs().max()) > 0.0
    assert _rel(tgq.numpy(), jgq) <= 1e-3
    if use_decoder:
        for k in jgd:
            assert _rel(tgd[k].numpy(), jgd[k]) <= 1e-3, k
    else:
        assert tgd is None


def _recorder(module, log):
    """make_feature_train_step of `module`, its step recording the loss,
    l1 and feature_l1 of every iteration."""
    make = module.make_feature_train_step

    def wrapped(*a, **k):
        step = make(*a, **k)

        def rec(*args):
            out = step(*args)
            log.append((float(out[0]), float(out[1]["l1"]),
                        float(out[1]["feature_l1"])))
            return out
        return rec
    return wrapped


def _split_noise_stream():
    """The split noise the reference's model draws at each densify, from
    its key PRNGKey(0)."""
    key = jax.random.PRNGKey(0)
    while True:
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        yield tuple(torch.tensor(np.asarray(jax.random.normal(kk, (CAP, 3))))
                    for kk in (k1, k2))


ITERS = 20
RUN_KW = dict(iterations=ITERS, gt_feature_dim=8, densify_from=10,
              densify_every=10, densify_until=15, opacity_reset_every=15,
              sh_increase_every=7, seed=0, checkpoint_iterations=[ITERS])


def test_training_run_matches_jax(monkeypatch):
    j, t = _models()
    jf, tf = _frames()
    jlog, tlog, jck, tck, jden, tden = [], [], [], [], [], []
    monkeypatch.setattr(JFT, "make_feature_train_step", _recorder(JFT, jlog))
    monkeypatch.setattr(TFT, "make_feature_train_step", _recorder(TFT, tlog))
    jd0 = j.densify_and_prune
    j.densify_and_prune = lambda it: jden.append(jd0(it)) or jden[-1]
    noise = _split_noise_stream()
    t.densify_and_prune = lambda it: tden.append(TGM.GaussianModel.
                                                 densify_and_prune(
                                                     t, it, noise=next(noise)
                                                 )) or tden[-1]
    # the port's decoder starts from the reference's initial weights
    jdec0 = jax.tree.map(np.asarray, JFT.init_feature_decoder(
        jax.random.PRNGKey(0), 4, 8))
    monkeypatch.setattr(TFT, "init_feature_decoder",
                        lambda *a, **k: TFT.FeatureDecoder.from_jax(
                            jdec0, device="cpu"))
    _, jdec = JFT.training(jf, j, rcfg=JCFG, **RUN_KW,
                           checkpoint_cb=lambda *a: jck.append(a))
    _, tdec = TFT.training(tf, t, rcfg=TCFG, **RUN_KW,
                           checkpoint_cb=lambda *a: tck.append(a))
    assert len(tlog) == len(jlog) == ITERS
    for i, (tv, jv) in enumerate(zip(tlog, jlog)):
        for a, b in zip(tv, jv):
            assert abs(a - b) <= 2e-4 * abs(b), (i, tv, jv)
    assert len(jden) == len(tden) == 1
    for name in jden[0]._fields:
        assert int(getattr(tden[0], name)) == int(getattr(jden[0], name))
    assert int(jden[0].n_cloned) + int(jden[0].n_split) > 0
    assert t.num_points == j.num_points
    assert (t.active_sh_degree, t.step_count) == (2, ITERS)
    # the reset at 15 and the decoder weights it trained
    (jit_, jstate, jw), (tit, tstate, tw) = jck[0], tck[0]
    assert jit_ == tit == ITERS and set(tw) == set(jw)
    for k in jw:
        assert _rel(tw[k], jw[k]) <= 1e-3, k
    np.testing.assert_array_equal(tstate["variables"]["alive"],
                                  jstate["variables"]["alive"])
    np.testing.assert_array_equal(tdec.to_numpy()["w1"], tw["w1"])
    # no pair was dropped on the reference side
    out = jrast.render(jf[0]["camera"], **j.render_args(), config=JCFG)
    assert int(out.n_dropped_rect) == int(out.n_dropped_capacity) == \
        int(out.n_dropped_tile_overflow) == 0


def test_training_without_decoder_reports():
    _, t = _models(sh_degree=1)
    _, tf = _frames(gt_dim=4)
    reports = []
    _, dec = TFT.training(tf, t, iterations=100, rcfg=TCFG,
                          gt_feature_dim=4,
                          report_cb=lambda it, s, loss: reports.append(
                              (it, sorted(s), loss)))
    assert dec is None
    assert [r[0] for r in reports] == [100]
    assert reports[0][1] == ["feature_l1", "l1", "ssim"]
    assert all(np.isfinite(r[2]) for r in reports)


def test_serve_gui_poll_over_loopback():
    _, t = _models()
    t.oneupSHdegree()
    gui = tng.NetworkGUI(port=0, timeout=30.0, device="cpu")
    cam = tlv.orbit_camera([0, 0, 0], az=0.3, el=0.2, radius=4.0, w=W, h=H,
                           f=F, device="cpu")
    done = threading.Event()

    def loop():
        import time
        for _ in range(1500):
            if gui.conn is not None and not done.is_set():
                TFT._serve_gui(gui, t, TCFG, training_paused=False)
                done.set()
                return
            gui.try_connect()
            time.sleep(0.02)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    client = tlv.GuiClient(port=gui.port, timeout=30.0)
    try:
        img, metrics = client.request(cam)
        th.join(timeout=30.0)
    finally:
        client.close()
        gui.close()
    assert done.is_set()
    assert metrics == {"num_points": 60}
    with torch.no_grad():
        want = trast.render(cam, **t.render_args(), config=TCFG,
                            device="cpu").rgb
    want8 = (np.clip(want.numpy(), 0, 1) * 255).astype(np.uint8)
    assert img.shape == (H, W, 3) and img.max() > 0
    assert np.abs(img.astype(int) - want8.astype(int)).max() <= 1
