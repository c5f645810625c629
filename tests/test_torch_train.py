"""Port parity: the first-timestep training path (`cli train`, t = 0).

Each ported module against its JAX counterpart on the same numpy-seeded
inputs (losses and SSIM, Adam and its moment surgery, kNN, parameter
initialisation and compaction, densification with injected noise, the RCM
reorder and edge plan, the post-t0 graph), then the slice as a whole: the
JAX `train()` and the port's `train()` on one synthetic scene from the same
initial cloud, and the port's `cli train` on a reference data layout.

Tolerances, each with its reason:
* elementwise float32 functions of the same formula (losses, SSIM, Adam,
  init, densify): atol 1e-6 on values of order 1 (operation order and libm);
* kNN squared distances: atol 1e-5 (|a|^2 + |b|^2 - 2 a.b rounds terms
  up to ~30 here and cancels them to distances ~0.1); index
  sets compared only where neighbouring distances are separated, since
  near-ties may order differently;
* whole run: the loss per step rel 1e-5 and the first step's gradients
  rel 1e-3 against max(|g|, 1) (the render's sums in other orders, see
  test_torch_grad.py); final parameters within 2 x lr x steps per group:
  with Adam's eps of 1e-15 an element whose gradient is at rounding level
  moves by +-lr in either package, so a sign flip there separates the two
  by up to 2 lr per step.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.data import synthetic as jsyn
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import knn as jknn
from dynamic3dgaussians_tpu.ops import neighbor as jnb
from dynamic3dgaussians_tpu.ops import ssim as jssim
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import densify as jden
from dynamic3dgaussians_tpu.train import losses as JL
from dynamic3dgaussians_tpu.train import optim as jopt
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch import cli, convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.models import gaussians as TG
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import knn as tknn
from dynamic3dgaussians_tpu_torch.ops import neighbor as tnb
from dynamic3dgaussians_tpu_torch.ops import ssim as tssim
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import densify as tden
from dynamic3dgaussians_tpu_torch.train import losses as TL
from dynamic3dgaussians_tpu_torch.train import optim as topt
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from dynamic3dgaussians_tpu_torch.viz.export import load_params

torch.set_num_threads(1)

ATOL = 1e-6


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return convert.params_from_jax(_np(tree), "cpu")


def _close(t_tree, j_tree, atol=ATOL, keys=None):
    for k in keys or j_tree:
        a = t_tree[k]
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(j_tree[k]), atol=atol,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("fn", ["calc_ssim", "calc_ssim_per_channel",
                                "dssim", "image_loss", "depth_pearson_loss",
                                "psnr", "l1_v2", "weighted_l2_v1",
                                "weighted_l2_v2", "masked_mean",
                                "cam_correction"])
def test_losses_match(fn):
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    d1 = rng.uniform(1, 5, (24, 20)).astype(np.float32)
    d2 = (d1 + rng.normal(0, 0.3, d1.shape)).astype(np.float32)
    w = rng.uniform(0, 1, (24, 20)).astype(np.float32)
    mask = rng.uniform(0, 1, (24, 20)) > 0.5
    m, c = rng.normal(0, 0.1, 3).astype(np.float32), \
        rng.normal(0, 0.1, 3).astype(np.float32)
    calls = {
        "calc_ssim": lambda M, S, x, y: S.calc_ssim(x(a), x(b)),
        "calc_ssim_per_channel": lambda M, S, x, y: S.calc_ssim(
            x(a), x(b), size_average=False),
        "dssim": lambda M, S, x, y: S.dssim(x(a), x(b)),
        "image_loss": lambda M, S, x, y: M.image_loss(x(a), x(b)),
        "depth_pearson_loss": lambda M, S, x, y: M.depth_pearson_loss(
            x(d1), x(d2)),
        "psnr": lambda M, S, x, y: M.psnr(x(a), x(b)),
        "l1_v2": lambda M, S, x, y: M.l1_loss_v2(x(a), x(b)),
        "weighted_l2_v1": lambda M, S, x, y: M.weighted_l2_loss_v1(
            x(d1), x(d2), x(w)),
        "weighted_l2_v2": lambda M, S, x, y: M.weighted_l2_loss_v2(
            x(a), x(b), x(w)),
        "masked_mean": lambda M, S, x, y: M.masked_mean(x(d1), y(mask)),
        "cam_correction": lambda M, S, x, y: M.apply_cam_correction(
            x(a), x(m), x(c)),
    }
    j = calls[fn](JL, jssim, jnp.asarray, jnp.asarray)
    t = calls[fn](TL, tssim, torch.as_tensor, torch.as_tensor)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_image_loss_gradient_matches():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (16, 12, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (16, 12, 3)).astype(np.float32)
    jg = np.asarray(jax.grad(JL.image_loss)(jnp.asarray(a), jnp.asarray(b)))
    x = torch.tensor(a, requires_grad=True)
    (tg,) = torch.autograd.grad(TL.image_loss(x, torch.as_tensor(b)), x)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-7, rtol=0)
    assert TL.DEFAULT_LOSS_WEIGHTS == JL.DEFAULT_LOSS_WEIGHTS


# ------------------------------------------------------------- optimizer

def _state(seed=0, n=50):
    rng = np.random.RandomState(seed)
    params = {"means3D": rng.normal(size=(n, 3)).astype(np.float32),
              "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
              "cam_m": rng.normal(size=(5, 3)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    mu = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
          for k, v in params.items()}
    nu = {k: rng.uniform(0, 0.1, v.shape).astype(np.float32)
          for k, v in params.items()}
    lrs = {"means3D": 0.01, "logit_opacities": 0.05, "cam_m": 1e-4}
    return params, grads, mu, nu, lrs, rng.uniform(0, 1, n) > 0.5


def test_adam_step_and_surgery_match():
    params, grads, mu, nu, lrs, mask = _state()
    jstate = jopt.AdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                            nu={k: jnp.asarray(v) for k, v in nu.items()},
                            step=jnp.int32(3))
    tstate = convert.adam_state_from_jax(mu, nu, 3, "cpu")
    jp, js = jopt.step({k: jnp.asarray(v) for k, v in params.items()},
                       {k: jnp.asarray(v) for k, v in grads.items()},
                       jstate, {k: jnp.float32(v) for k, v in lrs.items()})
    tp, ts = topt.step(_t(params), _t(grads), tstate,
                       {k: torch.tensor(v) for k, v in lrs.items()})
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)
    assert int(ts.step) == int(js.step) == 4
    for jr, tr in (
            (jopt.reset_moments(js, "logit_opacities"),
             topt.reset_moments(ts, "logit_opacities")),
            (jopt.reset_moments(js, "means3D", jnp.asarray(mask)),
             topt.reset_moments(ts, "means3D", torch.as_tensor(mask))),
            (jopt.mask_moments(js, jnp.asarray(mask), JG.GAUSSIAN_KEYS),
             topt.mask_moments(ts, torch.as_tensor(mask), TG.GAUSSIAN_KEYS))):
        _close(tr.mu, jr.mu, atol=0)
        _close(tr.nu, jr.nu, atol=0)
    assert topt.DEFAULT_LRS == jopt.DEFAULT_LRS


# ------------------------------------------------------------------- kNN

def _gap_ok(d, tol=1e-5):
    """Rows whose k+1 sorted distances are pairwise separated."""
    gaps = np.diff(d, axis=1)
    return (gaps > tol * np.maximum(d[:, 1:], 1e-12)).all(axis=1)


@pytest.mark.parametrize("masked", [False, True])
def test_knn_matches(masked):
    rng = np.random.RandomState(2)
    pts = rng.normal(0, 1, (700, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, 700) > 0.3 if masked else None
    k = 8
    jd, ji = jknn.knn(jnp.asarray(pts), k + 1, row_chunk=256, col_chunk=512,
                      mask=None if mask is None else jnp.asarray(mask))
    td, ti = tknn.knn(torch.as_tensor(pts), k + 1, row_chunk=200,
                      col_chunk=300,
                      mask=None if mask is None else torch.as_tensor(mask))
    jd, ji, td, ti = map(np.asarray, (jd, ji, td.numpy(), ti.numpy()))
    assert ti.dtype == np.int32
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti[~fin], -1)
    rows = fin.all(axis=1)
    sep = rows & _gap_ok(np.where(fin, jd, 0.0))
    assert sep.sum() > 0.9 * rows.sum()
    np.testing.assert_array_equal(ti[sep][:, :k], ji[sep][:, :k])
    jm = np.asarray(jknn.mean3_sq_dist(jnp.asarray(pts)))
    tm = tknn.mean3_sq_dist(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


# -------------------------------------------------- parameters and densify

def _cloud(n_fg=40, n_bg=60, seed=3):
    scene = jsyn.make_gt_scene(n_fg=n_fg, n_bg=n_bg, seed=seed)
    w2c = np.stack([np.asarray(c.w2c) for c in
                    jsyn.orbit_cameras((0, 0, 0), 4.0, -1.0, 4, 64, 48,
                                       55.0)])
    return jsyn.init_point_cloud(scene, noise=0.05), w2c


def test_init_params_and_compaction_match():
    pt, w2c = _cloud()
    jp, jv = JG.init_params(pt, w2c, capacity=256)
    tp, tv = TG.init_params(pt, w2c, capacity=256, device="cpu")
    assert set(tp) == set(jp) and set(tv) == set(jv)
    _close(tp, jp, atol=1e-5)
    _close(tv, jv, atol=0)
    assert TG.round_capacity(1500) == JG.round_capacity(1500) == 2048

    rng = np.random.RandomState(4)
    alive = rng.uniform(0, 1, 256) > 0.4
    jv = dict(jv, alive=jnp.asarray(alive))
    tv = dict(tv, alive=torch.as_tensor(alive))
    jopt_state = jopt.init(jp)
    jopt_state = jopt_state._replace(mu={k: v + 1.0 for k, v in
                                         jopt_state.mu.items()})
    topt_state = convert.adam_state_from_jax(_np(jopt_state.mu),
                                             _np(jopt_state.nu), 0, "cpu")
    jp2, jv2, js2, jorder = JG.compact_with_optimizer(jp, jv, jopt_state)
    tp2, tv2, ts2, torder = TG.compact_with_optimizer(_t(jp), tv,
                                                      topt_state)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    _close(tp2, jp2, atol=0)
    _close(tv2, jv2, atol=0)
    _close(ts2.mu, js2.mu, atol=0)
    assert int(TG.num_alive(tv2)) == int(JG.num_alive(jv2))

    jg = JG.grow_capacity(jp2, jv2, 512, js2)
    tg = TG.grow_capacity(tp2, tv2, 512, ts2)
    for a, b in zip(tg[:2], jg[:2]):
        _close(a, b, atol=0)
    _close(tg[2].nu, jg[2].nu, atol=0)


def _densify_state(cap):
    pt, w2c = _cloud(seed=5)
    jp, jv = JG.init_params(pt, w2c, capacity=cap)
    rng = np.random.RandomState(6)
    n = pt.shape[0]
    jp = dict(jp)
    ls = np.asarray(jp["log_scales"]).copy()
    # max scale around the clone / split threshold 0.01 * radius (0.044),
    # a few past the big-point prune 0.1 * radius
    ls[:n] = np.log(rng.uniform(0.01, 0.09, (n, 1))
                    * rng.uniform(0.5, 1.0, (n, 3)))
    ls[:5] = np.log(0.6)
    jp["log_scales"] = jnp.asarray(ls, jnp.float32)
    lo = np.asarray(jp["logit_opacities"]).copy()
    lo[:n] = rng.normal(0, 3, (n, 1))
    jp["logit_opacities"] = jnp.asarray(lo, jnp.float32)
    q = np.asarray(jp["unnorm_rotations"]).copy()
    q[:n] = rng.normal(size=(n, 4))
    jp["unnorm_rotations"] = jnp.asarray(q, jnp.float32)
    denom = np.where(np.arange(cap) < n, rng.randint(0, 5, cap), 0)
    accum = denom * rng.uniform(0, 4e-4, cap)
    jv = dict(jv, denom=jnp.asarray(denom, jnp.float32),
              means2D_gradient_accum=jnp.asarray(accum, jnp.float32),
              max_2D_radius=jnp.asarray(denom * 2.0, jnp.float32))
    js = jopt.init(jp)
    js = js._replace(mu={k: v + 0.5 for k, v in js.mu.items()},
                     nu={k: v + 0.25 for k, v in js.nu.items()})
    return jp, jv, js


@pytest.mark.parametrize("cap,i", [(512, 600), (512, 3000), (512, 5000),
                                   (112, 600)])
def test_densify_matches(cap, i):
    """One clone / split / prune pass from the same state with the JAX
    draws injected as the split noise; cap 112 leaves too few free slots
    (some clones and splits are dropped and counted)."""
    jp, jv, js = _densify_state(cap)
    key = jax.random.PRNGKey(7)
    jp2, jv2, js2, jst = jden.densify(jp, jv, js, jnp.int32(i), key)
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.tensor(np.asarray(jax.random.normal(kk, (cap, 3))))
                  for kk in (k1, k2))
    tp2, tv2, ts2, tst = tden.densify(
        _t(jp), convert.variables_from_jax(_np(jv), "cpu"),
        convert.adam_state_from_jax(_np(js.mu), _np(js.nu), 0, "cpu"), i,
        noise=noise)
    for name in jst._fields:
        assert int(getattr(tst, name)) == int(getattr(jst, name)), name
    assert int(jst.n_cloned) > 0 and int(jst.n_split) > 0
    assert int(jst.n_pruned) > (5 if i >= 3000 else 0)
    if cap == 112:
        assert int(jst.n_dropped_capacity) > 0
    _close(tp2, jp2, atol=1e-5)
    _close(tv2, jv2, atol=0)
    _close(ts2.mu, js2.mu, atol=0)
    _close(ts2.nu, js2.nu, atol=0)

    jr, jrs = jden.reset_opacity(jp2, js2)
    tr, trs = tden.reset_opacity(tp2, ts2)
    _close(tr, jr, atol=1e-5)
    _close(trs.mu, jrs.mu, atol=0)


def test_accumulate_stats_matches():
    rng = np.random.RandomState(8)
    cap = 64
    v = {"means2D_gradient_accum": rng.uniform(0, 1, cap).astype(np.float32),
         "denom": rng.randint(0, 4, cap).astype(np.float32),
         "max_2D_radius": rng.randint(0, 9, cap).astype(np.float32)}
    g = rng.normal(size=(cap, 2)).astype(np.float32)
    radii = rng.randint(0, 12, cap).astype(np.int32)
    j = jden.accumulate_stats({k: jnp.asarray(x) for k, x in v.items()},
                              jnp.asarray(g), jnp.asarray(radii))
    t = tden.accumulate_stats(_t(v), torch.as_tensor(g),
                              torch.as_tensor(radii))
    _close(t, j, atol=ATOL)


# ------------------------------------------------- neighbour graph, post-t0

def test_locality_order_and_edge_plan_match():
    rng = np.random.RandomState(9)
    cap, k = 300, 6
    idx = rng.randint(0, 200, (cap, k)).astype(np.int32)
    idx[rng.uniform(0, 1, idx.shape) < 0.1] = -1
    idx[200:] = -1
    rows = np.arange(200)
    perm_t = tnb.locality_order(idx, rows, cap)
    np.testing.assert_array_equal(perm_t,
                                  jnb.locality_order(idx, rows, cap))
    for n_dst in (None, 200):
        jplan = jnb.build_edge_reduction(idx, n_dst=n_dst)
        tplan = tnb.build_edge_reduction(idx, n_dst=n_dst)
        np.testing.assert_array_equal(tplan.rank.numpy(),
                                      np.asarray(jplan.rank))
        np.testing.assert_array_equal(tplan.row_ptr.numpy(),
                                      np.asarray(jplan.row_ptr))
        assert tplan.n_valid == jplan.n_valid
    with pytest.raises(ValueError):
        tnb.build_edge_reduction(idx, n_dst=100)


def test_initialize_post_first_timestep_matches():
    pt, w2c = _cloud(n_fg=60, n_bg=40, seed=10)
    jp, jv = JG.init_params(pt, w2c, capacity=256)
    js = jopt.init(jp)
    js = js._replace(mu={k: v + 0.5 for k, v in js.mu.items()})
    jcfg = jconf.TrainConfig(num_knn=8)
    tcfg = tconf.TrainConfig(num_knn=8)
    jp2, jv2, js2 = jtr.initialize_post_first_timestep(jp, jv, jcfg, js)
    timings = {}
    tp2, tv2, ts2 = ttr.initialize_post_first_timestep(
        _t(jp), convert.variables_from_jax(_np(jv), "cpu"), tcfg,
        convert.adam_state_from_jax(_np(js.mu), _np(js.nu), 0, "cpu"),
        timings=timings)
    assert set(timings) == {"knn_s", "rcm_s"}
    # the graph's distances are separated here, so the kNN sets, the RCM
    # order and everything built on them must agree exactly
    d = np.sort(np.asarray(jv2["neighbor_dist"]), axis=1)
    assert _gap_ok(d[np.asarray(jv2["neighbor_indices"])[:, 0] >= 0]).all()
    assert set(tv2) == set(jv2)
    _close(tp2, jp2, atol=1e-5)
    for key in ("alive", "neighbor_indices", "edge_rank", "edge_row_ptr"):
        np.testing.assert_array_equal(tv2[key].numpy(),
                                      np.asarray(jv2[key]), err_msg=key)
    _close(tv2, jv2, atol=1e-5)
    _close(ts2.mu, js2.mu, atol=0)
    out_t = ttr.params_to_cpu(tp2, tv2, True)
    out_j = jtr.params_to_cpu(jp2, jv2, True)
    _close(out_t, out_j, atol=1e-5)


# ---------------------------------------------------------------- config

def test_config_json_round_trips_between_packages():
    jcfg = jconf.TrainConfig(iters_first_timestep=7, seed=3,
                             raster=jconf.RasterSettings(method="pallas",
                                                         chunk=64))
    tcfg = tconf.TrainConfig.from_json(jcfg.to_json())
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    assert tcfg.raster.render_method() == "auto"
    assert tconf.RasterSettings(method="tiled").render_method() == "tiled"
    # an unknown method raises; the numerics-changing settings, refused
    # before they were ported, reach the render's RasterConfig
    for over in (dict(method="xla"), dict(power_impl="mxu_fused"),
                 dict(pack_records=True)):
        settings = tconf.RasterSettings(**over)
        if "method" in over:
            with pytest.raises(ValueError):
                settings.render_method()
            continue
        assert settings.render_method() == "auto"
        rcfg = ttr.raster_config(tconf.TrainConfig(raster=settings))
        jrcfg = jtr.raster_config(jconf.TrainConfig(
            raster=jconf.RasterSettings(**over)))
        for f in dataclasses.fields(rcfg):
            assert getattr(rcfg, f.name) == getattr(jrcfg, f.name), f.name


# ------------------------------------------------------- the slice, whole

SCENE_KW = dict(n_fg=60, n_bg=120, seed=0)
W, H, F = 64, 48, 55.0


@pytest.fixture(scope="module")
def world():
    """One synthetic scene seen by 4 cameras, rendered by the port, as
    datapoints of both packages (the same images and cameras)."""
    scene = tsyn.make_gt_scene(**SCENE_KW)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=1, num_cams=4, w=W, h=H,
                                    f=F, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    np.testing.assert_array_equal(pt, jsyn.init_point_cloud(
        jsyn.make_gt_scene(**SCENE_KW), noise=0.05))
    k = [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]]
    ds = [[{"camera": jcam.make_camera(W, H, k, np.asarray(
                fr["camera"].w2c.numpy(), np.float64), near=0.01,
                far=100.0),
            "im": jnp.asarray(fr["im"].numpy()),
            "seg": jnp.asarray(fr["seg"].numpy()),
            "cam_id": jnp.int32(fr["cam_id"])} for fr in tds[0]]]
    return ds, tds, pt, w2c


ITERS = 6
RUN_KW = dict(num_timesteps=1, iters_first_timestep=ITERS,
              densify_start=10 ** 9, capacity=1024, report_every=1, seed=2)


def _cfgs():
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="pallas"), **RUN_KW)
    tcfg = tconf.TrainConfig(raster=tconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="pallas"), **RUN_KW)
    return jcfg, tcfg


def test_first_step_gradients_match(world):
    ds, tds, pt, w2c = world
    jcfg, tcfg = _cfgs()
    jp, jv = JG.init_params(pt, w2c, capacity=1024)
    probe = jnp.zeros((1024, 2), jnp.float32)
    # jitted: one compile of the interpret-mode kernels instead of eager
    # dispatch of their every grid step
    (jl, _), (jg, jgp) = jax.jit(jax.value_and_grad(
        lambda p, q: jtr.compute_loss(p, q, ds[0][1], jv, is_initial=True,
                                      cfg=jcfg, rcfg=jtr.raster_config(jcfg)),
        argnums=(0, 1), has_aux=True))(jp, probe)
    tp, tv = TG.init_params(pt, w2c, capacity=1024, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tprobe = torch.zeros((1024, 2), requires_grad=True)
    tl, _ = ttr.compute_loss(leaves, tprobe, tds[0][1], tv, is_initial=True,
                             cfg=tcfg, rcfg=ttr.raster_config(tcfg))
    keys = sorted(leaves)
    grads = torch.autograd.grad(tl, [leaves[k] for k in keys] + [tprobe],
                                allow_unused=True)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(_np(jg), probe=np.asarray(jgp))
    for k, g in zip(keys + ["probe"], grads):
        g = np.zeros_like(want[k]) if g is None else g.numpy()
        err = np.abs(g - want[k]) / np.maximum(np.abs(want[k]), 1.0)
        assert err.max() <= 1e-3, (k, float(err.max()))
    assert np.abs(want["means3D"]).max() > 0


def test_train_matches_jax_train(world, tmp_path):
    ds, tds, pt, w2c = world
    jcfg, tcfg = _cfgs()
    jlog, tlog = [], []

    def rec(log):
        return {"on_step": lambda t, i, m: log.append(
            (i, float(m["loss"]), float(m["psnr"]), int(m["n_dropped"])))}
    jout, _, _ = jtr.train(ds, jcfg, pt, w2c, callbacks=rec(jlog))
    tout, _, tvars = ttr.train(tds, tcfg, pt, w2c, callbacks=rec(tlog),
                               device="cpu")
    assert [x[0] for x in tlog] == [x[0] for x in jlog] == list(range(ITERS))
    for (_, tl, tp, td), (_, jl, jp, jd) in zip(tlog, jlog):
        assert abs(tl - jl) <= 1e-5 * abs(jl) and td == jd == 0
        assert abs(tp - jp) <= 1e-3
    assert set(tout[0]) == set(jout[0])
    radius = float(tvars["scene_radius"])
    for k, v in jout[0].items():
        lr = tcfg.lrs.get(k, 0.0) * (radius if k == "means3D" else 1.0)
        np.testing.assert_allclose(tout[0][k], np.asarray(v),
                                   atol=2 * lr * ITERS + 1e-6, rtol=0,
                                   err_msg=k)
    # the RCM reorder put the same rows first: foreground prefix, same order
    np.testing.assert_array_equal(tout[0]["seg_colors"],
                                  np.asarray(jout[0]["seg_colors"]))
    from dynamic3dgaussians_tpu_torch.viz.export import save_params
    path = save_params(tout, str(tmp_path))
    assert set(load_params(path)) == set(tout[0])


def test_train_with_densify_and_k_escalation(world):
    """Port only: a densify pass grows the table and the output holds the
    alive rows; a K too small for the splats is escalated at a report."""
    _, tds, pt, w2c = world
    cfg = tconf.TrainConfig(
        num_timesteps=1, iters_first_timestep=5, densify_start=2,
        densify_every=2, capacity=256, report_every=2,
        raster=tconf.RasterSettings(chunk=64, max_tiles_per_gaussian=2,
                                    method="torch"))
    cfg.loss_weights = dict(cfg.loss_weights, im=500.0)   # hot gradients
    events = {"densify": [], "grow": [], "steps": [], "iters": []}
    out, params, variables = ttr.train(
        tds, cfg, pt, w2c, device="cpu", callbacks={
            "on_densify": lambda t, i, s: events["densify"].append((i, s)),
            "on_grow_tiles": lambda t, i, k: events["grow"].append((i, k)),
            "on_step": lambda t, i, m: events["steps"].append(
                float(m["loss"])),
            "on_iter": lambda t, i, k: events["iters"].append((i, k))})
    assert [i for i, _ in events["densify"]] == [2, 4]
    last = events["densify"][-1][1]
    assert int(events["densify"][0][1].n_cloned) + int(
        events["densify"][0][1].n_split) > 0
    assert out[0]["means3D"].shape[0] == int(last.n_alive)
    assert variables["alive"][:int(last.n_alive)].all()
    assert events["grow"] and events["grow"][0] == (0, 4)
    # on_iter after every step, with the K that step rendered with
    assert [i for i, _ in events["iters"]] == list(range(5))
    assert events["iters"][0] == (0, 2) and events["iters"][1] == (1, 4)
    assert np.isfinite(events["steps"]).all()


def test_cli_train_on_reference_layout(tmp_path):
    scene = tsyn.make_gt_scene(n_fg=30, n_bg=60, seed=1)
    tsyn.write_reference_layout(str(tmp_path / "data"), "seq", num_t=1,
                                num_cams=3, w=48, h=32, f=40.0, scene=scene,
                                device="cpu")
    over = tmp_path / "cfg.json"
    over.write_text(json.dumps({"report_every": 2, "densify_start": 10 ** 9,
                                "raster": {"chunk": 64}}))
    argv = ["train", "--data_root", str(tmp_path / "data"), "--seq", "seq",
            "--exp", "e", "--output", str(tmp_path / "out"),
            "--timesteps", "1", "--iters_first", "4", "--capacity", "512",
            "--config_json", str(over), "--device", "cpu", "--time_steps"]
    assert cli.main(argv) == 0
    run = tmp_path / "out" / "e" / "seq"
    stacked = load_params(str(run / "params.npz"))
    assert stacked["means3D"].shape == (1, 90, 3)
    assert stacked["cam_m"].shape == (1, 5, 3)
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if "t0/loss" in r] == [0, 2]
    assert any("t0/graph/knn_s" in r for r in rows)
    # --time_steps: every step but the first, with its K
    timed = [(r["step"], r["t0/time/k"]) for r in rows
             if "t0/time/step_ms" in r]
    assert timed == [(i, 8) for i in range(1, 4)]
    cfg = json.loads((run / "cfg_args.json").read_text())
    assert cfg["iters_first_timestep"] == 4 and cfg["raster"]["chunk"] == 64
    jconf.TrainConfig.from_json((run / "cfg_args.json").read_text())
    assert os.path.exists(run / "panel_t0_0000000.png")


def test_train_refuses_later_slices(world):
    """A kNN method other than exact or approx raises. neighbor_window,
    refused before it was ported, builds the same frozen graph as the
    reference's initialize_post_first_timestep (which adds its window
    plan, `win_*`, at capacity 1024: the plan needs a multiple of 128),
    and a t > 0 train step from the reference's state, its params moved
    off the first step's tie so that rigid, rot and iso carry the fetched
    neighbours, equals the reference's step through its windowed fetch:
    the loss and each of those terms within 1e-5 relative, the new
    parameters within 2 lr (as `test_train_matches_jax_train`). Both on
    the "tiled" path. (Checkpoints, refused here before, are ported: see
    tests/test_torch_checkpoint.py.)"""
    ds, tds, pt, w2c = world
    cfg = tconf.TrainConfig(num_timesteps=1, iters_first_timestep=1,
                            densify_start=10 ** 9, capacity=1024,
                            raster=tconf.RasterSettings(chunk=64),
                            knn_method="kdtree")
    with pytest.raises(NotImplementedError, match="knn_method"):
        ttr.train(tds, cfg, pt, w2c, device="cpu")

    kw = dict(neighbor_window=True, num_knn=8, knn_weight_beta=20.0)
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="tiled"), **kw)
    tcfg = tconf.TrainConfig(raster=tconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="tiled"), **kw)
    jp, jv = JG.init_params(pt, w2c, capacity=1024)
    js = jopt.init(jp)
    tp, tv, ts = ttr.initialize_post_first_timestep(
        _t(jp), convert.variables_from_jax(_np(jv), "cpu"), tcfg,
        convert.adam_state_from_jax(_np(js.mu), _np(js.nu), 0, "cpu"))
    jp, jv, js = jtr.initialize_post_first_timestep(jp, jv, jcfg, js)
    assert "win_start" in jv and not any(k.startswith("win_") for k in tv)
    for key in ("neighbor_indices", "edge_rank", "edge_row_ptr"):
        np.testing.assert_array_equal(tv[key].numpy(), np.asarray(jv[key]),
                                      err_msg=key)
    _close(tp, jp, atol=1e-6)

    jp, jv, js = jtr.initialize_per_timestep(jp, jv, js)
    rng = np.random.RandomState(13)
    jp = {k: (v + jnp.asarray(rng.normal(0, 0.01, v.shape), jnp.float32)
              if k in ("means3D", "unnorm_rotations", "rgb_colors") else v)
          for k, v in jp.items()}
    lrs = {k: float(jcfg.lrs.get(k, 0.0)) * (
        float(jv["scene_radius"]) if k == "means3D" else 1.0)
        * (0.0 if k in jcfg.freeze_after_t0 else 1.0) for k in jp}
    jstep = jtr.make_train_step(jcfg, jtr.raster_config(jcfg))
    jp2, _, _, jm = jstep(jp, js, jv, ds[0][1],
                          {k: jnp.float32(v) for k, v in lrs.items()},
                          is_initial=False)
    tstep = ttr.make_train_step(tcfg, ttr.raster_config(tcfg))
    tp2, _, _, tm = tstep(
        _t(jp), convert.adam_state_from_jax(_np(js.mu), _np(js.nu),
                                            js.step, "cpu"),
        convert.variables_from_jax(_np(jv), "cpu"), tds[0][1],
        {k: torch.tensor(v) for k, v in lrs.items()}, False)
    for key in ("loss", "loss_rigid", "loss_rot", "loss_iso"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            1e-5 * abs(float(jm[key])), key
        assert float(jm[key]) > 1e-4, key
    for k in jp2:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   atol=2 * lrs[k] + 1e-6, rtol=0, err_msg=k)
