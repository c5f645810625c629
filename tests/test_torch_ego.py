"""Port parity: the ego + static dual-dataset trainer (`train/ego_trainer.py`)
and the trainer variants' loss primitives (`train/losses.py`).

The three cases of tests/test_ego_trainer.py, each run through the
reference's `train_ego` (its renders through method "auto": the tiled path
off the TPU) and the port's (`device="cpu"`: the plain versions of K1 and
K2) on the same synthetic scene, rendered by the port, with the same masks
and ground truth: the dual dataset over 2 timesteps (the t > 0 physics
terms included), the ego stream without a static rig, and the rotated ego
path with masks on a non-square image. Every step is reported and held.

Tolerances, each with its reason:
* the loss primitives: values and gradients atol 1e-6 (float32 formulas
  of the same order), disparity Pearson's gradients rel 1e-5 against
  max(|g|, 1) (a reciprocal of small depths);
* the runs: as tests/test_torch_physics.py's 3-timestep run: the image and
  held-out terms per step rel 1e-5 at t = 0 (rel 1e-4 at t > 0, where the
  parameters already carry the physics terms' differences), each physics
  term rel 1e-4 plus atol 1e-5, the total rel 1e-4. bg takes atol
  1.5e-5: its difference is lr x (elements whose first Adam step's sign
  rounding decided) / (background rows), and this scene has 40 background
  rows against the physics run's 120 (atol 5e-6 there); seen 7.0e-6;
* the output parameters: each group within a fraction of lr x steps (the
  most one element can move), 1e-3 (seen at most 1.3e-4, log_scales), and
  0.25 for unnorm_rotations (seen 0.118 at t = 1: Adam turns the
  rounding-level gradients of near-isotropic gaussians' rotations into
  steps of +-lr). An update in the wrong direction moves an element by up
  to 2 x lr x steps, so the bound holds each group's updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import ego_trainer as JE
from dynamic3dgaussians_tpu.train import losses as JL
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import ego_trainer as TE
from dynamic3dgaussians_tpu_torch.train import losses as TL

torch.set_num_threads(1)

ATOL = 1e-6
PHYSICS = ("rigid", "rot", "iso", "floor", "bg", "soft_col_cons")


# ------------------------------------------------------------------- losses

def _grads_match(tfn, jfn, args, rel=None):
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tv = tfn(*targs)
    tg = torch.autograd.grad(tv, targs)
    tv = float(tv.detach())
    assert abs(tv - float(jv)) <= ATOL * max(1.0, abs(float(jv)))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        if rel is None:
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0)
        else:
            assert float((np.abs(a.numpy() - b) / np.maximum(np.abs(b), 1.0))
                         .max()) <= rel
    return tv


def test_tv_and_masked_image_loss_match():
    rng = np.random.RandomState(0)
    img = rng.rand(16, 20, 3).astype(np.float32)
    assert _grads_match(TL.tv_loss, JL.tv_loss, [img]) > 0
    assert float(TL.tv_loss(torch.ones(8, 8))) == 0.0
    gt = rng.rand(16, 20, 3).astype(np.float32)
    mask = np.zeros((16, 20), np.float32)
    mask[:8] = 1.0
    _grads_match(lambda p, g, m: TL.masked_image_loss(p, g, m),
                 lambda p, g, m: JL.masked_image_loss(p, g, m),
                 [img, gt, mask])
    # wrong only outside the mask: no loss
    pred = np.where(mask[..., None] > 0, gt, img)
    assert float(TL.masked_image_loss(torch.as_tensor(pred),
                                      torch.as_tensor(gt),
                                      torch.as_tensor(mask))) < 1e-6
    # a (H, W, 3) mask is used as it is
    _grads_match(lambda p, g: TL.masked_image_loss(
        p, g, torch.as_tensor(np.repeat(mask[..., None], 3, -1))),
        lambda p, g: JL.masked_image_loss(
            p, g, jnp.asarray(np.repeat(mask[..., None], 3, -1))),
        [img, gt])


@pytest.mark.parametrize("with_alpha", [False, True])
def test_depth_losses_match(with_alpha):
    rng = np.random.RandomState(1)
    gt = (rng.rand(16, 16) + 1.0).astype(np.float32)
    gt[:3] = 0.0                                    # no ground truth there
    pred = (gt * 0.5 + 0.3 * rng.rand(16, 16)).astype(np.float32)
    alpha = rng.uniform(0.3, 1.0, (16, 16)).astype(np.float32)
    mask = (rng.rand(16, 16) > 0.2).astype(np.float32)
    if with_alpha:
        _grads_match(lambda d, a: TL.depth_l1_loss(
            d, torch.as_tensor(gt), alpha=a, mask=torch.as_tensor(mask)),
            lambda d, a: JL.depth_l1_loss(d, jnp.asarray(gt), alpha=a,
                                          mask=jnp.asarray(mask)),
            [pred, alpha])
        _grads_match(lambda d, a: TL.disparity_pearson_loss(
            d, torch.as_tensor(gt + 1.0), alpha=a),
            lambda d, a: JL.disparity_pearson_loss(d, jnp.asarray(gt + 1.0),
                                                   alpha=a),
            [pred + 0.5, alpha], rel=1e-5)
    else:
        _grads_match(lambda d: TL.depth_l1_loss(d, torch.as_tensor(gt)),
                     lambda d: JL.depth_l1_loss(d, jnp.asarray(gt)), [pred])
        _grads_match(lambda d: TL.disparity_pearson_loss(
            d, torch.as_tensor(gt + 1.0)),
            lambda d: JL.disparity_pearson_loss(d, jnp.asarray(gt + 1.0)),
            [pred + 0.5], rel=1e-5)
    d = torch.as_tensor(gt + 1.0)
    assert float(TL.disparity_pearson_loss(d, d)) < 1e-5
    assert float(TL.depth_l1_loss(d * 0.5, d, torch.full_like(d, 0.5))) \
        < 1e-6


# ------------------------------------------------------------ the trainer

def _setup(num_t, w=32, h=32, seed=0):
    scene = tsyn.make_gt_scene(n_fg=20, n_bg=40, seed=seed)
    f = 28.0
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=num_t, num_cams=4, w=w,
                                    h=h, f=f, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    kw = dict(num_timesteps=num_t, iters_first_timestep=25,
              iters_per_timestep=10, capacity=128, densify_start=1000,
              densify_end=0, report_every=1, num_knn=8)
    rs = dict(chunk=64, max_per_tile=256, max_tiles_per_gaussian=16,
              pairs_per_gaussian=16)
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(**rs), **kw)
    tcfg = tconf.TrainConfig(raster=tconf.RasterSettings(**rs), **kw)
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    jcams = [jcam.make_camera(w, h, k, np.asarray(fr["camera"].w2c.numpy(),
                                                  np.float64))
             for fr in tds[0]]
    return tds, jcams, w2c, pt, jcfg, tcfg


def _split(tds, jcams, depth=True, rot90=False):
    """Cameras 0-1 the ego stream (masked: the top quarter cut), 2-3 the
    static rig (flat GT depth 4.0 when `depth`); both packages' frames."""
    t_ego, t_stat, j_ego, j_stat = [], [], [], []
    for frames in tds:
        te, ts, je, js = [], [], [], []
        for c, fr in enumerate(frames):
            h, w = fr["im"].shape[:2]
            d = {"im": fr["im"], "cam_id": fr["cam_id"]}
            if c < 2:
                mask = torch.ones((h, w))
                mask[: h // 4] = 0.0
                mask[h // 2:, : w // 3] = 0.0
                d["mask"] = mask
                if rot90:
                    d = {k: (torch.rot90(v, k=-1, dims=(0, 1))
                             if k in ("im", "mask") else v)
                         for k, v in d.items()}
            elif depth:
                d["gt_depth"] = torch.full((h, w), 4.0)
            jd = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                      else jnp.int32(v)) for k, v in d.items()}
            (te if c < 2 else ts).append(dict(d, camera=fr["camera"]))
            (je if c < 2 else js).append(dict(jd, camera=jcams[c]))
        t_ego.append(te)
        t_stat.append(ts)
        j_ego.append(je)
        j_stat.append(js)
    return t_ego, t_stat, j_ego, j_stat


def _run_both(tds, jcams, w2c, pt, jcfg, tcfg, stat=True, depth=True,
              rot90=False):
    t_ego, t_stat, j_ego, j_stat = _split(tds, jcams, depth, rot90)
    if not stat:
        t_stat = [[] for _ in t_ego]
        j_stat = [[] for _ in j_ego]
    jlog, tlog = [], []

    def rec(log):
        return {"on_step": lambda t, i, m: log.append(
            (t, i, {k: float(v) for k, v in m.items()}))}

    jout, _, _ = JE.train_ego(j_ego, j_stat, jcfg, pt, w2c, rot90_ego=rot90,
                              callbacks=rec(jlog))
    tout, tparams, tvars = TE.train_ego(t_ego, t_stat, tcfg, pt, w2c,
                                        rot90_ego=rot90, callbacks=rec(tlog),
                                        device="cpu")
    return jlog, tlog, jout, tout, tvars


def _hold(jlog, tlog):
    assert [x[:2] for x in tlog] == [x[:2] for x in jlog]
    for (t, i, tm), (_, _, jm) in zip(tlog, jlog):
        assert set(jm) == set(tm), (t, i, sorted(jm), sorted(tm))
        for k in jm:
            name = k[len("loss_"):]
            rtol, atol = ((1e-4, 1e-5) if name in PHYSICS else
                          ((1e-5 if t == 0 else 1e-4), 0.0))
            if name == "bg":
                atol = 1.5e-5
            assert abs(tm[k] - jm[k]) <= rtol * abs(jm[k]) + atol, \
                (t, i, k, tm[k], jm[k])


PARAM_FRAC = {"unnorm_rotations": 0.25}


def _hold_params(jout, tout, tcfg, radius, steps):
    assert len(tout) == len(jout)
    for t, (a, b) in enumerate(zip(tout, jout)):
        assert set(a) == set(b)
        for k, v in b.items():
            lr = tcfg.lrs.get(k, 0.0) * (radius if k == "means3D" else 1.0)
            frac = PARAM_FRAC.get(k, 1e-3)
            np.testing.assert_allclose(a[k], np.asarray(v),
                                       atol=frac * lr * steps + 1e-7,
                                       rtol=0, err_msg=(t, k))


def test_ego_dual_dataset_matches_jax():
    tds, jcams, w2c, pt, jcfg, tcfg = _setup(num_t=2)
    jlog, tlog, jout, tout, tvars = _run_both(tds, jcams, w2c, pt, jcfg,
                                              tcfg)
    assert len(tlog) == 25 + 10
    _hold(jlog, tlog)
    first = tlog[0][2]
    for k in ("loss", "loss_im", "loss_stat_im", "loss_depth"):
        assert k in first, (k, sorted(first))
    late = [m for t, _, m in tlog if t == 1]
    assert all(f"loss_{k}" in m for m in late for k in PHYSICS)
    assert all(np.isfinite(list(m.values())).all() for _, _, m in tlog)
    _hold_params(jout, tout, tcfg, float(tvars["scene_radius"]), 35)


def test_ego_without_static_rig_matches_jax():
    tds, jcams, w2c, pt, jcfg, tcfg = _setup(num_t=1)
    jlog, tlog, jout, tout, tvars = _run_both(tds, jcams, w2c, pt, jcfg,
                                              tcfg, stat=False)
    assert "loss_stat_im" not in tlog[0][2]
    assert "loss_depth" not in tlog[0][2]
    _hold(jlog, tlog)
    _hold_params(jout, tout, tcfg, float(tvars["scene_radius"]), 25)


def test_ego_rot90_masked_non_square_matches_jax():
    """rot90_ego turns the rendered (32, 40) ego image to (40, 32) before
    masking against the turned GT and mask; the first step's image loss is
    the unturned baseline's (the loss does not see the turn). The step
    reports the reference's metrics and no PSNR."""
    tds, jcams, w2c, pt, jcfg, tcfg = _setup(num_t=1, w=40, h=32)
    jcfg.iters_first_timestep = tcfg.iters_first_timestep = 6
    jlog, tlog, _, _, _ = _run_both(tds, jcams, w2c, pt, jcfg, tcfg,
                                    depth=False, rot90=True)
    _hold(jlog, tlog)
    assert all("psnr" not in m for _, _, m in tlog)
    t_ego, t_stat, _, _ = _split(tds, jcams, depth=False)
    assert tuple(TE._stack_stat(t_stat[0])[0]["gt_depth"].shape) == (32, 40)
    base = []
    tcfg.iters_first_timestep = 1
    TE.train_ego(t_ego, t_stat, tcfg, pt, w2c, device="cpu",
                 callbacks={"on_step": lambda t, i, m: base.append(
                     float(m["loss_im"]))})
    assert abs(base[0] - tlog[0][2]["loss_im"]) <= 1e-5 * base[0]
