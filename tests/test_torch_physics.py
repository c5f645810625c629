"""Port parity: the t > 0 training step (`cli train` past the first timestep).

Each t > 0 module against its JAX counterpart on the same numpy-seeded
inputs (the neighbour lookup and its backward, the physics losses and their
gradients, the start of a timestep), one t > 0 train step, then the slice as
a whole: JAX `train()` and the port's `train()` over 3 timesteps of one
synthetic scene from the same initial cloud, and the port's default
`cli train` on a 3-timestep reference data layout.

The port keeps the neighbour records row-major, (cap, K, F) and (cap, K);
the reference feature-major, (F, K, cap) and (K, cap): the tests transpose.

Tolerances, each with its reason:
* neighbour lookup: forward exact (a gather); backward atol 1e-5 -- the
  port sums each destination's run in order, the reference takes
  differences of one running float32 sum over all edges, whose error grows
  with the running total (here ~10 over a few hundred edges);
* physics losses: values and gradients atol 1e-6 (float32 formulas of the
  same order, the 3x3 rotation of the offsets summed in another order),
  with the edges weighted at KNN_BETA so that every term the state makes
  nonzero, and its own gradient, is at least 100x that;
* one t > 0 train step: the loss rel 1e-5, and new parameters within
  atol 1e-6 plus 2 x lr, since Adam's eps of 1e-15 lets an element whose
  gradient is at rounding level move by +-lr in either package;
* the whole 3-timestep run: the image and segmentation losses per report
  rel 1e-5, as at t = 0; each physics term rel 1e-4 plus atol 1e-5 (bg
  5e-6), and the total loss rel 1e-4. At the first step of each t > 0 the
  background rotations differ from init_bg_rot only by rounding (normalize
  applied twice), so the sign |x| takes there, and with it Adam's first
  step of +-lr in those elements, is decided by rounding the packages do
  differently; bg then differs by lr x (elements flipped) / n, seen up to
  3.6e-6, and enters the total with weight 20. floor, bg and soft_col_cons
  are each at least 100x their atol in the run; rigid, rot and iso are
  held live on the run's own trained states (values and gradients atol
  1e-6, edges weighted at KNN_BETA). Parameters agree within the growth of
  the 2 x lr per step through the forward extrapolation x + (x - prev_x),
  which doubles a difference carried into a timestep.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.data import synthetic as jsyn
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import neighbor as jnb
from dynamic3dgaussians_tpu.ops import quat as jquat
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import losses as JL
from dynamic3dgaussians_tpu.train import optim as jopt
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu.viz import export as jexp
from dynamic3dgaussians_tpu_torch import cli, convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.ops import neighbor as tnb
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import losses as TL
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from dynamic3dgaussians_tpu_torch.viz import export as texp

torch.set_num_threads(1)

ATOL = 1e-6
PHYSICS = ("rigid", "rot", "iso", "floor", "bg", "soft_col_cons")
# The neighbour weight is exp(-beta d^2). These scenes are sparse (median
# foreground neighbour distance ~0.33), so the default beta of 2000 would
# leave all but ~0.4 % of the edges at a weight of e^-30 or less, and rigid,
# rot and iso at the sqrt(1e-20) floor of their terms; at 20, ~77 % of the
# edges weigh more than 1e-2 (the regime of a real scene at 2000), so the
# weighted edges carry the terms a wrong rotation, offset or lookup would
# move.
KNN_BETA = 20.0
# each physics term, and its gradient, at least this many times the
# tolerance it is held to
LIVE = 100


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return convert.params_from_jax(_np(tree), "cpu")


# ------------------------------------------------------- neighbour lookup

@pytest.mark.parametrize("prefix", [False, True])
def test_neighbor_lookup_matches(prefix):
    """Forward and backward with invalid slots, on the full plan and on a
    foreground-prefix plan (rows past n_dst read 0.0 and get no
    gradient)."""
    rng = np.random.RandomState(0)
    cap, k, f, n_fg = 96, 5, 7, 41
    tbl = rng.normal(size=(cap, f)).astype(np.float32)
    idx = np.full((cap, k), -1, np.int32)
    idx[:n_fg] = rng.randint(0, n_fg, (n_fg, k))
    idx[rng.uniform(0, 1, idx.shape) < 0.1] = -1
    n_dst = n_fg if prefix else None
    jplan = jnb.build_edge_reduction(idx, n_dst=n_dst)
    tplan = tnb.build_edge_reduction(idx, n_dst=n_dst)
    cot = rng.normal(size=(cap, k, f)).astype(np.float32)

    jrec, jvjp = jax.vjp(lambda x: jnb.neighbor_lookup(
        x, jnp.asarray(idx), jplan, k), jnp.asarray(tbl))
    (jg,) = jvjp(jnp.asarray(cot.transpose(2, 1, 0)))
    x = torch.tensor(tbl, requires_grad=True)
    trec = tnb.neighbor_lookup(x, torch.as_tensor(idx), tplan)
    (tg,) = torch.autograd.grad(trec, x, torch.as_tensor(cot))

    assert tuple(trec.shape) == (cap, k, f)
    np.testing.assert_array_equal(trec.detach().numpy(),
                                  np.asarray(jrec).transpose(2, 1, 0))
    if prefix:
        assert float(trec[48:].abs().max()) == 0.0     # n_dst rounded to 48
        assert float(tg[48:].abs().max()) == 0.0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
    # an invalid slot passes no gradient: the plain gather's transpose
    # over the valid edges only
    want = np.zeros_like(tbl)
    for i, kk in zip(*np.nonzero(idx >= 0)):
        want[idx[i, kk]] += cot[i, kk]
    np.testing.assert_allclose(tg.numpy(), want, atol=1e-5, rtol=0)

    comps = tnb.lookup_components([x[:, c] for c in range(3)],
                                  torch.as_tensor(idx), tplan)
    assert len(comps) == 3 and tuple(comps[0].shape) == (cap, k)
    np.testing.assert_array_equal(comps[2].detach().numpy(),
                                  trec[..., 2].detach().numpy())


# -------------------------------------------- the state of a timestep t > 0

def _cloud(n_fg=60, n_bg=40, seed=10):
    scene = jsyn.make_gt_scene(n_fg=n_fg, n_bg=n_bg, seed=seed)
    w2c = np.stack([np.asarray(c.w2c) for c in
                    jsyn.orbit_cameras((0, 0, 0), 4.0, -1.0, 4, 64, 48,
                                       55.0)])
    return jsyn.init_point_cloud(scene, noise=0.05), w2c


def _post_t0_state(seed=11):
    """The reference's state after t = 0 (graph and reorder built), with
    the means, rotations and colours moved as if t = 0 had trained them."""
    pt, w2c = _cloud()
    jp, jv = JG.init_params(pt, w2c, capacity=256)
    js = jopt.init(jp)
    js = js._replace(mu={k: v + 0.5 for k, v in js.mu.items()},
                     nu={k: v + 0.25 for k, v in js.nu.items()})
    jp, jv, js = jtr.initialize_post_first_timestep(
        jp, jv, jconf.TrainConfig(num_knn=8, knn_weight_beta=KNN_BETA), js)
    rng = np.random.RandomState(seed)
    jp = dict(jp)
    for key, sd in (("means3D", 0.02), ("unnorm_rotations", 0.05),
                    ("rgb_colors", 0.05)):
        v = np.asarray(jp[key])
        jp[key] = jnp.asarray(v + rng.normal(0, sd, v.shape), jnp.float32)
    return jp, jv, js


def test_initialize_per_timestep_matches():
    jp, jv, js = _post_t0_state()
    jp2, jv2, js2 = jtr.initialize_per_timestep(jp, jv, js)
    tp2, tv2, ts2 = ttr.initialize_per_timestep(
        _t(jp), convert.variables_from_jax(_np(jv), "cpu"),
        convert.adam_state_from_jax(_np(js.mu), _np(js.nu), 0, "cpu"))
    assert set(tp2) == set(jp2) and set(tv2) == set(jv2)
    for k in jp2:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    # the layouts differ only in prev_offset: (cap, K, 3) against (3, K, cap)
    off = np.asarray(jv2["prev_offset"])
    idx = np.asarray(jv2["neighbor_indices"])
    ok = (idx >= 0)[..., None]
    np.testing.assert_allclose(
        np.where(ok, tv2["prev_offset"].numpy(), 0.0),
        np.where(ok, off.transpose(2, 1, 0), 0.0), atol=ATOL, rtol=0)
    assert float(np.abs(np.where(ok, off.transpose(2, 1, 0), 0)).max()) > 0
    for k in jv2:
        if k != "prev_offset":
            np.testing.assert_allclose(tv2[k].numpy(), np.asarray(jv2[k]),
                                       atol=ATOL, rtol=0, err_msg=k)
    for k in js2.mu:
        np.testing.assert_array_equal(ts2.mu[k].numpy(),
                                      np.asarray(js2.mu[k]), err_msg=k)
        np.testing.assert_array_equal(ts2.nu[k].numpy(),
                                      np.asarray(js2.nu[k]), err_msg=k)
    assert float(np.abs(np.asarray(js2.mu["means3D"])).max()) == 0.0
    # the reference's mid-sequence state loads as the port's
    tv_loaded = convert.variables_from_jax(_np(jv2), "cpu")
    np.testing.assert_array_equal(tv_loaded["prev_offset"].numpy(),
                                  off.transpose(2, 1, 0))


@pytest.mark.parametrize("case", ["first_step", "moved"])
def test_physics_losses_match(case):
    """Values and gradients of every physics term. `first_step` is the
    state right after initialize_per_timestep: the background means and
    rotations equal init_bg_* and the colours prev_col exactly, so bg and
    soft_col_cons take |0| -- the reference's derivative there is +1."""
    jp, jv, js = _post_t0_state()
    jp, jv, _ = jtr.initialize_per_timestep(jp, jv, js)
    if case == "first_step":
        # the background as it was at the end of t = 0
        jv = dict(jv, init_bg_pts=jp["means3D"],
                  init_bg_rot=jquat.normalize(jp["unnorm_rotations"]))
    else:
        rng = np.random.RandomState(12)
        jp = {k: (v + jnp.asarray(rng.normal(0, 0.01, v.shape), jnp.float32)
                  if k in ("means3D", "unnorm_rotations", "rgb_colors")
                  else v) for k, v in jp.items()}
    alive = jv["alive"]
    is_fg = jp["seg_colors"][:, 0] > 0.5
    act = JG.activated(jp, alive)
    args = (act["means3d"], act["rotations"], jp["rgb_colors"])

    def jtotal(m, r, c):
        out = JL.physics_losses(m, r, c, jv, is_fg, alive)
        return sum(out.values()), out

    (_, jout), jgrads = jax.value_and_grad(jtotal, argnums=(0, 1, 2),
                                           has_aux=True)(*args)
    tv = convert.variables_from_jax(_np(jv), "cpu")
    xs = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    tout = TL.physics_losses(*xs, tv, torch.as_tensor(np.asarray(is_fg)),
                             torch.as_tensor(np.asarray(alive)))
    tgrads = torch.autograd.grad(sum(tout.values()), xs, retain_graph=True)
    assert set(tout) == set(jout) == set(PHYSICS)
    for k in PHYSICS:
        assert abs(float(tout[k]) - float(jout[k])) <= ATOL, k
    for name, tg, jg in zip(("means", "rots", "colors"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL,
                                   rtol=0, err_msg=name)
    # every term the state makes nonzero, and its own gradient, is far
    # above the tolerance, so the comparison above can see it
    live = PHYSICS if case == "moved" else ("rigid", "rot", "iso", "floor")
    for k in live:
        assert float(tout[k]) >= LIVE * ATOL, (k, float(tout[k]))
        g = torch.autograd.grad(tout[k], xs, retain_graph=True,
                                allow_unused=True)
        g_max = max(float(x.abs().max()) for x in g if x is not None)
        assert g_max >= LIVE * ATOL, (k, g_max)
    if case == "first_step":
        assert float(jout["bg"]) == float(tout["bg"]) == 0.0
        assert float(tout["soft_col_cons"]) == 0.0
        # +1 per element: the mean over the n alive rows of the L1 sums
        live = np.asarray(alive)
        np.testing.assert_allclose(tgrads[2].numpy()[live],
                                   1.0 / live.sum(), rtol=1e-6)


# ---------------------------------------------------------- the slice, whole

SCENE_KW = dict(n_fg=60, n_bg=120, seed=0)
W, H, F = 64, 48, 55.0
NUM_T = 3
ITERS_FIRST, ITERS_LATER = 6, 4


@pytest.fixture(scope="module")
def world3():
    """One synthetic scene over 3 timesteps (the foreground moves rigidly)
    seen by 4 cameras, rendered by the port, as datapoints of both
    packages."""
    scene = tsyn.make_gt_scene(**SCENE_KW)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=NUM_T, num_cams=4, w=W, h=H,
                                    f=F, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    k = [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]]
    ds = [[{"camera": jcam.make_camera(W, H, k, np.asarray(
                fr["camera"].w2c.numpy(), np.float64), near=0.01,
                far=100.0),
            "im": jnp.asarray(fr["im"].numpy()),
            "seg": jnp.asarray(fr["seg"].numpy()),
            "cam_id": jnp.int32(fr["cam_id"])} for fr in frames]
          for frames in tds]
    return ds, tds, pt, w2c


RUN_KW = dict(num_timesteps=NUM_T, iters_first_timestep=ITERS_FIRST,
              iters_per_timestep=ITERS_LATER, densify_start=10 ** 9,
              capacity=1024, report_every=1, seed=2, num_knn=8)


def _cfgs():
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="pallas"), **RUN_KW)
    tcfg = tconf.TrainConfig(raster=tconf.RasterSettings(
        chunk=64, max_tiles_per_gaussian=64, method="pallas"), **RUN_KW)
    return jcfg, tcfg


def _recorder(log):
    return {"on_step": lambda t, i, m: log.append(
        (t, i, {k: float(v) for k, v in m.items()}))}


@pytest.fixture(scope="module")
def runs(world3):
    """JAX `train()` and the port's `train()` over the 3 timesteps, once,
    with the port's state at the end of each timestep."""
    ds, tds, pt, w2c = world3
    jcfg, tcfg = _cfgs()
    jlog, tlog, states = [], [], {}
    jout, jparams, _ = jtr.train(ds, jcfg, pt, w2c, callbacks=_recorder(jlog))
    tcb = dict(_recorder(tlog), on_timestep=lambda t, p, v: states.update(
        {t: ({k: x.detach().clone() for k, x in p.items()},
             {k: x.clone() for k, x in v.items()})}))
    tout, tparams, tvars = ttr.train(tds, tcfg, pt, w2c, callbacks=tcb,
                                     device="cpu")
    return dict(jlog=jlog, tlog=tlog, jout=jout, tout=tout, states=states,
                radius=float(tvars["scene_radius"]), tcfg=tcfg)


def test_train_losses_match_jax_train(runs):
    jlog, tlog = runs["jlog"], runs["tlog"]
    steps = [(0, i) for i in range(ITERS_FIRST)] + [
        (t, i) for t in range(1, NUM_T) for i in range(ITERS_LATER)]
    assert [x[:2] for x in tlog] == [x[:2] for x in jlog] == steps
    tols = dict(loss=(1e-4, 0.0), loss_im=(1e-5, 0.0), loss_seg=(1e-5, 0.0),
                **{f"loss_{k}": (1e-4, 1e-5) for k in PHYSICS})
    tols["loss_bg"] = (1e-4, 5e-6)
    for (t, i, tm), (_, _, jm) in zip(tlog, jlog):
        keys = ["loss", "loss_im", "loss_seg"] + (
            [f"loss_{k}" for k in PHYSICS] if t else [])
        assert set(keys) <= set(tm) and set(keys) <= set(jm), (t, i)
        for k in keys:
            rtol, atol = tols[k]
            assert abs(tm[k] - jm[k]) <= rtol * abs(jm[k]) + atol, \
                (t, i, k, tm[k], jm[k])
        assert tm["n_dropped"] == jm["n_dropped"] == 0
    # floor, bg and soft_col_cons are live: far above their atol at every
    # t > 0 step (bg and soft_col_cons past the first step of a timestep,
    # where they are |0| by construction). rigid, rot and iso run at the
    # default beta here, as training runs them, and are held live on this
    # run's own trained states in `test_physics_on_trained_states`.
    for k in ("floor", "bg", "soft_col_cons"):
        vals = [m[f"loss_{k}"] for t, i, m in tlog
                if t and (i or k == "floor")]
        assert min(vals) >= LIVE * tols[f"loss_{k}"][1], (k, vals)


@pytest.mark.parametrize("t", [1, 2])
def test_physics_on_trained_states(runs, t):
    """Every physics term and its gradient, in both packages, on the port's
    own state at the end of timestep t of the 3-timestep run: the
    neighbour graph, offsets and rotations training really produces, with
    the edges weighted at KNN_BETA so that rigid, rot and iso are live.

    The run itself cannot hold these three tightly once they are live: at
    the first step of a timestep every rotation equals prev and every
    offset its prev, so each term's sqrt sits at its 1e-20 floor and the
    sign of its gradient comes from rounding residuals, which differ
    between the packages once their states differ by rounding; Adam turns
    each sign into a move of +-lr (seen: these terms ~1e-4 apart by 5-40 %
    a few steps later at beta 20, and the t = 2 image losses 2e-4 apart)."""
    tp, tv = runs["states"][t]
    dist = tv["neighbor_dist"]
    tv = dict(tv, neighbor_weight=torch.exp(-KNN_BETA * dist * dist))
    jv = {k: v.numpy() for k, v in tv.items()}
    jv["prev_offset"] = jv["prev_offset"].transpose(2, 1, 0)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    alive = jnp.asarray(jv["alive"])
    is_fg = jp["seg_colors"][:, 0] > 0.5
    act = JG.activated(jp, alive)
    args = (act["means3d"], act["rotations"], jp["rgb_colors"])
    jv = {k: jnp.asarray(v) for k, v in jv.items()}
    xs = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    tout = TL.physics_losses(*xs, tv, torch.as_tensor(np.asarray(is_fg)),
                             torch.as_tensor(np.asarray(alive)))
    for k in PHYSICS:
        jval, jg = jax.value_and_grad(
            lambda m, r, c: JL.physics_losses(m, r, c, jv, is_fg, alive)[k],
            argnums=(0, 1, 2))(*args)
        assert abs(float(tout[k]) - float(jval)) <= ATOL, k
        assert float(tout[k]) >= LIVE * ATOL, (k, float(tout[k]))
        tg = torch.autograd.grad(tout[k], xs, retain_graph=True,
                                 allow_unused=True)
        g_max = 0.0
        for x, g, want in zip(xs, tg, jg):
            g = torch.zeros_like(x) if g is None else g
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0, err_msg=k)
            g_max = max(g_max, float(g.abs().max()))
        assert g_max >= LIVE * ATOL, (k, g_max)


def test_train_outputs_match_jax_train(runs, tmp_path):
    jout, tout, tcfg = runs["jout"], runs["tout"], runs["tcfg"]
    assert len(tout) == len(jout) == NUM_T
    later = {"means3D", "rgb_colors", "unnorm_rotations"}
    assert set(tout[1]) == set(jout[1]) == set(tout[2]) == later
    # per element: 2 lr per step, doubled by each forward extrapolation
    tol = {}
    for k in later:
        lr = tcfg.lrs[k] * (runs["radius"] if k == "means3D" else 1.0)
        e_prev, e = 0.0, 2 * lr * ITERS_FIRST
        bounds = [e]
        for _ in range(1, NUM_T):
            e_prev, e = e, 2 * e + e_prev + 2 * lr * ITERS_LATER
            bounds.append(e)
        tol[k] = bounds
    for t in range(NUM_T):
        for k in tout[t]:
            bound = tol[k][t] if k in tol else 2 * ITERS_FIRST * (
                tcfg.lrs.get(k, 0.0))
            np.testing.assert_allclose(tout[t][k], np.asarray(jout[t][k]),
                                       atol=bound + 1e-6, rtol=0,
                                       err_msg=f"t{t} {k}")
    # the stacked params.npz is the reference's layout
    tpath = texp.save_params(tout, str(tmp_path / "t"))
    jpath = jexp.save_params(
        [{k: np.asarray(v) for k, v in p.items()} for p in tout],
        str(tmp_path / "j"))
    a, b = texp.load_params(tpath), jexp.load_params(jpath)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = tout[0]["means3D"].shape[0]
    assert a["means3D"].shape == (NUM_T, n, 3)
    assert a["unnorm_rotations"].shape == (NUM_T, n, 4)
    assert a["log_scales"].shape == (n, 3) and a["cam_m"].shape == (5, 3)


def test_t1_train_step_matches(world3):
    """One t > 0 step from the same state in both packages."""
    ds, tds, pt, w2c = world3
    jcfg, tcfg = _cfgs()
    jp, jv, js = _post_t0_state_from(pt, w2c)
    jp, jv, js = jtr.initialize_per_timestep(jp, jv, js)
    # away from the first step's ties (rotations equal prev, offsets equal
    # prev_offset), so that rigid, rot and iso carry their edges
    rng = np.random.RandomState(13)
    jp = {k: (v + jnp.asarray(rng.normal(0, 0.01, v.shape), jnp.float32)
              if k in ("means3D", "unnorm_rotations", "rgb_colors") else v)
          for k, v in jp.items()}
    lrs = {k: float(jcfg.lrs.get(k, 0.0)) * (
        float(jv["scene_radius"]) if k == "means3D" else 1.0)
        * (0.0 if k in jcfg.freeze_after_t0 else 1.0) for k in jp}
    jstep = jtr.make_train_step(jcfg, jtr.raster_config(jcfg))
    jp2, _, _, jm = jstep(jp, js, jv, ds[1][2],
                          {k: jnp.float32(v) for k, v in lrs.items()},
                          is_initial=False)
    tstep = ttr.make_train_step(tcfg, ttr.raster_config(tcfg))
    tp2, ts2, _, tm = tstep(
        _t(jp), convert.adam_state_from_jax(_np(js.mu), _np(js.nu),
                                            js.step, "cpu"),
        convert.variables_from_jax(_np(jv), "cpu"), tds[1][2],
        {k: torch.tensor(v) for k, v in lrs.items()}, False)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    for k in PHYSICS:
        assert abs(float(tm[f"loss_{k}"]) - float(jm[f"loss_{k}"])) <= \
            1e-5 * abs(float(jm[f"loss_{k}"])) + 1e-7, k
    for k in ("rigid", "rot", "iso", "floor"):
        assert float(tm[f"loss_{k}"]) >= LIVE * 1e-7, k
    for k in jp2:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   atol=2 * lrs[k] + ATOL, rtol=0, err_msg=k)
    moved = np.abs(np.asarray(jp2["means3D"]) - np.asarray(jp["means3D"]))
    assert moved.max() > 0
    assert int(ts2.step) == int(js.step) + 1


def _post_t0_state_from(pt, w2c):
    jp, jv = JG.init_params(pt, w2c, capacity=1024)
    js = jopt.init(jp)
    return jtr.initialize_post_first_timestep(
        jp, jv, jconf.TrainConfig(num_knn=8, knn_weight_beta=KNN_BETA), js)


def test_cli_train_runs_every_timestep(tmp_path):
    """`cli train` with the default timesteps (3) on a 3-timestep layout."""
    scene = tsyn.make_gt_scene(n_fg=30, n_bg=60, seed=1)
    tsyn.write_reference_layout(str(tmp_path / "data"), "seq", num_t=3,
                                num_cams=3, w=48, h=32, f=40.0, scene=scene,
                                device="cpu")
    over = tmp_path / "cfg.json"
    over.write_text(json.dumps({"report_every": 2, "densify_start": 10 ** 9,
                                "num_knn": 8, "raster": {"chunk": 64}}))
    argv = ["train", "--data_root", str(tmp_path / "data"), "--seq", "seq",
            "--exp", "e", "--output", str(tmp_path / "out"),
            "--iters_first", "4", "--iters_per_t", "3", "--capacity", "512",
            "--config_json", str(over), "--device", "cpu", "--time_steps"]
    assert tconf.TrainConfig().num_timesteps == 3
    assert cli.main(argv) == 0
    run = tmp_path / "out" / "e" / "seq"
    stacked = texp.load_params(str(run / "params.npz"))
    for k, shape in (("means3D", (3, 90, 3)), ("rgb_colors", (3, 90, 3)),
                     ("unnorm_rotations", (3, 90, 4)),
                     ("log_scales", (90, 3)), ("cam_m", (5, 3))):
        assert stacked[k].shape == shape, k
        assert np.isfinite(stacked[k]).all(), k
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    for t, steps in ((0, [0, 2]), (1, [0, 2]), (2, [0, 2])):
        assert [r["step"] for r in rows if f"t{t}/loss" in r] == steps
        # --time_steps: every step but the first of each timestep
        timed = [r["step"] for r in rows if f"t{t}/time/step_ms" in r]
        assert timed == (list(range(1, 4)) if t == 0 else [1, 2]), t
    for r in rows:
        if "t1/loss" in r or "t2/loss" in r:
            t = 1 if "t1/loss" in r else 2
            assert all(np.isfinite(r[f"t{t}/loss_{k}"]) for k in PHYSICS)
    for t in range(3):
        assert (run / f"panel_t{t}_{t:07d}.png").exists()


def test_t_later_freezes_groups_and_skips_densify(world3):
    """Port only: after t = 0 the frozen groups do not move, no densify or
    opacity reset runs, and the table keeps its rows."""
    _, tds, pt, w2c = world3
    cfg = tconf.TrainConfig(
        num_timesteps=2, iters_first_timestep=3, iters_per_timestep=3,
        densify_start=0, densify_every=1, densify_end=10 ** 6,
        opacity_reset_every=1, capacity=1024, report_every=1, num_knn=8,
        raster=tconf.RasterSettings(chunk=64, max_tiles_per_gaussian=64,
                                    method="torch"))
    seen = {"densify": [], "t1": None}

    def on_timestep(t, params, variables):
        seen[f"t{t}"] = {k: v.clone() for k, v in params.items()}

    out, _, _ = ttr.train(tds[:2], cfg, pt, w2c, device="cpu", callbacks={
        "on_densify": lambda t, i, s: seen["densify"].append(t),
        "on_timestep": on_timestep})
    assert seen["densify"] and set(seen["densify"]) == {0}
    for k in cfg.freeze_after_t0:
        assert torch.equal(seen["t0"][k], seen["t1"][k]), k
    assert out[1]["means3D"].shape == out[0]["means3D"].shape
    assert not np.array_equal(out[1]["means3D"], out[0]["means3D"])
