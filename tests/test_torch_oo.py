"""Port parity: the OO stack (`models/gaussian_model.py`, `models/scene.py`).

The same numpy-seeded clouds through the reference's GaussianModel and the
port's: creation (the reference's `semantic_feature` draw carried across),
the lr schedule, Adam steps, densify with the reference's split noise
injected (including the reference-side fault that densify does not carry
the SH columns), the opacity reset, capture / restore across the packages
both ways, and a render from `render_args`; then Scene: PLY save and
reload, the PLY bytes, a COLMAP scene and a reference-layout scene.

Tolerances, each with its reason:
* creation: log scales atol 1e-5 (the 3-NN squared distances, see
  tests/test_torch_train.py); everything else is the same float32 formula,
  atol 1e-6;
* Adam and densify: atol 1e-6 on parameters (elementwise float32 of the
  same formula), moments and variables exact, as test_torch_train.py's
  test_densify_matches (which takes 1e-5 for its larger values);
* captures restore bitwise; the PLY bytes are equal;
* the render: the golden budget of tests/fixtures/TOLERANCES.md (rgb and
  alpha atol 3e-5) between the port's plain path and the reference's tiled
  path.
"""

import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.models import gaussian_model as JGM
from dynamic3dgaussians_tpu.models import scene as JS
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu_torch import convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.models import gaussian_model as TGM
from dynamic3dgaussians_tpu_torch.models import scene as TS
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from tests.scenes import lookat_camera

torch.set_num_threads(1)

ATOL = 1e-6
CAP = 128
CFG_KW = dict(chunk=64, max_per_tile=256, max_tiles_per_gaussian=64,
              pairs_per_gaussian=32)


def _cloud(n=80, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _models(sh_degree=2, semantic_dim=0, n=80):
    pts, cols = _cloud(n)
    j = JGM.GaussianModel(sh_degree, semantic_dim).create_from_pcd(
        pts, cols, spatial_lr_scale=2.0, capacity=CAP)
    sem = j.params.get("semantic_feature")
    t = TGM.GaussianModel(sh_degree, semantic_dim, device="cpu")
    t.create_from_pcd(pts, cols, spatial_lr_scale=2.0, capacity=CAP,
                      semantic_feature=None if sem is None
                      else np.asarray(sem)[:n])
    return j.training_setup(), t.training_setup()


def _close(t_tree, j_tree, atol=ATOL):
    assert set(t_tree) == set(j_tree)
    for k in j_tree:
        a = t_tree[k]
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(j_tree[k]), atol=atol,
                                   rtol=0, err_msg=k)


def _close_model(t, j, atol=ATOL):
    _close(t.params, j.params, atol)
    _close(t.variables, j.variables, 0)
    if j.opt_state is not None:
        _close(t.opt_state.mu, j.opt_state.mu, 0 if atol == 0 else 1e-7)
        _close(t.opt_state.nu, j.opt_state.nu, 0 if atol == 0 else 1e-9)
        assert int(t.opt_state.step) == int(j.opt_state.step)
    assert (t.active_sh_degree, t.step_count) == \
        (j.active_sh_degree, j.step_count)


# ------------------------------------------------------------ GaussianModel

@pytest.mark.parametrize("sh_degree,semantic_dim", [(1, 0), (3, 8)])
def test_create_from_pcd_matches(sh_degree, semantic_dim):
    j, t = _models(sh_degree, semantic_dim)
    assert t.get_features.shape == (CAP, (sh_degree + 1) ** 2, 3)
    for k in ("log_scales",):
        np.testing.assert_allclose(t.params[k].numpy(),
                                   np.asarray(j.params[k]), atol=1e-5,
                                   rtol=0)
    _close({k: v for k, v in t.params.items() if k != "log_scales"},
           {k: v for k, v in j.params.items() if k != "log_scales"})
    _close(t.variables, j.variables, 0)
    for prop in ("get_xyz", "get_opacity", "get_rotation", "get_features"):
        np.testing.assert_allclose(getattr(t, prop).numpy(),
                                   np.asarray(getattr(j, prop)), atol=ATOL,
                                   err_msg=prop)
    assert t.num_points == j.num_points == 80
    for _ in range(sh_degree + 2):
        t.oneupSHdegree()
        j.oneupSHdegree()
        assert t.active_sh_degree == j.active_sh_degree
    assert t.active_sh_degree == sh_degree


def test_expon_lr_matches():
    for step in (0, 1, 50, 99, 100, 250):
        for delay in (0, 20):
            kw = dict(lr_delay_steps=delay, lr_delay_mult=0.1,
                      max_steps=100)
            assert TGM.expon_lr(step, 1e-2, 1e-4, **kw) == \
                JGM.expon_lr(step, 1e-2, 1e-4, **kw)


def _set(j, t, key, fn):
    """The same edit of one parameter table in both models."""
    v = fn(np.asarray(j.params[key]).copy())
    j.params[key] = jnp.asarray(v)
    t.params[key] = torch.as_tensor(v)


def test_steps_match():
    j, t = _models(sh_degree=2, semantic_dim=4)
    rng = np.random.RandomState(3)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
             for k, v in j.params.items()}
        j.step({k: jnp.asarray(v) for k, v in g.items()})
        t.step({k: torch.as_tensor(v) for k, v in g.items()})
    _close_model(t, j)
    # dead slots did not move
    assert float(t.params["means3D"][80:].abs().max()) == 0.0


def _densify_models():
    """Models with stale values in dead slots (as a prune leaves them), SH
    of every degree set, hot gradients on both clone- and split-sized rows,
    and a few rows below the prune opacity."""
    j, t = _models(sh_degree=2, semantic_dim=4)
    rng = np.random.RandomState(5)
    stale = np.zeros(CAP, bool)
    stale[80:90] = True

    def with_stale(v):
        v[stale] = rng.normal(size=v[stale].shape).astype(np.float32)
        v[:80] += 0.3 * rng.normal(size=v[:80].shape).astype(np.float32)
        return v

    for k in ("features_dc", "features_rest"):
        _set(j, t, k, with_stale)
    _set(j, t, "log_scales",
         lambda v: np.where(np.arange(CAP)[:, None] % 3 == 0,
                            np.log(0.01), v).astype(np.float32))
    _set(j, t, "logit_opacities",
         lambda v: np.where(np.arange(CAP)[:, None] % 11 == 5, -8.0,
                            v).astype(np.float32))
    hot = (np.arange(CAP) < 80) & (np.arange(CAP) % 2 == 0)
    acc = np.where(hot, 1.0, 1e-6).astype(np.float32)
    for m in (j, t):
        m.variables["means2D_gradient_accum"] = type(
            m.variables["denom"])(acc) if isinstance(
            m.variables["denom"], torch.Tensor) else jnp.asarray(acc)
        m.variables["denom"] = (torch.ones(CAP) if isinstance(
            m.variables["denom"], torch.Tensor) else jnp.ones(CAP))
    return j, t


def _jax_split_noise(model):
    """The draws the reference's densify_and_prune takes from its key."""
    _, sub = jax.random.split(model._key)
    k1, k2 = jax.random.split(sub)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, (CAP, 3))))
                 for k in (k1, k2))


def test_densify_and_prune_matches_and_keeps_stale_sh():
    """Clones, splits and prunes with the reference's split noise; a clone
    lands in a dead slot and keeps that slot's stale SH (features_dc and
    features_rest are not among GAUSSIAN_KEYS, ROADMAP.md §3), in both
    packages alike."""
    j, t = _densify_models()
    before = {k: np.asarray(v).copy() for k, v in j.params.items()}
    alive0 = np.asarray(j.variables["alive"]).copy()
    noise = _jax_split_noise(j)
    js = j.densify_and_prune(600)
    ts = t.densify_and_prune(600, noise=noise)
    for name in js._fields:
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    assert int(js.n_cloned) > 0 and int(js.n_split) > 0
    assert int(js.n_pruned) > 0
    _close_model(t, j, atol=1e-5)

    # the clones' destinations: dead slots before, alive now (clones come
    # first in the free slots, in parent order)
    born = np.flatnonzero(~alive0 & np.asarray(j.variables["alive"]))
    clone_dst = born[:int(js.n_cloned)]
    # the first free slots hold stale values, the later ones pad zeros
    assert clone_dst.size > 10 and set(clone_dst[:10]) == set(range(80, 90))
    fdc = t.params["features_dc"].numpy()
    np.testing.assert_array_equal(fdc[clone_dst],
                                  np.asarray(j.params["features_dc"])[
                                      clone_dst])
    # the stale (or zero) values stayed, though the clone copied its
    # parent's means
    np.testing.assert_array_equal(fdc[clone_dst],
                                  before["features_dc"][clone_dst])
    parents = np.flatnonzero(alive0 & (np.arange(CAP) % 2 == 0)
                             & (np.arange(CAP) % 3 == 0))
    np.testing.assert_array_equal(
        t.params["means3D"].numpy()[clone_dst[0]],
        before["means3D"][parents[0]])
    assert np.abs(fdc[clone_dst[0]] - before["features_dc"][parents[0]]
                  ).max() > 0

    j.reset_opacity()
    t.reset_opacity()
    _close_model(t, j, atol=1e-5)
    np.testing.assert_allclose(t.get_opacity.numpy(), 0.01, atol=1e-6)


def test_densify_from_generator_runs():
    """Without injected noise the split draws come from the model's
    generator: same counts as the reference (the noise moves only the
    children's means)."""
    j, t = _densify_models()
    js = j.densify_and_prune(600)
    ts = t.densify_and_prune(600)
    for name in js._fields:
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    assert torch.isfinite(t.params["means3D"]).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_capture_restore_across_packages(direction):
    j, t = _models(sh_degree=2, semantic_dim=4)
    g = {k: np.full(v.shape, 1e-3, np.float32) for k, v in j.params.items()}
    j.step({k: jnp.asarray(v) for k, v in g.items()})
    t.step({k: torch.as_tensor(v) for k, v in g.items()})
    j.oneupSHdegree()
    t.oneupSHdegree()
    if direction == "jax_to_port":
        t2 = convert.gaussian_model_from_jax(j.capture(), device="cpu")
        assert (t2.max_sh_degree, t2.semantic_dim) == (2, 4)
        _close_model(t2, j, atol=0)
        t2.training_setup()
        t2.restore(j.capture())            # restore() takes it unchanged
        _close_model(t2, j, atol=0)
    else:
        j2 = JGM.GaussianModel(2, 4).restore(t.capture())
        _close_model(t, j2, atol=0)
        state = t.capture()
        assert all(isinstance(v, np.ndarray)
                   for part in ("params", "variables", "opt_mu", "opt_nu")
                   for v in state[part].values())


def test_render_args_match():
    j, t = _models(sh_degree=2, semantic_dim=4)
    _set(j, t, "features_rest",
         lambda v: (0.2 * np.random.RandomState(1).normal(size=v.shape))
         .astype(np.float32))
    j.oneupSHdegree()
    t.oneupSHdegree()
    jcam, k, w2c = lookat_camera()
    tcam_ = tcam.make_camera(64, 48, k, w2c, device="cpu")
    jo = jrast.render(jcam, **j.render_args(),
                      config=jrast.RasterConfig(**CFG_KW))
    to = trast.render(tcam_, **t.render_args(),
                      config=trast.RasterConfig(
                          chunk=64, max_tiles_per_gaussian=64),
                      device="cpu")
    assert int(jo.n_dropped_rect) == 0 and int(jo.n_dropped_capacity) == 0
    for name in ("rgb", "alpha", "extra"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)), atol=3e-5,
                                   rtol=0, err_msg=name)
    assert float(to.alpha.max()) > 0.1


# ------------------------------------------------------------------ Scene

def _cloud6(n=50):
    rng = np.random.RandomState(0)
    return np.concatenate([rng.uniform(-1, 1, (n, 3)), rng.rand(n, 3)],
                          1).astype(np.float32)


def test_scene_save_reload_and_ply_bytes(tmp_path):
    cloud = _cloud6()
    jg = JGM.GaussianModel(sh_degree=2)
    tg = TGM.GaussianModel(sh_degree=2, device="cpu")
    js = JS.Scene(jg, model_path=str(tmp_path / "j"), point_cloud=cloud,
                  capacity=128)
    ts = TS.Scene(tg, model_path=str(tmp_path / "t"), point_cloud=cloud,
                  capacity=128)
    assert tg.num_points == jg.num_points == 50
    np.testing.assert_allclose(tg.params["log_scales"].numpy(),
                               np.asarray(jg.params["log_scales"]), atol=1e-5)
    # the same tables on both sides (the 3-NN scales differ by rounding),
    # so that the writers are compared byte for byte
    jg.params["logit_opacities"] = jg.params["logit_opacities"] + 0.25
    tg.restore(jg.capture())
    jd, td = js.save(100), ts.save(100)
    ts.save(7)
    with open(os.path.join(jd, "point_cloud.ply"), "rb") as a, \
            open(os.path.join(td, "point_cloud.ply"), "rb") as b:
        assert a.read() == b.read()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tg2 = TGM.GaussianModel(sh_degree=2, device="cpu")
        tg2.active_sh_degree = 2
        ts2 = TS.Scene(tg2, model_path=str(tmp_path / "t"),
                       load_iteration=-1)
        jg2 = JGM.GaussianModel(sh_degree=2)
        JS.Scene(jg2, model_path=str(tmp_path / "j"), load_iteration=-1)
    assert any("only DC SH" in str(w.message) for w in caught)
    assert ts2.loaded_iter == 100 and tg2.num_points == 50
    assert tg2.active_sh_degree == 0
    # reference-side: padded to round_capacity(n) only (ROADMAP.md §3)
    assert tg2.params["means3D"].shape[0] == 1024
    _close(tg2.params, jg2.params, 0)
    _close(tg2.variables, jg2.variables, 0)
    np.testing.assert_allclose(tg2.params["means3D"][:50].numpy(),
                               cloud[:, :3], atol=1e-6)


def _write_colmap(root):
    d = os.path.join(root, "sparse", "0")
    os.makedirs(d)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))
        f.write(struct.pack("<dddd", 50.0, 50.0, 32.0, 24.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            q = np.array([np.cos(0.1 * i), 0.0, np.sin(0.1 * i), 0.0])
            f.write(struct.pack("<idddddddi", i + 1, *q, 0.1 * i, 0, 3.0, 1))
            f.write(f"im{i}.jpg\x00".encode())
            f.write(struct.pack("<Q", 0))
    rng = np.random.RandomState(2)
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 60))
        for i in range(60):
            f.write(struct.pack("<QdddBBBd", i + 1,
                                *rng.uniform(-0.5, 0.5, 3),
                                *rng.randint(0, 256, 3), 0.5))
            f.write(struct.pack("<Q", 0))


def test_scene_from_colmap_matches(tmp_path):
    _write_colmap(str(tmp_path))
    jg = JGM.GaussianModel(sh_degree=1)
    tg = TGM.GaussianModel(sh_degree=1, device="cpu")
    js = JS.scene_from_colmap(str(tmp_path), jg,
                              model_path=str(tmp_path / "j"), capacity=128)
    ts = TS.scene_from_colmap(str(tmp_path), tg,
                              model_path=str(tmp_path / "t"), capacity=128)
    jf, tf = js.getTrainCameras(), ts.getTrainCameras()
    assert [f["name"] for f in tf] == [f["name"] for f in jf]
    assert all("im" not in f for f in tf)     # the caller attaches images
    for a, b in zip(tf, jf):
        for attr in ("w2c", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(a["camera"], attr).numpy(),
                                       np.asarray(getattr(b["camera"], attr)),
                                       atol=1e-6, err_msg=attr)
    assert tg.spatial_lr_scale == jg.spatial_lr_scale
    np.testing.assert_allclose(tg.params["log_scales"].numpy(),
                               np.asarray(jg.params["log_scales"]),
                               atol=1e-5)
    _close({k: v for k, v in tg.params.items() if k != "log_scales"},
           {k: v for k, v in jg.params.items() if k != "log_scales"})
    assert tg.num_points == 60


def test_scene_from_reference_dataset_matches(tmp_path):
    scene = tsyn.make_gt_scene(n_fg=20, n_bg=40, seed=3)
    tsyn.write_reference_layout(str(tmp_path), "seq", num_t=1, num_cams=3,
                                w=48, h=32, f=40.0, scene=scene,
                                device="cpu")
    jg = JGM.GaussianModel(sh_degree=0)
    tg = TGM.GaussianModel(sh_degree=0, device="cpu")
    js = JS.scene_from_reference_dataset(str(tmp_path), "seq", jg,
                                         model_path=str(tmp_path / "j"))
    ts = TS.scene_from_reference_dataset(str(tmp_path), "seq", tg,
                                         model_path=str(tmp_path / "t"))
    assert len(ts.getTrainCameras()) == len(js.getTrainCameras()) == 3
    for a, b in zip(ts.getTrainCameras(), js.getTrainCameras()):
        np.testing.assert_array_equal(a["im"].numpy(), np.asarray(b["im"]))
    assert abs(tg.spatial_lr_scale - jg.spatial_lr_scale) <= \
        1e-6 * jg.spatial_lr_scale
    assert ts._nerfpp_radius() == pytest.approx(js._nerfpp_radius(),
                                                rel=1e-6)
    assert tg.num_points == jg.num_points == 60
    np.testing.assert_allclose(tg.params["means3D"].numpy(),
                               np.asarray(jg.params["means3D"]), atol=0)


def test_scene_save_after_prune_writes_the_first_rows(tmp_path):
    """Reference-side, reproduced (ROADMAP.md §3): `save` writes table rows
    [0, num_points), not the alive rows, so after a prune it writes dead
    rows and leaves out the clones past num_points; both packages write
    the same rows (within the densify tolerance, its split means)."""
    cloud = np.concatenate([_cloud()[0], _cloud()[1]], 1)
    jg = JGM.GaussianModel(sh_degree=2)
    tg = TGM.GaussianModel(sh_degree=2, device="cpu")
    js = JS.Scene(jg, model_path=str(tmp_path / "j"), point_cloud=cloud,
                  spatial_lr_scale=2.0, capacity=CAP)
    ts = TS.Scene(tg, model_path=str(tmp_path / "t"), point_cloud=cloud,
                  spatial_lr_scale=2.0, capacity=CAP)
    jg.training_setup()
    tg.restore(jg.capture())
    _set(jg, tg, "logit_opacities",
         lambda v: np.where(np.arange(CAP)[:, None] % 7 == 3, -8.0,
                            v).astype(np.float32))
    hot = np.where(np.arange(CAP) % 4 == 0, 1.0, 0.0).astype(np.float32)
    jg.variables["means2D_gradient_accum"] = jnp.asarray(hot)
    jg.variables["denom"] = jnp.ones(CAP)
    tg.variables["means2D_gradient_accum"] = torch.as_tensor(hot)
    tg.variables["denom"] = torch.ones(CAP)
    noise = _jax_split_noise(jg)
    jst = jg.densify_and_prune(600)
    tg.densify_and_prune(600, noise=noise)
    assert int(jst.n_pruned) > 0 and int(jst.n_cloned) + int(jst.n_split) > 0
    n = tg.num_points
    alive = tg.alive.numpy()
    assert not alive[:n].all() and alive[n:].any()
    jd, td = js.save(1), ts.save(1)
    from dynamic3dgaussians_tpu_torch import native
    tp = native.ply_read(os.path.join(td, "point_cloud.ply"))
    jp = native.ply_read(os.path.join(jd, "point_cloud.ply"))
    np.testing.assert_array_equal(tp["means3D"],
                                  tg.params["means3D"][:n].numpy())
    for k in tp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5, err_msg=k)
