"""Port parity: `parallel/` on torch.distributed against the JAX package's
`shard_map` versions.

Four ranks on gloo (spawned once for the file by a module fixture, which
runs every case in every rank and returns what each rank computed) stand
for the JAX side's 4-device slice of the conftest's 8 CPU devices. The
cases, each its own test over the fixture's results:

* camera DP, one step in each reduce mode, against JAX's
  `make_dp_train_step` at the sizes of `tests/test_parallel.py` (8
  cameras of 48x32, two per rank; capacity 256; both packages with
  `max_cams=8`, since JAX silently clamps camera ids past the table),
  psum_scatter against pmean, and a psum_scatter step from JAX's state
  after one step, carried across by `convert.py`; 5 DP steps finite and
  decreasing;
* the tile-stripe render (64x64, 4 tile rows) and the depth-slab render
  (48x32), forward and gradients, against JAX's sharded renders;
* world size 1 (a one-rank group per rank) of each entry point against the
  port's single-process path;
* the collectives' gradients, replicated-input gradients equal on every
  rank to the single-device ones (not K times them), and the sharded Adam
  state's round trip;
* the divisibility errors, and `mesh.spawn`'s failure and time limit.

Tolerances are the JAX tests' own (`tests/test_parallel.py`): DP loss rtol
1e-5, parameters atol 1e-5 / rtol 1e-4, `means2D_gradient_accum` atol
1e-5; renders rgb and alpha atol 2e-4, depth atol 1e-3 / rtol 1e-4;
gradients atol 5e-4 / rtol 1e-3. The JAX side renders with its CPU paths
("tiled" and the Pallas kernels in interpret mode), the port with the
kernels' plain versions; the sums differ in order only.

The ranks import no JAX: this module imports it inside the tests alone.
"""

import traceback

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.parallel import mesh

WORLD = 4
LR = 0.01
DP_SCENE = dict(n_fg=40, n_bg=80, seed=0)
DP_W, DP_H, DP_F, DP_CAMS, DP_CAP = 48, 32, 40.0, 8, 256
DP_RASTER = dict(chunk=64, max_per_tile=512, max_tiles_per_gaussian=64,
                 pairs_per_gaussian=16)
SHARD_RASTER = dict(tile_h=16, tile_w=16, chunk=64, max_tiles_per_gaussian=32,
                    max_per_tile=512, pairs_per_gaussian=32)
# (w, h, f, gaussians, scene seed, bg) of the JAX tests' renders
TILE_FWD = (64, 64, 50.0, 100, 9, (0.05, 0.1, 0.15))
TILE_GRAD = (64, 64, 50.0, 80, 13, None)
DEPTH_FWD = (48, 32, 40.0, 120, 7, (0.1, 0.2, 0.3))
DEPTH_GRAD = (48, 32, 40.0, 96, 11, None)
GRAD_NAMES = ("means", "colors", "opac")


def random_scene(n, seed):
    """`tests/scenes.py::random_scene` (that module imports JAX)."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (n, 3))
    colors = rng.uniform(0, 1, (n, 3))
    opac = rng.uniform(0.2, 0.95, (n,))
    scales = rng.uniform(0.02, 0.12, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return tuple(a.astype(np.float32) for a in
                 (means, colors, opac, scales, quats))


def lookat(w, h, f):
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    return [[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], w2c


def cotangent(case):
    w, h = case[0], case[1]
    seed = 1 if case == TILE_GRAD else 0
    return np.random.RandomState(seed).normal(size=(h, w, 3)).astype(
        np.float32)


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


# ------------------------------------------------------------------ ranks

def dp_frames():
    """The DP scene's 8 datapoints rendered by the port, as host arrays:
    the images and cameras both packages train on."""
    from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
    scene = tsyn.make_gt_scene(**DP_SCENE)
    ds, _, _ = tsyn.make_dataset(scene, num_t=1, num_cams=DP_CAMS, w=DP_W,
                                 h=DP_H, f=DP_F, device="cpu")
    return [{"im": fr["im"].numpy(), "seg": fr["seg"].numpy(),
             "w2c": fr["camera"].w2c.numpy(), "cam_id": fr["cam_id"]}
            for fr in ds[0]]


def dp_point_cloud():
    from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
    return tsyn.init_point_cloud(tsyn.make_gt_scene(**DP_SCENE), noise=0.05)


def _dp_world(frames_np, capacity=DP_CAP):
    """The port's datapoints, parameters and variables of the DP scene."""
    from dynamic3dgaussians_tpu_torch.models import gaussians as TG
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    k = [[DP_F, 0, DP_W / 2], [0, DP_F, DP_H / 2], [0, 0, 1]]
    frames = [{"camera": make_camera(DP_W, DP_H, k, fr["w2c"], device="cpu"),
               "im": torch.tensor(fr["im"]), "seg": torch.tensor(fr["seg"]),
               "cam_id": fr["cam_id"]} for fr in frames_np]
    w2c = np.stack([fr["w2c"] for fr in frames_np])
    params, variables = TG.init_params(dp_point_cloud(), w2c,
                                       capacity=capacity, max_cams=DP_CAMS,
                                       device="cpu")
    return frames, params, variables


def _dp_cfg():
    from dynamic3dgaussians_tpu_torch.train import config as tconf
    from dynamic3dgaussians_tpu_torch.train import trainer as ttr
    cfg = tconf.TrainConfig(raster=tconf.RasterSettings(**DP_RASTER),
                            capacity=DP_CAP)
    return cfg, ttr.raster_config(cfg)


def _dp_out(params, opt, variables, metrics):
    return {"params": _np(params), "mu": _np(opt.mu),
            "step": int(opt.step), "accum": variables[
                "means2D_gradient_accum"].numpy(),
            "loss": float(metrics["loss"]), "psnr": float(metrics["psnr"]),
            "n_dropped": int(metrics["n_dropped"])}


def case_dp(data, group, reduce, lr=LR, steps=1):
    from dynamic3dgaussians_tpu_torch.parallel import camera_dp
    from dynamic3dgaussians_tpu_torch.train import optim
    frames, params, variables = _dp_world(data["frames"])
    cfg, rcfg = _dp_cfg()
    step = camera_dp.make_dp_train_step(cfg, rcfg, group, reduce=reduce,
                                        device="cpu")
    opt = optim.init(params)
    if reduce == "psum_scatter":
        opt = camera_dp.shard_adam_state(opt, group)
    lrs = {k: torch.tensor(lr) for k in params}
    losses = []
    for _ in range(steps):
        params, opt, variables, m = step(params, opt, variables,
                                         camera_dp.collate(frames), lrs, True)
        losses.append(float(m["loss"]))
    if reduce == "psum_scatter":
        opt = camera_dp.gather_adam_state(opt, group)
    return dict(_dp_out(params, opt, variables, m), losses=losses)


def case_dp_single(data):
    """The port's single-process step on the same 8 cameras."""
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train import trainer as ttr
    frames, params, variables = _dp_world(data["frames"])
    cfg, rcfg = _dp_cfg()
    lrs = {k: torch.tensor(LR) for k in params}
    out = ttr.make_train_step(cfg, rcfg)(params, optim.init(params),
                                         variables, list(frames), lrs, True)
    return _dp_out(*out)


def _shard_args(case, grad):
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    w, h, f, n, seed, _ = case
    k, w2c = lookat(w, h, f)
    cam = make_camera(w, h, k, w2c, device="cpu")
    args = [torch.tensor(a) for a in random_scene(n, seed)]
    if grad:
        for a in args[:3]:
            a.requires_grad_(True)
    return cam, args


def _shard_result(case, out, args):
    """The image, and with a gradient case the gradients of the JAX tests'
    loss w.r.t. means, colours and opacity."""
    res = {k: v.detach().numpy() for k, v in out.items()}
    if args[0].requires_grad:
        ct = torch.tensor(cotangent(case))
        loss = torch.sum(out["rgb"] * ct)
        if case == DEPTH_GRAD:
            loss = loss + 0.1 * torch.sum(out["depth"])
        res["grads"] = [g.numpy() for g in
                        torch.autograd.grad(loss, args[:3])]
    return res


def _config():
    from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
    return RasterConfig(**SHARD_RASTER)


def case_tile(group, case):
    from dynamic3dgaussians_tpu_torch.parallel.tile_shard import \
        make_tile_sharded_render
    cam, args = _shard_args(case, case == TILE_GRAD)
    fn = make_tile_sharded_render(cam, group, config=_config(), device="cpu")
    bg = None if case[5] is None else torch.tensor(case[5])
    return _shard_result(case, fn(*args, bg=bg), args)


def case_depth(group, case):
    from dynamic3dgaussians_tpu_torch.parallel.gaussian_shard import \
        make_depth_sharded_render
    cam, args = _shard_args(case, case == DEPTH_GRAD)
    fn = make_depth_sharded_render(cam, group, config=_config(),
                                   method="torch", device="cpu")
    bg = None if case[5] is None else torch.tensor(case[5])
    return _shard_result(case, fn(*args, bg=bg), args)


def case_single_render(case):
    """The port's single-process render of a shard case."""
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    cam, args = _shard_args(case, case[5] is None)
    out = render(cam, *args, config=_config(), bg=case[5], method="torch",
                 device="cpu")
    return _shard_result(case, {"rgb": out.rgb, "depth": out.depth,
                                "alpha": out.alpha}, args)


def case_collectives(group):
    """Each collective's forward and the gradient of a replicated input
    through it, for a loss every rank computes whole."""
    from dynamic3dgaussians_tpu_torch.parallel import collectives as C
    k, r = C.axis_size(group), C.axis_index(group)
    x = torch.arange(8 * k, dtype=torch.float32).reshape(2 * k, 4) + r
    res = {"impl": C.implementation(group), "rank": r, "size": k,
           "psum": C.psum(x, group).numpy(),
           "pmean": C.pmean(x, group).numpy(),
           "pmax": C.pmax(x.to(torch.int32), group).numpy(),
           "all_gather": C.all_gather(x, group).numpy(),
           "psum_scatter": C.psum_scatter(x, group).numpy()}
    # y = 3 * (rank's rows of x) ** 2, gathered whole: dL/dx = 6 x for
    # L = sum(y), the single-device gradient
    xr = torch.linspace(-1, 1, 8 * k).reshape(2 * k, 4).requires_grad_(True)
    mine = C.enter_replicated(xr, group)[2 * r:2 * r + 2]
    y = C.exit_replicated(C.all_gather(3 * mine ** 2, group), group)
    (res["grad_gather"],) = torch.autograd.grad(y.sum(), xr)
    # z = psum over ranks of (rank's share x / K): z = x whole, dL/dx = 1
    z = C.exit_replicated(C.psum(C.enter_replicated(xr, group) / k, group),
                          group)
    (res["grad_psum"],) = torch.autograd.grad(z.sum(), xr)
    # psum_scatter's backward is all_gather: d sum(rows) / dx = 1
    (res["grad_scatter"],) = torch.autograd.grad(
        C.psum_scatter(xr * 2, group).sum(), xr)
    res = {k_: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k_, v in res.items()}
    return res


def case_dp_from_jax_state(data, group):
    """A psum_scatter step from JAX's state after one pmean step, carried
    across by `convert.py` and sharded by `shard_adam_state`: Adam's
    moments are no longer zero, so the step depends on their scale."""
    from dynamic3dgaussians_tpu_torch import convert
    from dynamic3dgaussians_tpu_torch.parallel import camera_dp
    frames, _, _ = _dp_world(data["frames"])
    js = data["jax_state"]
    params = convert.params_from_jax(js["params"], "cpu")
    variables = convert.variables_from_jax(js["variables"], "cpu")
    opt = camera_dp.shard_adam_state(convert.adam_state_from_jax(
        js["mu"], js["nu"], js["step"], "cpu"), group)
    cfg, rcfg = _dp_cfg()
    step = camera_dp.make_dp_train_step(cfg, rcfg, group,
                                        reduce="psum_scatter", device="cpu")
    lrs = {k: torch.tensor(LR) for k in params}
    params, opt, variables, m = step(params, opt, variables, frames, lrs,
                                     True)
    return _dp_out(params, camera_dp.gather_adam_state(opt, group),
                   variables, m)


def case_adam_roundtrip(data, group):
    from dynamic3dgaussians_tpu_torch.parallel import camera_dp
    from dynamic3dgaussians_tpu_torch.train import optim
    _, params, _ = _dp_world(data["frames"])
    rng = np.random.RandomState(3)
    state = optim.AdamState(
        mu={k: torch.tensor(rng.normal(size=v.shape).astype(np.float32))
            for k, v in params.items()},
        nu={k: torch.tensor(rng.uniform(size=v.shape).astype(np.float32))
            for k, v in params.items()},
        step=torch.tensor(7, dtype=torch.int32))
    shard = camera_dp.shard_adam_state(state, group)
    back = camera_dp.gather_adam_state(shard, group)
    same = all(torch.equal(getattr(back, f)[k], getattr(state, f)[k])
               for f in ("mu", "nu") for k in params)
    return {"same": same and int(back.step) == 7,
            "shard_rows": int(shard.mu["means3D"].shape[0])}


def case_errors(data, group):
    """The divisibility errors, raised before any collective."""
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.parallel import camera_dp
    from dynamic3dgaussians_tpu_torch.parallel.tile_shard import \
        make_tile_sharded_render
    from dynamic3dgaussians_tpu_torch.train import optim
    frames, params, variables = _dp_world(data["frames"])
    _, p250, v250 = _dp_world(data["frames"], capacity=250)
    cfg, rcfg = _dp_cfg()
    lrs = {k: torch.tensor(LR) for k in params}
    msgs = {}

    def catch(name, call):
        try:
            call()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)

    step = camera_dp.make_dp_train_step(cfg, rcfg, group, device="cpu")
    catch("batch", lambda: step(params, optim.init(params), variables,
                                list(frames[:6]), lrs, True))
    step_ps = camera_dp.make_dp_train_step(cfg, rcfg, group,
                                           reduce="psum_scatter",
                                           device="cpu")
    catch("capacity", lambda: step_ps(p250, optim.init(p250), v250,
                                      list(frames), lrs, True))
    k, w2c = lookat(64, 48, 50.0)
    cam = make_camera(64, 48, k, w2c, device="cpu")
    catch("tile_rows", lambda: make_tile_sharded_render(
        cam, group, config=_config(), device="cpu"))
    return msgs


def _rank_main(rank, world_size, data):
    """Every case in this rank: on the world group and on a one-rank group
    of its own. A failing case records its traceback and the rest go on."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    solo = [dist.new_group([r]) for r in range(world_size)][rank]
    cases = {
        "dp_pmean": lambda: case_dp(data, None, "pmean"),
        "dp_psum_scatter": lambda: case_dp(data, None, "psum_scatter"),
        "dp_5_steps": lambda: case_dp(data, None, "pmean", lr=0.005,
                                      steps=5),
        "dp_from_jax_state": lambda: case_dp_from_jax_state(data, None),
        "tile_fwd": lambda: case_tile(None, TILE_FWD),
        "tile_grad": lambda: case_tile(None, TILE_GRAD),
        "depth_fwd": lambda: case_depth(None, DEPTH_FWD),
        "depth_grad": lambda: case_depth(None, DEPTH_GRAD),
        "collectives": lambda: case_collectives(None),
        "adam_roundtrip": lambda: case_adam_roundtrip(data, None),
        "errors": lambda: case_errors(data, None),
        "w1_dp_pmean": lambda: case_dp(data, solo, "pmean"),
        "w1_dp_psum_scatter": lambda: case_dp(data, solo, "psum_scatter"),
        "w1_tile_grad": lambda: case_tile(solo, TILE_GRAD),
        "w1_depth_grad": lambda: case_depth(solo, DEPTH_GRAD),
        "w1_collectives": lambda: case_collectives(solo),
    }
    if rank == 0:   # single-process references, computed once
        cases.update({
            "single_dp": lambda: case_dp_single(data),
            "single_tile_fwd": lambda: case_single_render(TILE_FWD),
            "single_tile_grad": lambda: case_single_render(TILE_GRAD),
            "single_depth_grad": lambda: case_single_render(DEPTH_GRAD)})
    out = {}
    for name, run in cases.items():
        try:
            out[name] = run()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


# ------------------------------------------------------------------ tests

def _jax_world(frames):
    """JAX's DP world on the same images and cameras."""
    import jax.numpy as jnp
    from dynamic3dgaussians_tpu.models import gaussians as JG
    from dynamic3dgaussians_tpu.ops import camera as jcam
    k = [[DP_F, 0, DP_W / 2], [0, DP_F, DP_H / 2], [0, 0, 1]]
    batch = [{"camera": jcam.make_camera(DP_W, DP_H, k, fr["w2c"].astype(
                  np.float64), near=0.01, far=100.0),
              "im": jnp.asarray(fr["im"]), "seg": jnp.asarray(fr["seg"]),
              "cam_id": jnp.int32(fr["cam_id"])} for fr in frames]
    w2c = np.stack([fr["w2c"] for fr in frames])
    params, variables = JG.init_params(dp_point_cloud(), w2c,
                                       capacity=DP_CAP, max_cams=DP_CAMS)
    return batch, params, variables


def _jax_dp_step(world, reduce, lr=LR):
    """One JAX DP step on 4 of the CPU devices from `world`'s state."""
    import jax
    import jax.numpy as jnp
    from dynamic3dgaussians_tpu.parallel.camera_dp import (collate,
                                                           make_dp_train_step)
    from dynamic3dgaussians_tpu.parallel.mesh import make_mesh
    from dynamic3dgaussians_tpu.train import optim
    from dynamic3dgaussians_tpu.train.config import (RasterSettings,
                                                     TrainConfig)
    from dynamic3dgaussians_tpu.train.trainer import raster_config
    batch, params, variables = world[:3]
    opt = world[3] if len(world) > 3 else optim.init(params)
    cfg = TrainConfig(raster=RasterSettings(**DP_RASTER), capacity=DP_CAP)
    mesh_ = make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    step = make_dp_train_step(cfg, raster_config(cfg), mesh_, reduce=reduce)
    lrs = {k: jnp.float32(lr) for k in params}
    return step(params, opt, variables, collate(batch), lrs, True)


@pytest.fixture(scope="module")
def world():
    """The DP images (rendered once, here, by the port), JAX's world on
    them, and JAX's state after one pmean DP step."""
    frames = dp_frames()
    jworld = _jax_world(frames)
    after = _jax_dp_step(jworld, "pmean")
    p, o, v, _ = after
    state = {"params": _np_tree(p), "variables": _np_tree(v),
             "mu": _np_tree(o.mu), "nu": _np_tree(o.nu),
             "step": np.asarray(o.step)}
    return frames, jworld, after, state


@pytest.fixture(scope="module")
def ranks(world):
    frames, _, _, state = world
    return mesh.spawn(_rank_main, WORLD, "gloo", timeout_s=120.0,
                      args=({"frames": frames, "jax_state": state},))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _get(ranks, name, rank=None):
    outs = [r[name] for r in ranks] if rank is None else [ranks[rank][name]]
    for o in outs:
        if isinstance(o, dict) and "error" in o:
            pytest.fail(o["error"])
    return outs if rank is None else outs[0]


def _close_dp(got, want_params, want_accum, want_loss):
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    for k, v in want_params.items():
        np.testing.assert_allclose(got["params"][k], np.asarray(v),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["accum"], np.asarray(want_accum),
                               atol=1e-5)


@pytest.mark.parametrize("reduce", ["pmean", "psum_scatter"])
def test_dp_step_matches_jax(ranks, world, reduce):
    p, o, v, m = world[2] if reduce == "pmean" else \
        _jax_dp_step(world[1], reduce)
    for got in _get(ranks, f"dp_{reduce}"):
        _close_dp(got, p, v["means2D_gradient_accum"], float(m["loss"]))
        assert got["step"] == int(o.step) == 1
        assert got["n_dropped"] == int(m["n_dropped"])
        np.testing.assert_allclose(got["psnr"], float(m["psnr"]), rtol=1e-5)


def test_dp_from_jax_state_matches_jax(ranks, world):
    """JAX's pmean step, then a psum_scatter step in each package from
    JAX's state: the sharded Adam state carried across by convert.py."""
    p1, o1, v1, _ = world[2]
    p, o, v, m = _jax_dp_step(world[1][:1] + (p1, v1, o1), "psum_scatter")
    assert int(o.step) == 2
    for got in _get(ranks, "dp_from_jax_state"):
        _close_dp(got, p, v["means2D_gradient_accum"], float(m["loss"]))
        assert got["step"] == 2
        for k in got["mu"]:
            np.testing.assert_allclose(got["mu"][k], np.asarray(o.mu[k]),
                                       atol=2e-5, rtol=1e-4, err_msg=k)


def test_dp_psum_scatter_matches_pmean(ranks):
    for a, b in zip(_get(ranks, "dp_pmean"), _get(ranks, "dp_psum_scatter")):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for k in a["params"]:
            np.testing.assert_allclose(b["params"][k], a["params"][k],
                                       atol=2e-5, rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(b["mu"][k], a["mu"][k], atol=2e-5,
                                       rtol=1e-4, err_msg=k)
        assert a["step"] == b["step"] == 1


def test_dp_five_steps_finite_and_decreasing(ranks):
    runs = _get(ranks, "dp_5_steps")
    for run in runs:
        assert np.isfinite(run["losses"]).all()
        assert run["losses"][-1] < run["losses"][0]
        assert run["losses"] == runs[0]["losses"]


@pytest.mark.parametrize("reduce", ["pmean", "psum_scatter"])
def test_dp_world_size_one_matches_single_process(ranks, reduce):
    single = _get(ranks, "single_dp", 0)
    for got in _get(ranks, f"w1_dp_{reduce}"):
        _close_dp(got, single["params"], single["accum"], single["loss"])
        for k in single["mu"]:
            np.testing.assert_allclose(got["mu"][k], single["mu"][k],
                                       atol=1e-6, err_msg=k)


def _jax_shard(case, kind):
    """JAX's sharded render of a case on 4 devices, and its gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from dynamic3dgaussians_tpu.ops.rasterize import RasterConfig
    from tests.scenes import lookat_camera
    from tests.scenes import random_scene as j_random_scene
    w, h, f, n, seed, bg = case
    cam, _, _ = lookat_camera(w=w, h=h, f=f, dist=4.0)
    scene = j_random_scene(n, seed=seed)
    for a, b in zip(scene, random_scene(n, seed)):
        np.testing.assert_array_equal(a, b)
    args = tuple(map(jnp.asarray, scene))
    cfg = RasterConfig(**SHARD_RASTER)
    if kind == "tile":
        from dynamic3dgaussians_tpu.parallel.tile_shard import \
            make_tile_sharded_render
        fn = make_tile_sharded_render(
            cam, Mesh(np.array(jax.devices()[:WORLD]), ("x",)), axis="x",
            config=cfg)
    else:
        from dynamic3dgaussians_tpu.parallel.gaussian_shard import \
            make_depth_sharded_render
        fn = make_depth_sharded_render(
            cam, Mesh(np.array(jax.devices()[:WORLD]), ("model",)),
            axis="model", config=cfg, method="tiled")
    if bg is not None:
        return {k: np.asarray(v) for k, v in
                fn(*args, bg=jnp.asarray(bg)).items()}
    ct = jnp.asarray(cotangent(case))

    def loss(m, c, o):
        out = fn(m, c, o, args[3], args[4])
        val = jnp.sum(out["rgb"] * ct)
        return val + 0.1 * jnp.sum(out["depth"]) if kind == "depth" else val
    return {"grads": [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*args[:3])]}


def _close_image(got, want):
    np.testing.assert_allclose(got["rgb"], want["rgb"], atol=2e-4)
    np.testing.assert_allclose(got["alpha"], want["alpha"], atol=2e-4)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1e-3,
                               rtol=1e-4)


def _close_grads(got, want):
    for a, b, name in zip(got, want, GRAD_NAMES):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("kind", ["tile", "depth"])
def test_sharded_render_matches_jax(ranks, kind):
    case = TILE_FWD if kind == "tile" else DEPTH_FWD
    want = _jax_shard(case, kind)
    for got in _get(ranks, f"{kind}_fwd"):
        _close_image(got, want)


@pytest.mark.parametrize("kind", ["tile", "depth"])
def test_sharded_gradients_match_jax_on_every_rank(ranks, kind):
    """Each rank's gradient of the replicated inputs is the whole
    gradient: JAX's, and the port's single-process one."""
    case = TILE_GRAD if kind == "tile" else DEPTH_GRAD
    want = _jax_shard(case, kind)["grads"]
    single = _get(ranks, f"single_{kind}_grad", 0)
    for got in _get(ranks, f"{kind}_grad"):
        _close_grads(got["grads"], want)
        _close_grads(got["grads"], single["grads"])
    assert max(np.abs(g).max() for g in want) > 0


def test_tile_forward_matches_single_process(ranks):
    single = _get(ranks, "single_tile_fwd", 0)
    for got in _get(ranks, "tile_fwd"):
        _close_image(got, single)


@pytest.mark.parametrize("kind", ["tile", "depth"])
def test_sharded_world_size_one_matches_single_process(ranks, kind):
    single = _get(ranks, f"single_{kind}_grad", 0)
    for got in _get(ranks, f"w1_{kind}_grad"):
        _close_image(got, single)
        _close_grads(got["grads"], single["grads"])


@pytest.mark.parametrize("size", [WORLD, 1])
def test_collectives_and_replicated_gradients(ranks, size):
    outs = _get(ranks, "collectives" if size == WORLD else "w1_collectives")
    group_xs = [np.arange(8 * size, dtype=np.float32).reshape(2 * size, 4)
                + i for i in range(size)]
    for got in outs:
        assert got["size"] == size
        assert got["impl"]["reduce_scatter"] == "all_reduce+own_rows"
        total = np.sum(group_xs, 0)
        np.testing.assert_array_equal(got["psum"], total)
        np.testing.assert_allclose(got["pmean"], total / size)
        np.testing.assert_array_equal(got["pmax"], np.max(group_xs, 0))
        np.testing.assert_array_equal(got["all_gather"],
                                      np.concatenate(group_xs, 0))
        i = got["rank"]
        np.testing.assert_array_equal(got["psum_scatter"],
                                      total[2 * i:2 * i + 2])
        xr = np.linspace(-1, 1, 8 * size, dtype=np.float32).reshape(
            2 * size, 4)
        # the single-device gradients, not K times them
        np.testing.assert_allclose(got["grad_gather"], 6 * xr, rtol=1e-6)
        np.testing.assert_allclose(got["grad_psum"], np.ones_like(xr),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["grad_scatter"],
                                   np.full_like(xr, 2.0), rtol=1e-6)


def test_sharded_adam_state_round_trip(ranks):
    for got in _get(ranks, "adam_roundtrip"):
        assert got["same"]
        assert got["shard_rows"] == DP_CAP // WORLD


def test_divisibility_errors(ranks):
    for got in _get(ranks, "errors"):
        assert "camera batch of 6 must divide" in got["batch"]
        assert "capacity 250 must divide" in got["capacity"]
        assert "tile rows 3 must divide" in got["tile_rows"]


def _fail_on_rank_one(rank, world_size):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()      # the others wait for rank 1, which never comes


def _sleep(rank, world_size):
    import time
    time.sleep(60.0)


def test_spawn_raises_for_a_failing_rank_without_waiting():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="of 2 failed") as err:
        mesh.spawn(_fail_on_rank_one, 2, "gloo", timeout_s=60.0)
    # rank 0 may fail too, when it sees its peer's socket close first
    assert "rank 1 of 2 failed" in str(err.value)
    assert "rank one fails" in str(err.value)
    assert time.monotonic() - t0 < 30.0     # the blocked rank was stopped


def test_spawn_times_out():
    with pytest.raises(TimeoutError, match="did not finish within 2.0 s"):
        mesh.spawn(_sleep, 2, "gloo", timeout_s=2.0)
