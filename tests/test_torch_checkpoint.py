"""Port parity: training checkpoints and resume (`cli train
--checkpoint_every N --resume`).

The port's CheckpointManager on its own (a bitwise round trip, the newest
`max_to_keep` steps kept, no half-written file), then one 3-timestep run of
each package with checkpoint_every=7 (shared by the tests through a module
fixture): both save the same steps with the same cursors; a resume from the
final checkpoint returns the run's final state (bitwise in the port; within
atol 1e-5 when the port resumes from the checkpoint JAX wrote, converted by
`convert.checkpoint_from_jax`, as the reference's own resume test holds
JAX); a mid-run resume from the JAX step inside t = 1, in both packages;
the reference's rules a resume follows (a save before its step's densify
block, K back at the caller's config), in the port; and `cli train
--checkpoint_every --resume` on a reference data layout.

Tolerances of the mid-run resume, each with its reason: those of the
3-timestep run in tests/test_torch_physics.py. The losses per report: the
image and segmentation terms rel 1e-5; each physics term rel 1e-4 plus
atol 1e-5 (bg 5e-6: Adam's first step of each t > 0 is signed by rounding,
see that file); the total rel 1e-4. Parameters within 2 x lr per step,
doubled by the forward extrapolation into t = 2; both runs start from the
same state, so nothing is carried in from t = 0.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.train import checkpoint as jckpt
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch import cli, convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.train import checkpoint as tckpt
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import optim as topt
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from dynamic3dgaussians_tpu_torch.viz import export as texp

torch.set_num_threads(1)

PHYSICS = ("rigid", "rot", "iso", "floor", "bg", "soft_col_cons")
SCENE_KW = dict(n_fg=60, n_bg=120, seed=0)
W, H, F = 64, 48, 55.0
NUM_T = 3
ITERS_FIRST, ITERS_LATER = 6, 4
EVERY = 7
# global steps 1-6 at t = 0, 7-10 at t = 1, 11-14 at t = 2; the final save
# at 14 + 1
SAVED = [7, 14, 15]
CURSORS = {7: {"t": 1, "i": 0}, 14: {"t": 2, "i": 3},
           15: {"t": 2, "i": ITERS_LATER}}
NEVER = 10 ** 9

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


class _SavedSteps:
    """Records the steps a CheckpointManager class saves, while active."""

    def __init__(self, cls):
        self.cls, self.steps = cls, []

    def __enter__(self):
        self.orig = self.cls.save
        orig, steps = self.orig, self.steps

        def save(mgr, step, *a, **kw):
            steps.append(int(step))
            return orig(mgr, step, *a, **kw)
        self.cls.save = save
        return self.steps

    def __exit__(self, *exc):
        self.cls.save = self.orig


def _state(seed=0, cap=64):
    rng = np.random.RandomState(seed)
    params = {"means3D": torch.as_tensor(rng.normal(size=(cap, 3))
                                         .astype(np.float32)),
              "cam_m": torch.as_tensor(rng.normal(size=(5, 3))
                                       .astype(np.float32))}
    opt = topt.init(params)
    opt = topt.AdamState(
        mu={k: v + 0.5 for k, v in opt.mu.items()},
        nu={k: v + 0.25 for k, v in opt.nu.items()},
        step=torch.tensor(3, dtype=torch.int32))
    variables = {"alive": torch.as_tensor(rng.uniform(size=cap) > 0.5),
                 "neighbor_indices": torch.as_tensor(
                     rng.randint(-1, cap, (cap, 4)).astype(np.int32)),
                 "scene_radius": torch.tensor(2.5)}
    return params, opt, variables


def test_manager_round_trip_and_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.load(device="cpu") is None
    states = {}
    for step in (2, 5, 9, 11):
        states[step] = _state(seed=step)
        mgr.save(step, *states[step], {"t": step // 5, "i": step % 5})
    assert mgr.steps() == [5, 9, 11] and mgr.latest_step() == 11
    assert sorted(os.listdir(mgr.directory)) == [
        "step_11.pt", "step_5.pt", "step_9.pt"]      # no temporary left
    for step in (None, 9):
        got_step, p, o, v, cursor = mgr.load(step, device="cpu")
        want = states[got_step]
        assert got_step == (11 if step is None else 9)
        assert cursor == {"t": got_step // 5, "i": got_step % 5}
        for got, exp in ((p, want[0]), (o.mu, want[1].mu),
                         (o.nu, want[1].nu), (v, want[2])):
            assert set(got) == set(exp)
            for k in exp:
                assert got[k].dtype == exp[k].dtype
                assert torch.equal(got[k], exp[k]), k
        assert o.step.dtype == torch.int32 and int(o.step) == 3
    mgr.close()


# ------------------------------------------------- runs of both packages

@pytest.fixture(scope="module")
def world3():
    scene = tsyn.make_gt_scene(**SCENE_KW)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=NUM_T, num_cams=4, w=W,
                                    h=H, f=F, device="cpu")
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


def _jax_tree(mgr_dir, step):
    """The reference's checkpoint at `step`, restored by its own manager,
    as the numpy tree `checkpoint_from_jax` takes."""
    mgr = jckpt.CheckpointManager(mgr_dir)
    _, p, o, v, cursor = mgr.load(step)
    mgr.close()
    return jax.tree.map(np.asarray, jckpt._to_pytree(p, o, v, cursor))


@pytest.fixture(scope="module")
def runs(world3, tmp_path_factory):
    """Both packages' 3-timestep runs with checkpoint_every=7, once."""
    ds, tds, pt, w2c = world3
    jcfg, tcfg = _cfgs()
    root = tmp_path_factory.mktemp("ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    with _SavedSteps(jckpt.CheckpointManager) as jsaved:
        jout, jparams, _ = jtr.train(ds, jcfg, pt, w2c, checkpoint_dir=jdir,
                                     checkpoint_every=EVERY)
    with _SavedSteps(tckpt.CheckpointManager) as tsaved:
        tout, tparams, tvars = ttr.train(tds, tcfg, pt, w2c,
                                         checkpoint_dir=tdir,
                                         checkpoint_every=EVERY,
                                         device="cpu")
    return dict(root=root, jdir=jdir, tdir=tdir, jsaved=jsaved,
                tsaved=tsaved, jout=jout, jparams=jparams, tout=tout,
                tparams=tparams, radius=float(tvars["scene_radius"]))


def test_saved_steps_match_reference(runs):
    assert runs["tsaved"] == runs["jsaved"] == SAVED
    mgr = tckpt.CheckpointManager(runs["tdir"])
    assert mgr.steps() == SAVED                      # max_to_keep 3
    for step, cursor in CURSORS.items():
        assert mgr.load(step, device="cpu")[4] == cursor, step
        assert _jax_tree(runs["jdir"], step)["cursor"] == cursor, step


def test_resume_from_final_checkpoint_is_bitwise(runs, world3):
    _, tds, pt, w2c = world3
    _, tcfg = _cfgs()
    ck = str(runs["root"] / "port_final")
    shutil.copytree(runs["tdir"], ck)
    out, params, _ = ttr.train(tds, tcfg, pt, w2c, checkpoint_dir=ck,
                               checkpoint_every=NEVER, resume=True,
                               device="cpu")
    # the timesteps before the cursor's are skipped, as in the reference
    assert len(out) == 1 and set(out[0]) == set(runs["tout"][2])
    for k, v in out[0].items():
        np.testing.assert_array_equal(v, runs["tout"][2][k], err_msg=k)
    assert set(params) == set(runs["tparams"])
    for k, v in params.items():
        assert torch.equal(v, runs["tparams"][k]), k
    # the resumed run saves its own final step, one past the restored one
    assert tckpt.CheckpointManager(ck).latest_step() == SAVED[-1] + 1


def test_resume_from_jax_final_checkpoint(runs, world3):
    """The reference's own resume (tests/test_checkpoint_cli.py: means3D
    within 1e-5 of the full run), and the port resumed from the checkpoint
    JAX wrote, converted: the reference's final state within 1e-5."""
    ds, tds, pt, w2c = world3
    jcfg, tcfg = _cfgs()
    jck = str(runs["root"] / "jax_final")
    shutil.copytree(runs["jdir"], jck)
    _, jres, _ = jtr.train(ds, jcfg, pt, w2c, checkpoint_dir=jck,
                           checkpoint_every=NEVER, resume=True)
    np.testing.assert_allclose(np.asarray(jres["means3D"]),
                               np.asarray(runs["jparams"]["means3D"]),
                               atol=1e-5)

    p, o, v, cursor = convert.checkpoint_from_jax(
        _jax_tree(runs["jdir"], SAVED[-1]), "cpu")
    assert cursor == CURSORS[SAVED[-1]]
    tck = str(runs["root"] / "port_from_jax")
    tckpt.CheckpointManager(tck).save(SAVED[-1], p, o, v, cursor)
    out, params, _ = ttr.train(tds, tcfg, pt, w2c, checkpoint_dir=tck,
                               checkpoint_every=NEVER, resume=True,
                               device="cpu")
    assert set(params) == set(runs["jparams"])
    for k, want in runs["jparams"].items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k, want in runs["jout"][2].items():
        np.testing.assert_allclose(out[0][k], np.asarray(want), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_mid_run_resume_from_jax_checkpoint(runs, world3):
    """Both packages resume from the reference's step 7 (t = 1, i = 0)."""
    ds, tds, pt, w2c = world3
    jcfg, tcfg = _cfgs()
    step = SAVED[0]
    tree = _jax_tree(runs["jdir"], step)
    # the reference's resume reads the latest step of its directory
    jck = str(runs["root"] / "jax_mid")
    mgr = jckpt.CheckpointManager(jck)
    restored = jckpt.CheckpointManager(runs["jdir"]).load(step)
    mgr.save(step, *restored[1:], wait=True)
    mgr.close()
    p, o, v, cursor = convert.checkpoint_from_jax(tree, "cpu")
    assert tuple(v["prev_offset"].shape) == tuple(
        np.asarray(tree["variables"]["prev_offset"]).shape[::-1])
    tck = str(runs["root"] / "port_mid")
    tckpt.CheckpointManager(tck).save(step, p, o, v, cursor)

    jlog, tlog = [], []
    jout, _, _ = jtr.train(ds, jcfg, pt, w2c, callbacks=_recorder(jlog),
                           checkpoint_dir=jck, checkpoint_every=NEVER,
                           resume=True)
    tout, _, tvars = ttr.train(tds, tcfg, pt, w2c,
                               callbacks=_recorder(tlog), checkpoint_dir=tck,
                               checkpoint_every=NEVER, resume=True,
                               device="cpu")
    steps = [(1, i) for i in range(1, ITERS_LATER)] + [
        (2, i) for i in range(ITERS_LATER)]
    assert [x[:2] for x in tlog] == [x[:2] for x in jlog] == steps
    tols = dict(loss=(1e-4, 0.0), loss_im=(1e-5, 0.0), loss_seg=(1e-5, 0.0),
                **{f"loss_{k}": (1e-4, 1e-5) for k in PHYSICS})
    tols["loss_bg"] = (1e-4, 5e-6)
    for (t, i, tm), (_, _, jm) in zip(tlog, jlog):
        for k, (rtol, atol) in tols.items():
            assert abs(tm[k] - jm[k]) <= rtol * abs(jm[k]) + atol, \
                (t, i, k, tm[k], jm[k])
        assert tm["n_dropped"] == jm["n_dropped"] == 0
    # output params from the resumed timestep on: t = 1 and t = 2
    assert len(tout) == len(jout) == 2
    radius = float(tvars["scene_radius"])
    for k in ("means3D", "rgb_colors", "unnorm_rotations"):
        lr = tcfg.lrs[k] * (radius if k == "means3D" else 1.0)
        e1 = 2 * lr * (ITERS_LATER - 1)
        bounds = (e1, 2 * e1 + 2 * lr * ITERS_LATER)
        for t, bound in enumerate(bounds):
            np.testing.assert_allclose(tout[t][k], np.asarray(jout[t][k]),
                                       atol=bound + 1e-6, rtol=0,
                                       err_msg=f"t{t + 1} {k}")


def test_resume_keeps_the_reference_schedule(world3, tmp_path):
    """Port only, the reference's rules that a resume follows: a step's
    save comes before its densify block, so the state saved at i = 2
    holds no densified row and the resumed run (from i + 1) never runs
    the densify of i = 2; K restarts at the caller's config, since an
    escalated K lives only in the run's local config."""
    _, tds, pt, w2c = world3
    cfg = tconf.TrainConfig(
        num_timesteps=1, iters_first_timestep=6, densify_start=2,
        densify_every=2, capacity=1024, report_every=2,
        raster=tconf.RasterSettings(chunk=64, max_tiles_per_gaussian=2,
                                    method="torch"))
    cfg.loss_weights = dict(cfg.loss_weights, im=500.0)   # hot gradients

    def run(ck, resume):
        seen = {"densify": [], "k": []}
        ttr.train(tds[:1], cfg, pt, w2c, checkpoint_dir=ck,
                  checkpoint_every=3, resume=resume, device="cpu",
                  callbacks={"on_densify": lambda t, i, st:
                             seen["densify"].append((i, int(st.n_cloned)
                                                     + int(st.n_split))),
                             "on_iter": lambda t, i, k:
                             seen["k"].append((i, k))})
        return seen

    full = run(str(tmp_path / "full"), False)
    assert [i for i, _ in full["densify"]] == [2, 4]
    assert full["densify"][0][1] > 0                  # i = 2 adds rows
    assert full["k"][3][1] > cfg.raster.max_tiles_per_gaussian
    mgr = tckpt.CheckpointManager(str(tmp_path / "full"))
    assert mgr.steps() == [3, 6, 7]
    _, _, _, v3, cursor = mgr.load(3, device="cpu")
    assert cursor == {"t": 0, "i": 2}
    assert int(v3["alive"].sum()) == pt.shape[0]      # saved before densify

    mid = tmp_path / "mid"
    mid.mkdir()
    shutil.copy(mgr.path(3), mid)
    resumed = run(str(mid), True)
    assert [i for i, _ in resumed["densify"]] == [4]
    assert resumed["k"][0] == (3, cfg.raster.max_tiles_per_gaussian)


def test_cli_train_checkpoint_and_resume(tmp_path):
    """`cli train --checkpoint_every 3` on a 3-timestep layout (4 + 3 + 3
    steps: saves at 3, 6, 9 and the final one at 11), then `--resume` from
    the final checkpoint and from the mid-t = 1 one (step 6: t = 1, i = 1)
    in copies of the output directory."""
    scene = tsyn.make_gt_scene(n_fg=30, n_bg=60, seed=1)
    data = str(tmp_path / "data")
    tsyn.write_reference_layout(data, "seq", num_t=3, num_cams=3, w=48,
                                h=32, f=40.0, scene=scene, device="cpu")
    over = tmp_path / "cfg.json"
    over.write_text(json.dumps({"report_every": 1, "densify_start": 10 ** 9,
                                "num_knn": 8, "raster": {"chunk": 64}}))

    def run(out, *extra):
        argv = ["train", "--data_root", data, "--seq", "seq", "--exp", "e",
                "--output", str(out), "--iters_first", "4", "--iters_per_t",
                "3", "--capacity", "512", "--config_json", str(over),
                "--device", "cpu", *extra]
        assert cli.main(argv) == 0
        run_dir = out / "e" / "seq"
        return run_dir, texp.load_params(str(run_dir / "params.npz"))

    full_dir, full = run(tmp_path / "full", "--checkpoint_every", "3")
    ck = tckpt.CheckpointManager(str(full_dir / "ckpt"))
    assert ck.steps() == [6, 9, 11]
    assert ck.load(6, device="cpu")[4] == {"t": 1, "i": 1}

    shutil.copytree(tmp_path / "full", tmp_path / "final")
    _, res = run(tmp_path / "final", "--checkpoint_every", "3", "--resume")
    for k in ("means3D", "rgb_colors", "unnorm_rotations"):
        assert res[k].shape[0] == 1
        np.testing.assert_array_equal(res[k][0], full[k][2], err_msg=k)

    shutil.copytree(tmp_path / "full", tmp_path / "mid")
    for step in (9, 11):
        os.remove(tmp_path / "mid" / "e" / "seq" / "ckpt" / f"step_{step}.pt")
    mid_dir, mid = run(tmp_path / "mid", "--checkpoint_every", "3",
                       "--resume")
    assert mid["means3D"].shape[0] == 2               # t = 1 and t = 2
    for k in mid:
        assert np.isfinite(mid[k]).all(), k
    rows = [json.loads(x) for x in (mid_dir / "metrics.jsonl").read_text()
            .splitlines()]
    # the copy's log holds the full run's 10 reports, then the resumed
    # run's: t = 1 from i = 2, then t = 2
    reports = [(t, r["step"]) for r in rows for t in range(3)
               if f"t{t}/loss" in r]
    assert len(reports) == 10 + 4
    assert reports[-4:] == [(1, 2), (2, 0), (2, 1), (2, 2)]
