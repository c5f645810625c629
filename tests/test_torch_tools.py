"""Port parity: the long-run tools (`dynamic3dgaussians_tpu_torch/tools/`
`dynamic_run`, `tracking_eval`, `scale_run`, `roundtrip_demo`) against
the reference's `tools/*.py` and its trainer, at a small size on the CPU.

* `dynamic_run`: the reference tool's TrainConfig (captured by a recorder
  in place of `train`, which its `main()` imports when it runs) equals the
  port's `build_config` through the shared JSON, except for the mappings
  the port's docstring names (`pairs_budget_cap` 16 -> 0; `pack_records`
  stays True, as in the reference's tool); the log has the reference
  tool's keys; a whole 2-timestep run equals JAX `train()` on the
  port-rendered images (`method="pallas"`, interpret mode), both with the
  tool's config but the record pack off: under the pack each package
  rounds its per-pair gradients to bf16, so float32-level differences
  become whole bf16 steps, which Adam carries past this run's float32
  bounds (the pack's parity, a train step included, is held in
  tests/test_torch_raster_variants.py): the loss of every step within 1e-5
  relative, PSNR at the reports within 1e-3 (the log rounds it to 1e-3),
  the alive count of every timestep equal, and the final parameters
  within 2 lr per step (Adam's eps of 1e-15 moves an element whose
  gradient is at rounding level by +-lr in either package).
* `tracking_eval`: both tools on one stacked npz (the synthetic scene's
  true motion, jittered): every result within 1e-5 relative plus the
  tool's own rounding step, the PCK values equal.
* `roundtrip_demo`: the params.npz layout has the key set and ranks of
  the reference's recorded run (`artifacts/roundtrip_demo.json`).

`scale_run` is held in tests/test_torch_tools_scale.py.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.tools import (dynamic_run, roundtrip_demo,
                                                tracking_eval)
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from dynamic3dgaussians_tpu_torch.viz.export import load_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    """The reference's tools/<name>.py as a module (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mp, name, argv):
    """The reference tool's main() under `argv`, without its XLA
    compilation cache (a process-wide setting)."""
    mp.setattr("dynamic3dgaussians_tpu.utils.compile_cache.enable",
               lambda *a, **k: None)
    mp.setattr(sys, "argv", [f"{name}.py"] + argv)
    return _reference_tool(name).main()


def _jax_frames(frames):
    """Port datapoints (CPU tensors) as reference datapoints: the same
    images, the same cameras."""
    out = []
    for fr in frames:
        cam = fr["camera"]
        k = [[float(cam.fx), 0, float(cam.cx)], [0, float(cam.fy),
                                                  float(cam.cy)], [0, 0, 1]]
        out.append({"camera": jcam.make_camera(
                        cam.width, cam.height, k,
                        np.asarray(cam.w2c.numpy(), np.float64),
                        near=cam.near, far=cam.far),
                    "im": jnp.asarray(fr["im"].numpy()),
                    "seg": jnp.asarray(fr["seg"].numpy()),
                    "cam_id": jnp.int32(fr["cam_id"])})
    return out


def _step_recorder(module, log):
    """Wrap `module.make_train_step` so every step's loss lands in `log`."""
    make = module.make_train_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            log.append(float(out[3]["loss"]))
            return out
        return run
    return wrapped


# ---------------------------------------------------------------- dynamic_run

DR_ARGV = ["--n", "300", "--timesteps", "2", "--iters0", "6", "--iters", "4",
           "--hw", "48", "--cams", "3", "--no_densify"]


def _reference_dynamic_run(mp, argv, tmp_path):
    """Run the reference tool's main() with a recorder in place of `train`:
    it keeps the TrainConfig, calls the tool's callbacks once per timestep
    and returns host parameters, so the tool writes its whole log.
    Returns (TrainConfig, log)."""
    seen = {}

    def fake_train(dataset, cfg, pt, w2c, callbacks=None, **kw):
        seen["cfg"] = cfg
        n = pt.shape[0]
        out = []
        for t in range(cfg.num_timesteps):
            callbacks["on_step"](t, 0, {"psnr": 10.0, "loss": 1.0})
            callbacks["on_timestep"](t, None, {"alive": np.ones(n, bool)})
            out.append({"means3D": pt[:, :3]})
        return out, None, None

    mp.setattr("dynamic3dgaussians_tpu.train.trainer.train", fake_train)
    out = str(tmp_path / "reference_dynamic_run.json")
    _run_reference(mp, "dynamic_run", argv + [
        "--out", out, "--save_params", str(tmp_path / "ref_params.npz")])
    with open(out) as f:
        return seen["cfg"], json.load(f)


@pytest.mark.parametrize("extra", [[], ["--no_densify", "--k_cap", "16",
                                        "--steps_per_call", "4"]])
def test_dynamic_run_config_matches_reference_tool(extra, tmp_path):
    argv = ["--n", "300", "--timesteps", "2", "--iters0", "150", "--iters",
            "4", "--hw", "32", "--cams", "2"] + extra
    with pytest.MonkeyPatch.context() as mp:
        jcfg, _ = _reference_dynamic_run(mp, argv, tmp_path)
    want = json.loads(jcfg.to_json())
    # the reference tool on its CPU backend: the tiled path's pair budget,
    # mapped by the port; the record pack, kept
    assert want["raster"]["pack_records"] is True
    assert want["pairs_budget_cap"] == 16
    want["pairs_budget_cap"] = 0
    got = dynamic_run.build_config(dynamic_run.parse_args(argv))
    assert json.loads(got.to_json()) == want


def _unpacked(build):
    """The tool's build_config with the record pack off (module
    docstring)."""
    def wrapped(args):
        cfg = build(args)
        cfg.raster.pack_records = False
        return cfg
    return wrapped


@pytest.fixture(scope="module")
def dynamic_runs(tmp_path_factory):
    """The port tool on the CPU and JAX `train()` on the same images and
    config (method "pallas", interpret mode; the record pack off in both),
    each step's loss recorded."""
    tmp = tmp_path_factory.mktemp("dynamic_run")
    argv = DR_ARGV + ["--device", "cpu", "--out", str(tmp / "port.json"),
                      "--save_params", str(tmp / "port_params.npz")]
    args = dynamic_run.parse_args(argv)
    port_losses, jax_losses, jax_psnr, jax_alive = [], [], [], []
    build_config = _unpacked(dynamic_run.build_config)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "make_train_step", _step_recorder(ttr, port_losses))
        mp.setattr(dynamic_run, "build_config", build_config)
        log = dynamic_run.run(args)
    tds, w2c, pt = dynamic_run.build_data(args, "cpu")
    cfg = build_config(args)
    jcfg = jconf.TrainConfig.from_json(cfg.to_json())
    jcfg.raster.method = "pallas"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "make_train_step", _step_recorder(jtr, jax_losses))
        jout, _, _ = jtr.train(
            [_jax_frames(f) for f in tds], jcfg, pt, w2c, callbacks={
                "on_step": lambda t, i, m: jax_psnr.append(
                    (t, i, float(m["psnr"]))),
                "on_timestep": lambda t, p, v: jax_alive.append(
                    int(np.asarray(v["alive"]).sum()))})
    with pytest.MonkeyPatch.context() as mp:
        _, ref_log = _reference_dynamic_run(mp, DR_ARGV, tmp)
    return dict(args=args, log=log, port_losses=port_losses,
                jax_losses=jax_losses, jax_psnr=jax_psnr,
                jax_alive=jax_alive, jax_out=jout, cfg=cfg, ref_log=ref_log,
                w2c=w2c,
                params=load_params(str(tmp / "port_params.npz")))


def test_dynamic_run_losses_psnr_and_alive_match_jax_train(dynamic_runs):
    r = dynamic_runs
    n_steps = r["args"].iters0 + (r["args"].timesteps - 1) * r["args"].iters
    assert len(r["port_losses"]) == len(r["jax_losses"]) == n_steps
    for tl, jl in zip(r["port_losses"], r["jax_losses"]):
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    steps = r["log"]["steps"]
    assert [(s["t"], s["i"]) for s in steps] == \
        [(t, i) for t, i, _ in r["jax_psnr"]]
    for s, (_, _, jp) in zip(steps, r["jax_psnr"]):
        assert abs(s["psnr"] - jp) <= 1e-3, (s, jp)
    assert [p["n_alive"] for p in r["log"]["per_timestep"]] == \
        r["jax_alive"]
    assert r["log"]["completed"] and r["log"]["final_alive"] == 300


def test_dynamic_run_params_match_jax_train(dynamic_runs):
    r = dynamic_runs
    cfg, args = r["cfg"], r["args"]
    n_steps = args.iters0 + (args.timesteps - 1) * args.iters
    cams = np.linalg.inv(r["w2c"])[:, :3, 3]
    radius = 1.1 * float(np.max(np.linalg.norm(cams - cams.mean(0),
                                               axis=-1)))
    stacked = r["params"]
    want = {k: np.stack([np.asarray(p[k]) for p in r["jax_out"]])
            if k in r["jax_out"][1] else np.asarray(r["jax_out"][0][k])
            for k in r["jax_out"][0]}
    assert set(stacked) == set(want)
    for k, v in want.items():
        assert stacked[k].shape == v.shape, k
        lr = cfg.lrs.get(k, 0.0) * (radius if k == "means3D" else 1.0)
        np.testing.assert_allclose(stacked[k], v, rtol=0,
                                   atol=2 * lr * n_steps + 1e-6, err_msg=k)


def test_dynamic_run_log_has_the_reference_keys(dynamic_runs):
    got, want = dynamic_runs["log"], dynamic_runs["ref_log"]
    assert set(got) == set(want)
    assert set(got["per_timestep"][0]) == set(want["per_timestep"][0])
    assert set(got["steps"][0]) == set(want["steps"][0])
    assert got["backend"] == "cpu" and len(got["per_timestep"]) == 2


# -------------------------------------------------------------- tracking_eval

TE_N, TE_T = 400, 4


def _tracked_stack(path):
    """A stacked params npz of the synthetic scene moving by its true motion,
    jittered per point and timestep, with rotations that turn with it."""
    scene = tsyn.make_gt_scene(n_fg=TE_N // 2, n_bg=TE_N // 2, seed=0)
    rng = np.random.RandomState(5)
    n_fg = scene["n_fg"]
    means, rots = [], []
    for t in range(TE_T):
        R, shift = tsyn.rigid_motion(t, TE_T)
        m = scene["means"].copy()
        m[:n_fg] = m[:n_fg] @ R.T + shift
        means.append(m + rng.normal(0, 0.01, m.shape))
        ang = 0.6 * t / (TE_T - 1)
        q = np.tile([np.cos(ang / 2), 0, np.sin(ang / 2), 0], (TE_N, 1))
        q[n_fg:] = [1, 0, 0, 0]
        rots.append(q + rng.normal(0, 0.02, q.shape))
    seg = scene["seg"]
    np.savez(path, means3D=np.stack(means).astype(np.float32),
             unnorm_rotations=np.stack(rots).astype(np.float32),
             seg_colors=np.stack([seg, 0 * seg, 1 - seg], -1)
             .astype(np.float32))
    return str(path)


def test_tracking_eval_matches_reference_tool(tmp_path):
    params = _tracked_stack(tmp_path / "stack.npz")
    argv = ["--params", params, "--n", str(TE_N), "--timesteps", str(TE_T),
            "--cams", "4", "--hw", "96", "--queries", "48", "--knn", "6"]
    with pytest.MonkeyPatch.context() as mp:
        _run_reference(mp, "tracking_eval",
                       argv + ["--out", str(tmp_path / "ref.json")])
    with open(tmp_path / "ref.json") as f:
        want = json.load(f)
    got = tracking_eval.main(argv + ["--device", "cpu",
                                     "--out", str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want)
    # the rounding step of each key in the tools' output
    quantum = {"pck_0.05": 1e-4, "pck_2px": 1e-4, "px_err_median": 1e-3,
               "rpe_trans_mean": 1e-6, "rpe_rot_deg_mean": 1e-4}
    for k, v in want.items():
        if isinstance(v, str) or k.startswith("pck"):
            assert got[k] == v, k
        else:
            q = quantum.get(k, 1e-5 if isinstance(v, float) else 0)
            assert abs(got[k] - v) <= 1e-5 * abs(v) + q, (k, got[k], v)
    # a tracker that follows the true motion to ~0.01 units
    assert got["pck_0.05"] > 0.9 and got["err3d_mean"] < 0.05


# ------------------------------------------------------------- roundtrip_demo

def test_roundtrip_demo_layout_matches_reference_artifact(tmp_path):
    with open(os.path.join(REPO, "artifacts", "roundtrip_demo.json")) as f:
        ref = json.load(f)["params_layout"]
    got = roundtrip_demo.main([
        "--device", "cpu", "--iters", "12", "--iters_later", "6",
        "--size", "48", "32", "--cams", "3", "--out", str(tmp_path / "rt"),
        "--artifact", str(tmp_path / "rt.json")])
    layout = got["params_layout"]
    assert set(layout) == set(ref)
    assert {k: len(v) for k, v in layout.items()} == \
        {k: len(v) for k, v in ref.items()}
    assert layout["means3D"][0] == 3 and layout["means3D"][2] == 3
    assert os.path.exists(got["visualization"])
    assert np.isfinite(got["eval"]["mean_psnr"])
    with open(tmp_path / "rt.json") as f:
        assert json.load(f)["params_layout"] == layout
