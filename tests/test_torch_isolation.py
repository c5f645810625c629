"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

Importing every module of `dynamic3dgaussians_tpu_torch` (in a fresh
interpreter, with imports of `jax`, `jaxlib` and `dynamic3dgaussians_tpu`
blocked) must leave none of them in `sys.modules`; and an entry point
called without a device on a machine without CUDA raises instead of
running on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch import cli
from dynamic3dgaussians_tpu_torch.device import resolve_device
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.viz import export as texp
from dynamic3dgaussians_tpu_torch.viz import render as tvr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "dynamic3dgaussians_tpu")

def forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)

class Block:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"the port imported {name}")
        return None

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())

import dynamic3dgaussians_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
left = sorted(m for m in sys.modules if forbidden(m))
assert not left, left
print(len(names), " ".join(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.split(maxsplit=1)
    names = names.split()
    # every module of the slice was reached
    for mod in ("ops.cuda.raster_fwd", "ops.cuda.raster_bwd",
                "ops.sorted_raster", "ops.rasterize", "ops.ssim", "ops.knn",
                "ops.neighbor", "models.gaussians", "train.losses",
                "train.optim", "train.densify", "train.config",
                "train.trainer", "data.dataset", "data.synthetic",
                "utils.logging", "viz.render", "viz.export", "cli",
                "convert", "_build", "ops.cuda.sol_probe",
                "tools.bench_sol", "native", "train.checkpoint",
                "eval.metrics", "eval.lpips", "eval.tracking",
                "eval.suite", "ops.playback", "ops.debug",
                "viz.live_viewer", "viz.network_gui", "utils.timing",
                "utils.pose_utils", "utils.image_utils", "data.colmap",
                "data.features", "models.gaussian_model", "models.scene",
                "train.feature_trainer", "train.ego_trainer",
                "models.motion_bases", "train.motion_trainer", "train.flow",
                "data.tracks", "data.init_clouds", "data.tools",
                "utils.clip_utils", "parallel.mesh", "parallel.collectives",
                "parallel.camera_dp", "parallel.tile_shard",
                "parallel.gaussian_shard", "tools.dynamic_run",
                "tools.tracking_eval", "tools.scale_run",
                "tools.roundtrip_demo"):
        assert f"dynamic3dgaussians_tpu_torch.{mod}" in names
    assert int(count) == len(names)


def _tiny():
    rng = np.random.RandomState(0)
    n = 8
    params = {"means3D": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
              "rgb_colors": rng.rand(n, 3).astype(np.float32),
              "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
              "logit_opacities": np.zeros((n, 1), np.float32),
              "log_scales": np.full((n, 3), -3.0, np.float32)}
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(32, 32, [[30, 0, 16], [0, 30, 16], [0, 0, 1]],
                           w2c, device="cpu")
    return params, cam


@pytest.mark.parametrize("entry", ["resolve_device", "render",
                                   "render_frame", "orbit_render", "cli",
                                   "cli_train", "train", "bench_sol",
                                   "evaluate", "evaluate_suite",
                                   "track_pixels", "cli_view",
                                   "cli_view_gui", "serve",
                                   "render_playback", "build_cache",
                                   "orbit_render_playback",
                                   "checkpoint_source", "network_gui",
                                   "gaussian_model", "feature_decoder",
                                   "train_ego", "train_motion",
                                   "train_motion_windowed", "render_flow",
                                   "compose_scenes", "make_dp_train_step",
                                   "make_tile_sharded_render",
                                   "make_depth_sharded_render",
                                   "tool_dynamic_run", "tool_tracking_eval",
                                   "tool_scale_run", "tool_roundtrip_demo"])
def test_no_device_without_cuda_raises(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, cam = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "render":
            trast.render(cam, torch.as_tensor(params["means3D"]),
                         torch.as_tensor(params["rgb_colors"]),
                         torch.ones(8))
        elif entry == "render_frame":
            tvr.render_frame(params, cam)
        elif entry == "orbit_render":
            tvr.orbit_render(params, n_frames=1, w=32, h=32)
        elif entry == "cli":
            path = texp.save_params([params], str(tmp_path))
            cli.main(["visualize", "--params", path, "--frames", "1",
                      "--width", "32", "--height", "32"])
        elif entry == "bench_sol":
            from dynamic3dgaussians_tpu_torch.tools import bench_sol
            bench_sol.main(["--small"])
        elif entry in ("evaluate", "evaluate_suite"):
            path = texp.save_params([params], str(tmp_path))
            args = (["evaluate", "--params", path, "--seq", "seq"]
                    if entry == "evaluate" else
                    ["evaluate-suite", "--pairs", f"seq={path}"])
            cli.main(args + ["--data_root", str(tmp_path)])
        elif entry == "track_pixels":
            from dynamic3dgaussians_tpu_torch.eval.tracking import \
                track_pixels
            stacked = {k: v[None] for k, v in params.items()}
            track_pixels(stacked, cam, np.zeros((1, 2), np.float32))
        elif entry in ("cli_view", "cli_view_gui"):
            path = texp.save_params([params], str(tmp_path))
            cli.main(["view", "--port", "0"]
                     + (["--params", path] if entry == "cli_view" else
                        ["--gui_host", "127.0.0.1", "--gui_port", "1"]))
        elif entry == "serve":
            from dynamic3dgaussians_tpu_torch.viz.live_viewer import serve
            serve(params, port=0)
        elif entry == "checkpoint_source":
            from dynamic3dgaussians_tpu_torch.viz.live_viewer import \
                CheckpointSource
            CheckpointSource(params)
        elif entry == "network_gui":
            from dynamic3dgaussians_tpu_torch.viz.network_gui import \
                NetworkGUI
            NetworkGUI(port=0)
        elif entry in ("render_playback", "build_cache"):
            from dynamic3dgaussians_tpu_torch.ops import playback
            geom = (params["means3D"], np.ones(8, np.float32),
                    np.full((8, 3), 0.05, np.float32),
                    params["unnorm_rotations"])
            cache = playback.build_cache(cam, *geom, device="cpu")
            if entry == "build_cache":
                playback.build_cache(cam, *geom)
            else:
                playback.render_playback(cam, geom[0], params["rgb_colors"],
                                         *geom[1:], cache)
        elif entry == "orbit_render_playback":
            tvr.orbit_render(params, n_frames=2, w=32, h=32, resort_every=2)
        elif entry == "gaussian_model":
            from dynamic3dgaussians_tpu_torch.models.gaussian_model import \
                GaussianModel
            GaussianModel(sh_degree=1)
        elif entry == "feature_decoder":
            from dynamic3dgaussians_tpu_torch.train.feature_trainer import \
                FeatureDecoder
            FeatureDecoder(4, 8)
        elif entry == "train_ego":
            from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
            from dynamic3dgaussians_tpu_torch.train.ego_trainer import \
                train_ego
            pt = np.concatenate([params["means3D"], params["rgb_colors"],
                                 np.ones((8, 1), np.float32)], axis=1)
            train_ego([[]], [[]], TrainConfig(num_timesteps=1), pt,
                      np.eye(4)[None].repeat(2, 0))
        elif entry in ("train_motion", "train_motion_windowed"):
            from dynamic3dgaussians_tpu_torch.train import motion_trainer
            from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
            pt = np.concatenate([params["means3D"], params["rgb_colors"],
                                 np.ones((8, 1), np.float32)], axis=1)
            getattr(motion_trainer, entry)([[]], TrainConfig(), pt,
                                           np.eye(4)[None].repeat(2, 0),
                                           num_bases=2)
        elif entry == "render_flow":
            from dynamic3dgaussians_tpu_torch.train.flow import render_flow
            render_flow(cam, params["means3D"], params["means3D"] + 0.1,
                        params["rgb_colors"], np.ones(8, np.float32),
                        np.full((8, 3), 0.05, np.float32),
                        params["unnorm_rotations"])
        elif entry == "compose_scenes":
            from dynamic3dgaussians_tpu_torch.models.gaussians import \
                compose_scenes
            compose_scenes(params, params)
        elif entry == "make_dp_train_step":
            from dynamic3dgaussians_tpu_torch.parallel.camera_dp import \
                make_dp_train_step
            from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
            make_dp_train_step(TrainConfig(), trast.RasterConfig())
        elif entry in ("make_tile_sharded_render",
                       "make_depth_sharded_render"):
            from dynamic3dgaussians_tpu_torch.parallel import (gaussian_shard,
                                                               tile_shard)
            mod = tile_shard if entry.startswith("make_tile") else \
                gaussian_shard
            getattr(mod, entry)(cam)
        elif entry.startswith("tool_"):
            import importlib
            tool = importlib.import_module(
                f"dynamic3dgaussians_tpu_torch.tools.{entry[5:]}")
            out = str(tmp_path / "out.json")
            tool.main({"tool_dynamic_run": ["--n", "8", "--timesteps", "1",
                                            "--iters0", "1", "--hw", "32",
                                            "--out", out],
                       "tool_tracking_eval": ["--params",
                                              texp.save_params(
                                                  [params], str(tmp_path)),
                                              "--timesteps", "1",
                                              "--out", out],
                       "tool_scale_run": ["--n", "8", "--iters", "1",
                                          "--hw", "32", "--out", out],
                       "tool_roundtrip_demo": ["--out", str(tmp_path),
                                               "--artifact", out]}[entry])
        elif entry == "cli_train":
            cli.main(["train", "--synthetic", "--timesteps", "1",
                      "--iters_first", "1", "--output", str(tmp_path)])
        else:
            from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
            from dynamic3dgaussians_tpu_torch.train.trainer import train
            pt = np.concatenate([params["means3D"], params["rgb_colors"],
                                 np.ones((8, 1), np.float32)], axis=1)
            train([[]], TrainConfig(num_timesteps=1), pt,
                  np.eye(4)[None].repeat(2, 0))


_NATIVE_PROBE = r"""
import os, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "dynamic3dgaussians_tpu" or name.startswith(
                "dynamic3dgaussians_tpu."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
from dynamic3dgaussians_tpu_torch import native
import numpy as np
assert native.available()
out = sys.argv[1]
n = 5
z = np.zeros((n, 3), np.float32)
native.ply_write(out, z, z, np.zeros(n, np.float32), z,
                 np.zeros((n, 4), np.float32))
assert native.ply_read(out)["means3D"].shape == (n, 3)
with native.FileLoader() as ld:
    ld.prefetch([out])
    assert ld.take(out) == open(out, "rb").read()
print(native.library_path())
"""


def test_native_builds_its_own_library_and_leaves_native_alone(tmp_path):
    """The port's native binding never loads the JAX package's native.py
    and never writes under native/: its library is built under build/.
    Run in a copy of the port and of native/src (no JAX package beside
    them), so that no other test's build of native/ shows in the check."""
    import shutil
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "dynamic3dgaussians_tpu_torch"),
                    root / "dynamic3dgaussians_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO, "native", "src"),
                    root / "native" / "src")

    def snapshot():
        out = {}
        for base, _, files in os.walk(root / "native"):
            for f in files:
                st = os.stat(os.path.join(base, f))
                out[os.path.join(base, f)] = (st.st_size, st.st_mtime_ns)
        return out

    before = snapshot()
    out = subprocess.run([sys.executable, "-c", _NATIVE_PROBE,
                          str(tmp_path / "x.ply")], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = out.stdout.strip().splitlines()[-1]
    assert lib.startswith(str(root / "build" / "native") + os.sep)
    assert os.path.exists(lib)
    assert snapshot() == before


@pytest.mark.parametrize("tool", ["dynamic_run", "tracking_eval",
                                  "scale_run", "roundtrip_demo"])
def test_tool_default_outputs_are_new_files(tool):
    """The long-run tools' default logs never overwrite a file of the
    reference's tools: artifacts/torch_<tool>_<device type>.json, for the
    card and the CPU alike."""
    from dynamic3dgaussians_tpu_torch.tools.dynamic_run import default_out
    art = os.path.join(REPO, "artifacts")
    reference = {f for f in os.listdir(art) if not f.startswith("torch_")}
    assert {"dynamic_run_cpu.json", "scale_run_cpu.json",
            "roundtrip_demo.json"} <= reference
    for dev in ("cuda", "cpu"):
        path = default_out(tool, torch.device(dev))
        assert path == os.path.join(art, f"torch_{tool}_{dev}.json")
        assert os.path.basename(path) not in reference
