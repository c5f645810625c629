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
                "eval.suite"):
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
                                   "track_pixels"])
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
