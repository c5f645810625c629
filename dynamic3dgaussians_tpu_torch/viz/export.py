"""Stacked `params.npz` checkpoints and splat PLY export (numpy on the host).

Port of `dynamic3dgaussians_tpu/viz/export.py`, the same file formats:

  * `save_params` / `load_params`: keys present at every timestep are
    stacked along a leading T axis, keys of the first timestep only are
    stored unstacked.
  * `save_ply_splat` / `load_ply_splat`: the binary little-endian 3DGS
    vertex layout x y z, nx ny nz, f_dc_0..2, opacity, scale_0..2,
    rot_0..3, colours stored as the SH DC term (`rgb_to_sh_np`).
  * `save_params_progressively`: a params_iter_<i>.npz and a PLY per call.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from dynamic3dgaussians_tpu_torch.ops.sh import C0


def rgb_to_sh_np(rgb: np.ndarray) -> np.ndarray:
    return (rgb - 0.5) / C0


def save_params(output_params: List[Dict[str, np.ndarray]], out_dir: str,
                filename: str = "params") -> str:
    """Stack per-timestep parameter dicts into `<out_dir>/<filename>.npz`."""
    to_save = {}
    later_keys = set(output_params[1].keys()) if len(output_params) > 1 \
        else set(output_params[0].keys())
    for k in output_params[0].keys():
        if k in later_keys:
            to_save[k] = np.stack([np.asarray(p[k]) for p in output_params])
        else:
            to_save[k] = np.asarray(output_params[0][k])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez(path, **to_save)
    return path + ".npz"


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_ply_splat(path: str, means: np.ndarray, log_scales: np.ndarray,
                   rotations: np.ndarray, rgbs: np.ndarray,
                   opacities: np.ndarray, normals: np.ndarray = None) -> str:
    """Write a binary little-endian 3DGS PLY; returns `path`."""
    n = means.shape[0]
    if normals is None:
        normals = np.zeros_like(means)
    if log_scales.shape[1] == 1:
        log_scales = np.tile(log_scales, (1, 3))
    colors = rgb_to_sh_np(rgbs)
    attrs = np.concatenate([
        means, normals, colors, opacities.reshape(n, -1)[:, :1],
        log_scales, rotations], axis=1).astype("<f4")
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2",
             "opacity", "scale_0", "scale_1", "scale_2",
             "rot_0", "rot_1", "rot_2", "rot_3"]
    assert attrs.shape[1] == len(names)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(attrs.tobytes())
    return path


def load_ply_splat(path: str) -> Dict[str, np.ndarray]:
    """Read back the PLY layout `save_ply_splat` writes."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise IOError(f"{path}: no end_header")
            header += line
        lines = header.decode("ascii").splitlines()
        n = next(int(ln.split()[-1]) for ln in lines
                 if ln.startswith("element vertex"))
        names = [ln.split()[-1] for ln in lines if ln.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(names))
    cols = {name: data[:, i] for i, name in enumerate(names)}
    return {
        "means3D": np.stack([cols["x"], cols["y"], cols["z"]], -1),
        "rgb_colors": np.stack([cols["f_dc_0"], cols["f_dc_1"],
                                cols["f_dc_2"]], -1) * C0 + 0.5,
        "logit_opacities": cols["opacity"][:, None],
        "log_scales": np.stack([cols["scale_0"], cols["scale_1"],
                                cols["scale_2"]], -1),
        "unnorm_rotations": np.stack([cols["rot_0"], cols["rot_1"],
                                      cols["rot_2"], cols["rot_3"]], -1),
    }


def save_params_progressively(params_cpu: Dict[str, np.ndarray], out_dir: str,
                              iteration: int) -> None:
    """`<out_dir>/params_iter_<i>.npz` and `iter_<i>points.ply` of one
    timestep's host parameters."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"params_iter_{iteration}"), **params_cpu)
    save_ply_splat(
        os.path.join(out_dir, f"iter_{iteration}points.ply"),
        params_cpu["means3D"], params_cpu["log_scales"],
        params_cpu["unnorm_rotations"], params_cpu["rgb_colors"],
        params_cpu["logit_opacities"])
