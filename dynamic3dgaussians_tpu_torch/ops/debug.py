"""Numerical debug harness for the renderer.

Port of `dynamic3dgaussians_tpu/ops/debug.py`: a frustum visibility query,
and `render` with a check of its outputs that dumps every input to an .npz
snapshot for offline reproduction when an output is not finite.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops.rasterize import render


def mark_visible(cam, means3d: torch.Tensor) -> torch.Tensor:
    """True where a point lies in front of the camera's near plane."""
    v = cam.w2c
    means3d = torch.as_tensor(means3d, dtype=torch.float32, device=v.device)
    mx, my, mz = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    depth = v[2, 0] * mx + v[2, 1] * my + v[2, 2] * mz + v[2, 3]
    return depth > cam.near


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def render_debug(cam, *args, snapshot_path: str = "snapshot_fw.npz",
                 **kwargs):
    """render() and a check that rgb, depth and alpha are finite.

    Returns (output, ok). When ok is False every input has been written to
    `snapshot_path` (positional ones as arg_<i>, array keywords as
    kw_<name>, and the camera's w2c and K).
    """
    out = render(cam, *args, **kwargs)
    ok = bool(torch.isfinite(out.rgb).all() & torch.isfinite(out.depth).all()
              & torch.isfinite(out.alpha).all())
    if not ok:
        overflow = (int(out.n_dropped_capacity) + int(out.n_dropped_rect)
                    + int(out.n_dropped_tile_overflow))
        blob = {f"arg_{i}": _host(a) for i, a in enumerate(args)}
        blob.update({f"kw_{k}": _host(v) for k, v in kwargs.items()
                     if hasattr(v, "shape")})
        blob["w2c"] = _host(cam.w2c)
        blob["K"] = np.asarray([[float(cam.fx), 0, float(cam.cx)],
                                [0, float(cam.fy), float(cam.cy)],
                                [0, 0, 1]])
        np.savez(snapshot_path, **blob)
        print(f"[render_debug] non-finite output; inputs dumped to "
              f"{snapshot_path} (drop counters: {overflow})")
    return out, ok
