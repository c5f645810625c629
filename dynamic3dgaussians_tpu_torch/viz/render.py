"""Offline renders of a checkpoint: per-timestep frames, orbits, GIFs.

Port of the orbit-render part of `dynamic3dgaussians_tpu/viz/render.py`
(the `cli visualize` path). The cached-order playback mode
(resort_every > 1) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.convert import params_from_jax
from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models.gaussians import activated
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, orbit_cameras
from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                        RenderOutput, render)


def params_at_t(stacked: Dict[str, np.ndarray], t: int
                ) -> Dict[str, np.ndarray]:
    """Slice a stacked params.npz dict at timestep t (stacked keys have a
    leading T axis; first-timestep-only keys are shared)."""
    out = {}
    n_t = stacked["means3D"].shape[0] if stacked["means3D"].ndim == 3 else 1
    for k, v in stacked.items():
        if v.ndim >= 2 and v.shape[0] == n_t and stacked["means3D"].ndim == 3:
            out[k] = v[t]
        else:
            out[k] = v
    return out


def render_frame(params_t: Dict[str, np.ndarray], cam: Camera,
                 config: Optional[RasterConfig] = None,
                 bg: Optional[np.ndarray] = None, method: str = "auto",
                 device: DeviceLike = None) -> RenderOutput:
    """Render one checkpointed timestep (seg_colors ride as extra
    channels) on `device` (default `cuda`)."""
    dev = resolve_device(device)
    p = params_from_jax(params_t, dev)
    with torch.no_grad():
        act = activated(p)
        return render(cam, act["means3d"], act["colors"], act["opacity"],
                      act["scales"], act["rotations"],
                      extra_channels=p.get("seg_colors"), bg=bg,
                      config=config, method=method, device=dev)


def to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def colormap_depth(depth, alpha=None, near_clip: float = 1e-6) -> np.ndarray:
    """Depth colormap: normalized un-premultiplied depth -> RGB through a
    fixed piecewise-linear ramp (no matplotlib)."""
    if isinstance(depth, torch.Tensor):
        depth = depth.detach().cpu().numpy()
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.detach().cpu().numpy()
    d = np.asarray(depth, np.float64)
    a = np.ones_like(d) if alpha is None else np.asarray(alpha)
    valid = a > 0.5
    dn = d / np.maximum(a, near_clip)
    if valid.any():
        lo, hi = np.percentile(dn[valid], [2, 98])
    else:
        lo, hi = 0.0, 1.0
    x = np.clip((dn - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * x - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * x - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * x - 0.5), 0, 1)
    rgb = np.stack([r, g, b], -1)
    rgb[~valid] = 0
    return (rgb * 255).astype(np.uint8)


def orbit_render(stacked: Dict[str, np.ndarray], n_frames: int = 60,
                 w: int = 640, h: int = 360, f: float = 500.0,
                 radius: float = 4.0, height: float = -1.0,
                 timestep_per_frame: bool = True,
                 config: Optional[RasterConfig] = None,
                 method: str = "auto", resort_every: int = 1,
                 device: DeviceLike = None) -> List[np.ndarray]:
    """360-degree orbit of the scene, cycling timesteps; uint8 RGB frames."""
    if resort_every != 1:
        raise NotImplementedError(
            "resort_every > 1 (cached-order playback) is not ported yet; "
            "use resort_every=1")
    dev = resolve_device(device)
    num_t = stacked["means3D"].shape[0] if stacked["means3D"].ndim == 3 else 1
    center = np.asarray(stacked["means3D"]).reshape(-1, 3).mean(0)
    cams = orbit_cameras(center, radius, height, n_frames, w, h, f,
                         device=dev)
    frames = []
    for i, cam in enumerate(cams):
        t = (i % num_t) if timestep_per_frame else 0
        out = render_frame(params_at_t(stacked, t), cam, config=config,
                           method=method, device=dev)
        frames.append(to_uint8(out.rgb))
    return frames


def save_gif(frames: List[np.ndarray], path: str, fps: int = 20) -> str:
    from PIL import Image
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return path
