"""Offline renders of a checkpoint: frames, orbits, GIFs, overlays.

Port of `dynamic3dgaussians_tpu/viz/render.py`: per-timestep frames, the
orbit of `cli visualize` (exact per frame, or through the cached-order
playback of `ops/playback.py` with resort_every > 1), depth colormaps,
trajectory tails and rotation whiskers as 3D line segments drawn into
uint8 frames, the lift of an RGB-D render to a point cloud, and the
wall-clock-paced timestep playback generator.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.convert import params_from_jax
from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models.gaussians import activated
from dynamic3dgaussians_tpu_torch.ops import quat as Q
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, orbit_cameras
from dynamic3dgaussians_tpu_torch.ops.playback import (PlaybackCache,
                                                       build_cache,
                                                       render_playback)
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


def playback_frame(params_t: Dict[str, np.ndarray], cam: Camera,
                   cache: Optional[PlaybackCache],
                   config: Optional[RasterConfig] = None,
                   device: DeviceLike = None
                   ) -> Tuple[RenderOutput, PlaybackCache]:
    """Render one checkpointed timestep through a playback cache on
    `device` (default `cuda`); cache None builds one at `cam` first.
    Returns the frame and the cache it went through."""
    dev = resolve_device(device)
    p = params_from_jax(params_t, dev)
    with torch.no_grad():
        act = activated(p)
    if cache is None:
        cache = build_cache(cam, act["means3d"], act["opacity"],
                            act["scales"], act["rotations"], config=config,
                            device=dev)
    out = render_playback(cam, act["means3d"], act["colors"],
                          act["opacity"], act["scales"], act["rotations"],
                          cache, config=config,
                          extra_channels=p.get("seg_colors"), device=dev)
    return out, cache


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(img) -> np.ndarray:
    img = _np(img)
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def colormap_depth(depth, alpha=None, near_clip: float = 1e-6) -> np.ndarray:
    """Depth colormap: normalized un-premultiplied depth -> RGB through a
    fixed piecewise-linear ramp (no matplotlib)."""
    d = np.asarray(_np(depth), np.float64)
    a = np.ones_like(d) if alpha is None else _np(alpha)
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
    """360-degree orbit of the scene, cycling timesteps; uint8 RGB frames.

    resort_every > 1 renders through the cached-order playback path
    (`ops/playback.py`, K1 through a frozen order; `method` is then not
    used): the cache is rebuilt on every timestep change, since scene
    motion between timesteps is unbounded, and after `resort_every`
    frames. An orbit that changes timestep every frame therefore rebuilds
    every frame, as in the reference.
    """
    dev = resolve_device(device)
    num_t = stacked["means3D"].shape[0] if stacked["means3D"].ndim == 3 else 1
    center = np.asarray(stacked["means3D"]).reshape(-1, 3).mean(0)
    cams = orbit_cameras(center, radius, height, n_frames, w, h, f,
                         device=dev)
    frames = []
    cache, cache_t, since_sort = None, None, 0
    for i, cam in enumerate(cams):
        t = (i % num_t) if timestep_per_frame else 0
        pt = params_at_t(stacked, t)
        if resort_every > 1:
            if t != cache_t or since_sort >= resort_every:
                cache, cache_t, since_sort = None, t, 0
            out, cache = playback_frame(pt, cam, cache, config=config,
                                        device=dev)
            since_sort += 1
        else:
            out = render_frame(pt, cam, config=config, method=method,
                               device=dev)
        frames.append(to_uint8(out.rgb))
    return frames


def save_gif(frames: List[np.ndarray], path: str, fps: int = 20) -> str:
    from PIL import Image
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return path


def _foreground(stacked, fg_thresh):
    seg = np.asarray(stacked["seg_colors"])
    return seg[..., 0] > fg_thresh if seg.ndim == 2 \
        else seg[0, :, 0] > fg_thresh


def trajectory_lines(stacked: Dict[str, np.ndarray], t: int,
                     traj_length: int = 15, stride: int = 25,
                     fg_thresh: float = 0.5) -> np.ndarray:
    """Foreground trajectory tails as (S, 2, 3) line segments: every
    `stride`-th foreground point over the last `traj_length` timesteps."""
    means = np.asarray(stacked["means3D"])         # (T, N, 3)
    pts = means[:, _foreground(stacked, fg_thresh)][:, ::stride]
    segs = [np.stack([pts[a], pts[a + 1]], axis=1)
            for a in range(max(0, t - traj_length), t)]
    return np.concatenate(segs, axis=0) if segs else np.zeros((0, 2, 3))


def rotation_vector_lines(stacked: Dict[str, np.ndarray], t: int,
                          length: float = 0.05, stride: int = 25,
                          fg_thresh: float = 0.5) -> np.ndarray:
    """Orientation whiskers as (S, 2, 3) line segments: a fixed offset
    rotated by the relative quaternion between t = 0 and t, anchored at
    the centres at t."""
    means = np.asarray(stacked["means3D"])          # (T, N, 3)
    rots = np.asarray(stacked["unnorm_rotations"])  # (T, N, 4)
    sel = np.where(_foreground(stacked, fg_thresh))[0][::stride]
    q_t = rots[t, sel] / np.maximum(
        np.linalg.norm(rots[t, sel], axis=-1, keepdims=True), 1e-9)
    q_0 = rots[0, sel] / np.maximum(
        np.linalg.norm(rots[0, sel], axis=-1, keepdims=True), 1e-9)
    rel = Q.quat_mult(torch.as_tensor(q_t), Q.conjugate(torch.as_tensor(q_0)))
    rot = Q.quat_to_rotmat(rel).numpy()
    offset = rot @ np.array([0.0, 0.0, length], np.float64)
    starts = means[t, sel]
    return np.stack([starts, starts + offset], axis=1)


def rgbd_to_pointcloud(rgb, depth, k, alpha=None, c2w=None,
                       alpha_thresh: float = 0.5):
    """Lift a rendered RGB-D image to a coloured point cloud: the
    un-premultiplied depth along each pixel's ray through the inverse
    intrinsics. Returns (points (M, 3), colors (M, 3)) as numpy."""
    depth = _np(depth)
    h, w = depth.shape
    a = np.ones_like(depth) if alpha is None else _np(alpha)
    z = depth / np.maximum(a, 1e-6)
    k = _np(k)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    x = (xs - k[0][2]) / k[0][0] * z
    y = (ys - k[1][2]) / k[1][1] * z
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    cols = _np(rgb).reshape(-1, 3)
    keep = (a > alpha_thresh).reshape(-1)
    pts, cols = pts[keep], cols[keep]
    if c2w is not None:
        c2w = _np(c2w)
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    return pts, cols


def draw_lines(img: np.ndarray, segments: np.ndarray, cam: Camera,
               color=(255, 60, 60)) -> np.ndarray:
    """Project 3D line segments into a copy of a uint8 image and draw
    them."""
    out = img.copy()
    h, w = out.shape[:2]
    w2c = _np(cam.w2c)
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)

    def proj(p):
        v = w2c[:3, :3] @ p + w2c[:3, 3]
        if v[2] <= 1e-6:
            return None
        return np.array([v[0] / v[2] * fx + cx, v[1] / v[2] * fy + cy])

    for a, b in segments:
        pa, pb = proj(a), proj(b)
        if pa is None or pb is None:
            continue
        n = int(max(abs(pb - pa).max(), 1)) + 1
        ts = np.linspace(0, 1, n)
        xs = np.clip((pa[0] + (pb[0] - pa[0]) * ts).astype(int), 0, w - 1)
        ys = np.clip((pa[1] + (pb[1] - pa[1]) * ts).astype(int), 0, h - 1)
        out[ys, xs] = color
    return out


def playback(stacked: Dict[str, np.ndarray], cam: Camera, fps: float = 20.0,
             mode: str = "color", show_trajectories: bool = False,
             show_rotations: bool = False,
             config: Optional[RasterConfig] = None,
             max_frames: Optional[int] = None, realtime: bool = False):
    """Generator of one uint8 frame per timestep, paced at `fps` when
    `realtime` (sleeping only then); `mode` is "color", "depth" or
    "centers". Renders on the camera's device."""
    num_t = stacked["means3D"].shape[0] if stacked["means3D"].ndim == 3 else 1
    n = num_t if max_frames is None else min(num_t, max_frames)
    period = 1.0 / fps
    nxt = time.perf_counter()
    for t in range(n):
        out = render_frame(params_at_t(stacked, t), cam, config=config,
                           device=cam.device)
        if mode == "depth":
            frame = colormap_depth(out.depth, out.alpha)
        elif mode == "centers":
            pts = np.asarray(stacked["means3D"])
            pts_t = pts[t] if pts.ndim == 3 else pts
            segs = np.stack([pts_t, pts_t + 1e-4], axis=1)
            frame = draw_lines(
                np.zeros((cam.height, cam.width, 3), np.uint8), segs, cam,
                color=(220, 220, 220))
        else:
            frame = to_uint8(out.rgb)
        if show_trajectories and stacked["means3D"].ndim == 3:
            frame = draw_lines(frame, trajectory_lines(stacked, t), cam)
        if show_rotations and stacked["means3D"].ndim == 3:
            frame = draw_lines(frame, rotation_vector_lines(stacked, t),
                               cam, color=(60, 120, 255))
        if realtime:
            nxt += period
            delay = nxt - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        yield frame
