"""Synthetic dynamic gaussian scenes: ground truth for tests and benchmarks.

Port of `dynamic3dgaussians_tpu/data/synthetic.py`: a ground-truth gaussian
scene (a static background shell and a rigidly moving foreground cluster),
rendered with the port's own `render` into images and segmentation per
timestep, and written to disk in the reference data layout. The scene
statistics are numpy from a seed, identical to the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, orbit_cameras
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render


def make_gt_scene(n_fg: int = 120, n_bg: int = 300, seed: int = 0):
    """Ground-truth gaussians: a cluster near the origin, a shell around."""
    rng = np.random.RandomState(seed)
    fg = rng.normal(0, 0.35, (n_fg, 3))
    theta = rng.uniform(0, 2 * np.pi, n_bg)
    phi = np.arccos(rng.uniform(-1, 1, n_bg))
    r = rng.uniform(1.8, 2.2, n_bg)
    bg = np.stack([r * np.sin(phi) * np.cos(theta),
                   r * np.sin(phi) * np.sin(theta) * 0.5,
                   r * np.cos(phi)], axis=-1)
    means = np.concatenate([fg, bg]).astype(np.float32)
    n = n_fg + n_bg
    colors = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.6, 0.95, (n,)).astype(np.float32)
    scales = np.concatenate([
        rng.uniform(0.04, 0.10, (n_fg, 3)),
        rng.uniform(0.08, 0.20, (n_bg, 3))]).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = np.concatenate([np.ones(n_fg), np.zeros(n_bg)]).astype(np.float32)
    return dict(means=means, colors=colors, opac=opac, scales=scales,
                quats=quats, seg=seg, n_fg=n_fg)


def animate(scene: Dict, t: int, num_t: int) -> np.ndarray:
    """Rigid foreground motion: translate and rotate about y over time."""
    means = scene["means"].copy()
    n_fg = scene["n_fg"]
    frac = t / max(num_t - 1, 1)
    ang = 0.6 * frac
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    shift = np.array([0.35 * frac, -0.15 * frac, 0.0], np.float32)
    means[:n_fg] = scene["means"][:n_fg] @ R.T + shift
    return means


def make_dataset(scene: Dict, num_t: int, num_cams: int = 6,
                 w: int = 128, h: int = 96, f: float = 110.0,
                 raster_cfg: Optional[RasterConfig] = None,
                 radius: float = 4.0, device: DeviceLike = None
                 ) -> Tuple[List[List[Dict]], np.ndarray, List[Camera]]:
    """Render the ground truth per timestep into trainer datapoints on
    `device` (default `cuda`), seen by `num_cams` cameras on an orbit of
    `radius` around the origin.

    Returns (dataset[t][c] dicts, w2c_stack (C, 4, 4), cameras).
    """
    dev = resolve_device(device)
    cfg = raster_cfg or RasterConfig(max_tiles_per_gaussian=64)
    cams = orbit_cameras(center=(0.0, 0.0, 0.0), radius=radius, height=-1.0,
                         n=num_cams, w=w, h=h, f=f, device=dev)
    w2c_stack = np.stack([c.w2c.cpu().numpy() for c in cams])
    seg = scene["seg"]
    seg_colors = torch.as_tensor(
        np.stack([seg, np.zeros_like(seg), 1 - seg], -1), device=dev)
    fixed = {k: torch.as_tensor(scene[k], device=dev)
             for k in ("colors", "opac", "scales", "quats")}
    dataset: List[List[Dict]] = []
    with torch.no_grad():
        for t in range(num_t):
            means = torch.as_tensor(animate(scene, t, num_t), device=dev)
            frames = []
            for ci, cam in enumerate(cams):
                out = render(cam, means, fixed["colors"], fixed["opac"],
                             fixed["scales"], fixed["quats"],
                             extra_channels=seg_colors, config=cfg,
                             device=dev)
                frames.append({
                    "camera": cam,
                    "im": torch.clamp(out.rgb, 0.0, 1.0),
                    "seg": torch.clamp(out.extra, 0.0, 1.0),
                    "cam_id": ci,
                })
            dataset.append(frames)
    return dataset, w2c_stack, cams


def init_point_cloud(scene: Dict, noise: float = 0.03, seed: int = 1
                     ) -> np.ndarray:
    """(N, 7) [xyz rgb seg] initial cloud: the ground-truth points
    perturbed."""
    rng = np.random.RandomState(seed)
    xyz = scene["means"] + rng.normal(0, noise, scene["means"].shape)
    return np.concatenate([
        xyz, scene["colors"], scene["seg"][:, None]], axis=-1
    ).astype(np.float32)


def write_reference_layout(out_root: str, seq: str, num_t: int,
                           num_cams: int = 6, w: int = 128, h: int = 96,
                           f: float = 110.0, scene: Optional[Dict] = None,
                           radius: float = 4.0,
                           device: DeviceLike = None) -> str:
    """Write the synthetic scene to disk in the reference data layout:

      <root>/<seq>/train_meta.json   md["fn"|"hw"|"k"|"w2c"][t][c]
      <root>/<seq>/ims/<c>/<t>.jpg   RGB frames
      <root>/<seq>/seg/<c>/<t>.png   {0,1} dynamic masks
      <root>/<seq>/init_pt_cld.npz   {"data": (N, 7) [xyz rgb seg]}

    so that `cli train` reads it as it reads a captured sequence. Renders
    on `device` (default `cuda`); returns <root>/<seq>.
    """
    from PIL import Image

    scene = scene or make_gt_scene()
    dataset, w2c_stack, _ = make_dataset(scene, num_t, num_cams=num_cams,
                                         w=w, h=h, f=f, radius=radius,
                                         device=device)
    base = os.path.join(out_root, seq)
    k_mat = [[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]]
    md = {"fn": [], "hw": [[h, w]] * num_cams, "k": [], "w2c": []}
    for t in range(num_t):
        fns, ks, w2cs = [], [], []
        for c, frame in enumerate(dataset[t]):
            fn = f"{c}/{t:06d}.jpg"
            fns.append(fn)
            ks.append(k_mat)
            w2cs.append(np.asarray(w2c_stack[c], np.float64).tolist())
            im8 = (frame["im"].cpu().numpy() * 255).astype(np.uint8)
            seg8 = ((frame["seg"][..., 0] > 0.5).cpu().numpy()
                    * 255).astype(np.uint8)
            im_path = os.path.join(base, "ims", fn)
            seg_path = os.path.join(base, "seg", fn.replace(".jpg", ".png"))
            os.makedirs(os.path.dirname(im_path), exist_ok=True)
            os.makedirs(os.path.dirname(seg_path), exist_ok=True)
            Image.fromarray(im8).save(im_path, quality=95)
            Image.fromarray(seg8).save(seg_path)
        md["fn"].append(fns)
        md["k"].append(ks)
        md["w2c"].append(w2cs)
    with open(os.path.join(base, "train_meta.json"), "w") as fh:
        json.dump(md, fh)
    np.savez(os.path.join(base, "init_pt_cld.npz"),
             data=init_point_cloud(scene))
    return base
