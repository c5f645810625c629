"""The benchmark's inputs, made from `--seed` on the device.

A configuration file (`configs/<name>.json`) fixes the sizes. From the seed
come, in this order and each in one call on the device:

  * the ground-truth scene: `n_gaussians` gaussians uniform in
    [-extent, extent]^3, colours U(0, 1), opacity and scales uniform in
    their ranges, random rotations, a `foreground_share` of them
    foreground, and `semantic_dim` feature channels U(0, 1);
  * the initial cloud the training starts from: the ground-truth points
    moved by N(0, init_noise), with their colours and segmentation;
  * the ground truth at the trained timestep: the foreground turned about
    y and shifted (0.6 rad and (0.35, -0.15, 0) over the sequence),
    rendered by the plain reference (`reference/render.py`) from each of
    `num_cams` cameras on a ring, clipped to [0, 1]; the feature channels
    resized to `feature_hw`.

The cameras are numbers, not draws: a ring of `num_cams` at `ring_radius`
and `ring_height`, looking at the origin, focal `focal`, principal point
at the centre.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import render as R
from portbench.reference.train import normalize

FEATURE_SEED_MIX = 0x5DEECE66D


def ring_cameras(cfg: Dict):
    """[(K 3x3, w2c 4x4)] float64 of the configuration's camera ring."""
    out = []
    f, w, h = cfg["focal"], cfg["width"], cfg["height"]
    for i in range(cfg["num_cams"]):
        a = 2 * np.pi * i / cfg["num_cams"]
        eye = np.array([cfg["ring_radius"] * np.cos(a), cfg["ring_height"],
                        cfg["ring_radius"] * np.sin(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = eye
        k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
        out.append((k, np.linalg.inv(c2w)))
    return out


def scene_radius(w2cs) -> float:
    """1.1 times the cameras' largest distance from their mean centre."""
    centers = np.linalg.inv(np.stack(w2cs))[:, :3, 3]
    return 1.1 * float(np.max(np.linalg.norm(
        centers - centers.mean(0, keepdims=True), axis=-1)))


def foreground_motion(cfg: Dict):
    """(R (3, 3), shift (3,)) of the foreground at the trained timestep."""
    frac = cfg["timestep"] / max(cfg["num_timesteps"] - 1, 1)
    ang = 0.6 * frac
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return rot, np.array([0.35 * frac, -0.15 * frac, 0.0], np.float32)


def make(cfg: Dict, seed: int, device) -> Dict:
    """The seeded inputs both sides receive: cloud (N, 7) [xyz, rgb, seg],
    cams (reference `Cam`s), camera matrices, frames (per camera: im,
    seg, and feature when the configuration has features), scene_radius
    and the seed of the feature initialisation."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    n, e = cfg["n_gaussians"], cfg["extent"]

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    means = uniform(-e, e, (n, 3))
    colors = uniform(0.0, 1.0, (n, 3))
    opac = uniform(*cfg["opacity"], (n,))
    scales = uniform(*cfg["scales"], (n, 3))
    quats = normalize(torch.randn((n, 4), generator=gen, **f32))
    seg = (torch.rand((n,), generator=gen, **f32)
           < cfg["foreground_share"]).to(torch.float32)
    dim = cfg["semantic_dim"]
    feats = uniform(0.0, 1.0, (n, dim)) if dim else None
    noise = cfg["init_noise"] * torch.randn((n, 3), generator=gen, **f32)
    cloud = torch.cat([means + noise, colors, seg[:, None]], -1)

    rot, shift = foreground_motion(cfg)
    rot_t = torch.tensor(rot, **f32)
    moved = torch.where(seg[:, None] > 0.5,
                        means @ rot_t.T + torch.tensor(shift, **f32), means)
    seg_colors = torch.stack([seg, torch.zeros_like(seg), 1 - seg], -1)
    chans = [colors, seg_colors] + ([feats] if dim else [])
    vals = torch.cat(chans, -1)
    mats = ring_cameras(cfg)
    cams, frames = [], []
    with torch.no_grad():
        for k, w2c in mats:
            cam = R.make_cam(k, w2c, cfg["width"], cfg["height"], device)
            img, _ = R.render(moved, scales, quats, opac, vals, cam,
                              cfg["k_slots"], cfg["enum_cap"])
            img = torch.clamp(img, 0.0, 1.0)
            frame = {"im": img[..., :3].contiguous(),
                     "seg": img[..., 3:6].contiguous()}
            if dim:
                frame["feature"] = F.interpolate(
                    img[..., 6:].permute(2, 0, 1)[None],
                    size=tuple(cfg["feature_hw"]), mode="bilinear",
                    align_corners=False, antialias=True)[0].permute(
                        1, 2, 0).contiguous()
            cams.append(cam)
            frames.append(frame)
    return dict(cloud=cloud, cams=cams, mats=mats, frames=frames,
                scene_radius=scene_radius([w for _, w in mats]),
                feature_seed=(int(seed) ^ FEATURE_SEED_MIX) % (2 ** 63))
