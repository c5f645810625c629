"""Initial point-cloud construction strategies (the --init_type family).

Port of `dynamic3dgaussians_tpu/data/init_clouds.py` (numpy, the same
functions and outputs). Three primitives:

  * `from_depth_maps`: unproject per-camera depth maps into one coloured
    world point cloud (the depth-fusion path)
  * `densify_with_noise`: jittered copies around existing points
  * `from_checkpoint`: seed from a previous run's params.npz

plus `merge_clouds` and `subsample` for the fused variants, dispatched by
`build_init_cloud`. Every function returns the (N, 7) [xyz rgb seg] layout
of init_pt_cld.npz.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def from_depth_maps(depths: Sequence[np.ndarray],
                    rgbs: Sequence[np.ndarray],
                    ks: Sequence[np.ndarray],
                    w2cs: Sequence[np.ndarray],
                    segs: Optional[Sequence[np.ndarray]] = None,
                    stride: int = 4,
                    max_depth: float = 1e6) -> np.ndarray:
    """Unproject per-camera depth maps into one (N, 7) world point cloud."""
    clouds = []
    for i, (d, im, k, w2c) in enumerate(zip(depths, rgbs, ks, w2cs)):
        d = np.asarray(d, np.float64)[::stride, ::stride]
        im = np.asarray(im, np.float64)[::stride, ::stride]
        h, w = d.shape
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        ys = ys * stride + 0.5
        xs = xs * stride + 0.5
        k = np.asarray(k, np.float64)
        x = (xs - k[0][2]) / k[0][0] * d
        y = (ys - k[1][2]) / k[1][1] * d
        pts_cam = np.stack([x, y, d], axis=-1).reshape(-1, 3)
        valid = (d.reshape(-1) > 1e-6) & (d.reshape(-1) < max_depth)
        c2w = np.linalg.inv(np.asarray(w2c, np.float64))
        pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
        seg = (np.asarray(segs[i], np.float64)[::stride, ::stride]
               .reshape(-1, 1) if segs is not None
               else np.zeros((pts.shape[0], 1)))
        cloud = np.concatenate([pts, im.reshape(-1, 3), seg], axis=1)
        clouds.append(cloud[valid])
    return np.concatenate(clouds, axis=0).astype(np.float32)


def densify_with_noise(pt_cld: np.ndarray, factor: int = 2,
                       sigma: float = 0.01, seed: int = 0) -> np.ndarray:
    """Add `factor-1` noise-jittered copies of every point (ssd_train noise
    densification): positions jittered, colors/seg copied."""
    if factor <= 1:
        return pt_cld
    rng = np.random.RandomState(seed)
    extras = []
    for _ in range(factor - 1):
        e = pt_cld.copy()
        e[:, :3] += rng.normal(0, sigma, (pt_cld.shape[0], 3))
        extras.append(e)
    return np.concatenate([pt_cld] + extras, axis=0).astype(np.float32)


def from_checkpoint(params_npz: Dict[str, np.ndarray],
                    t: int = 0) -> np.ndarray:
    """(N, 7) cloud from a saved params.npz (checkpoint-initialized restart,
    dyn_utils.py:300-312)."""
    means = np.asarray(params_npz["means3D"])
    cols = np.asarray(params_npz["rgb_colors"])
    if means.ndim == 3:
        means, cols = means[t], cols[t] if cols.ndim == 3 else cols
    seg = np.asarray(params_npz.get(
        "seg_colors", np.zeros((means.shape[0], 3))))
    if seg.ndim == 3:
        seg = seg[0]
    return np.concatenate([means, cols, seg[:, :1]],
                          axis=1).astype(np.float32)


def merge_clouds(clouds: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(clouds, axis=0).astype(np.float32)


def subsample(pt_cld: np.ndarray, max_points: int,
              seed: int = 0) -> np.ndarray:
    if pt_cld.shape[0] <= max_points:
        return pt_cld
    idx = np.random.RandomState(seed).choice(pt_cld.shape[0], max_points,
                                             replace=False)
    return pt_cld[idx]


def build_init_cloud(init_type: str, *, pt_cld: Optional[np.ndarray] = None,
                     depth_frames: Optional[Dict] = None,
                     checkpoint: Optional[Dict] = None,
                     noise_factor: int = 2, noise_sigma: float = 0.01,
                     max_points: Optional[int] = None,
                     seed: int = 0) -> np.ndarray:
    """Dispatch matching ssd_train.py's --init_type flag.

    init_type: 'pcd' (given cloud as-is), 'noise' (cloud + jittered copies),
    'depth' (unprojected depth maps), 'checkpoint', 'fused' (depth + cloud).
    """
    if init_type == "pcd":
        out = pt_cld
    elif init_type == "noise":
        out = densify_with_noise(pt_cld, noise_factor, noise_sigma, seed)
    elif init_type == "depth":
        out = from_depth_maps(**depth_frames)
    elif init_type == "checkpoint":
        out = from_checkpoint(checkpoint)
    elif init_type == "fused":
        out = merge_clouds([pt_cld, from_depth_maps(**depth_frames)])
    else:
        raise ValueError(f"unknown init_type: {init_type}")
    if max_points:
        out = subsample(out, max_points, seed)
    return out
