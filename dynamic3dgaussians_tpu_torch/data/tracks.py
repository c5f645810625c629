"""2D-track -> 3D-track lifting (the Shape-of-Motion data path).

Port of `dynamic3dgaussians_tpu/data/tracks.py` (numpy, the same functions
and outputs): 2D point tracks (TAPIR / CoTracker exports, one
`{query}_{target}.npy` file of (N, 4) [x, y, occ, err] per frame pair)
are lifted per frame through the depth map and camera into world-space 3D
tracks, with per-frame visibility from the tracker's occlusion flag AND a
depth-consistency check, and confidences from the tracker's uncertainty.
They feed `models/motion_bases.py::init_motion_params_with_procrustes`.
A whole (N tracks, T frames) tensor lifts in one gather and matmul pass.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def load_2d_tracks(tracks_dir: str, query_name: str,
                   target_names: Sequence[str]) -> np.ndarray:
    """Stack per-target-frame track files: (N, T, 4) [x, y, occ, err].

    Reference layout (dyn_som.py load_target_tracks):
    `{tracks_dir}/{query}_{target}.npy`, one (N, 4) array per target frame.
    """
    out = []
    for t_name in target_names:
        path = os.path.join(tracks_dir, f"{query_name}_{t_name}.npy")
        out.append(np.load(path).astype(np.float32))
    return np.stack(out, axis=1)


def lift_tracks_to_3d(tracks_2d: np.ndarray,
                      depths: np.ndarray,
                      k: np.ndarray,
                      c2ws: np.ndarray,
                      occ_threshold: float = 0.5,
                      depth_consistency: float = 0.05,
                      err_scale: float = 1.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lift (N, T, >=2) pixel tracks to world 3D via per-frame depth maps.

    Args:
      tracks_2d: (N, T, C) with [:, :, :2] pixel xy; optional channel 2 =
        occlusion logit/flag, channel 3 = uncertainty (CoTracker/TAPIR
        convention the reference consumes).
      depths: (T, H, W) view-space z per frame.
      k: (3, 3) or (T, 3, 3) intrinsics.
      c2ws: (T, 4, 4) camera-to-world matrices.
      depth_consistency: a lifted point is marked invisible in frame t when
        the sampled depth differs from the track neighborhood's bilinear
        blend by more than this RELATIVE amount (occluder test — stands in
        for the reference's visibility refinement).

    Returns:
      (tracks_3d (N, T, 3) world points, visibles (N, T) bool,
       confidences (N, T) in (0, 1]).
    """
    n, t, c = tracks_2d.shape
    th, h, w = depths.shape
    assert th == t, (th, t)
    ks = np.broadcast_to(np.asarray(k, np.float32).reshape(-1, 3, 3),
                         (t, 3, 3))

    xy = tracks_2d[..., :2]
    xi = np.clip(xy[..., 0], 0, w - 1)
    yi = np.clip(xy[..., 1], 0, h - 1)
    x0 = np.clip(np.floor(xi).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(yi).astype(np.int64), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx_ = xi - x0
    fy_ = yi - y0
    tt = np.broadcast_to(np.arange(t)[None, :], (n, t))
    d00 = depths[tt, y0, x0]
    d01 = depths[tt, y0, x1]
    d10 = depths[tt, y1, x0]
    d11 = depths[tt, y1, x1]
    z_blend = ((1 - fy_) * ((1 - fx_) * d00 + fx_ * d01)
               + fy_ * ((1 - fx_) * d10 + fx_ * d11))
    z_near = np.minimum(np.minimum(d00, d01), np.minimum(d10, d11))
    # occluder straddle: a big relative blend/near gap means the bilinear
    # neighborhood crosses a depth edge -> take the near surface, flag it
    straddle = (z_blend - z_near) / np.maximum(z_near, 1e-6) \
        > depth_consistency
    z = np.where(straddle, z_near, z_blend)

    fx = ks[:, 0, 0][None]
    fy = ks[:, 1, 1][None]
    cx = ks[:, 0, 2][None]
    cy = ks[:, 1, 2][None]
    x_cam = (xy[..., 0] - cx) / fx * z
    y_cam = (xy[..., 1] - cy) / fy * z
    pts_cam = np.stack([x_cam, y_cam, z, np.ones_like(z)], axis=-1)
    pts_w = np.einsum("tij,ntj->nti", np.asarray(c2ws, np.float32), pts_cam)
    tracks_3d = pts_w[..., :3]

    in_bounds = ((xy[..., 0] >= 0) & (xy[..., 0] <= w - 1)
                 & (xy[..., 1] >= 0) & (xy[..., 1] <= h - 1))
    # depth-consistency gate: straddling an occluder edge marks the frame
    # invisible (the z_near repair still yields the best-guess 3D point,
    # but it must not enter the Procrustes solve at full weight)
    visibles = in_bounds & (z > 1e-6) & ~straddle
    if c >= 3:
        visibles &= tracks_2d[..., 2] < occ_threshold
    if c >= 4:
        confidences = np.exp(-err_scale *
                             np.maximum(tracks_2d[..., 3], 0.0))
    else:
        confidences = np.ones((n, t), np.float32)
    confidences = np.where(visibles, confidences, 0.0).astype(np.float32)
    return tracks_3d.astype(np.float32), visibles, confidences


def tracks_from_sequence(tracks_dir: str, frame_names: List[str],
                         depths: np.ndarray, k: np.ndarray,
                         c2ws: np.ndarray, num_samples: Optional[int] = None,
                         query_stride: int = 1, seed: int = 0):
    """Full get_tracks_3d pipeline: load per-query-frame 2D tracks, sample,
    lift. Returns concatenated (tracks_3d, visibles, confidences)."""
    rng = np.random.RandomState(seed)
    queries = frame_names[::query_stride]
    per_q = None if num_samples is None else \
        -(-num_samples // len(queries))
    parts = []
    for q in queries:
        t2d = load_2d_tracks(tracks_dir, q, frame_names)
        if per_q is not None and len(t2d) > per_q:
            t2d = t2d[rng.choice(len(t2d), per_q, replace=False)]
        parts.append(lift_tracks_to_3d(t2d, depths, k, c2ws))
    return tuple(np.concatenate(xs, axis=0) for xs in zip(*parts))
