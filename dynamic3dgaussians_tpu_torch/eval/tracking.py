"""Dense 6-DOF tracking from the persistent dynamic gaussians.

Port of `dynamic3dgaussians_tpu/eval/tracking.py`. The same gaussians
persist over the timesteps with per-timestep means and rotations, so a
query point tracks through time by attaching it to its k nearest
foreground gaussians at t = 0 and replaying their rigid motion:

  * attach: weights exp(-d^2 / (2 sigma^2)), sigma^2 by default the median
    of the k squared distances (for an even k the mean of the middle two,
    as `jnp.median` takes it, not torch.median's lower one), and the query
    offset in each gaussian's local frame;
  * replay: x_q(t) = sum_i w_i [mu_i(t) + R_i(t) R_i(0)^T (x_q(0) - mu_i(0))];
  * rotations: the weighted relative rotation of the attached gaussians;
  * pixels: `track_pixels` renders t = 0 once through `render_frame` (the
    forward tile kernel on the card) to lift the query pixels by their
    depth, then projects the replayed tracks through the camera.

Tensors over the stacked params.npz layout, on the queries' device;
O(T * Q * k). Products run with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import (DeviceLike, no_tf32,
                                                 resolve_device)
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.camera import Camera


def _as_stacked(stacked: Dict, device) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    means = t(stacked["means3D"])                    # (T, N, 3)
    rots = t(stacked["unnorm_rotations"])            # (T, N, 4)
    seg = t(stacked["seg_colors"])
    if seg.dim() == 3:
        seg = seg[0]
    return means, quat.normalize(rots), seg[:, 0] > 0.5


def _median_lastdim(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis (keepdims): the linear interpolation
    of the sorted middle pair, i.e. their mean for an even length."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    q = 0.5 * (n - 1)
    lo = int(np.floor(q))
    hi_w = q - lo
    hi = min(lo + 1, n - 1)
    return (s[..., lo:lo + 1] * (1.0 - hi_w) + s[..., hi:hi + 1] * hi_w)


def attach_queries(means0: torch.Tensor, rots0: torch.Tensor,
                   is_fg: torch.Tensor, queries: torch.Tensor, k: int = 8,
                   sigma: Optional[float] = None):
    """Attach (Q, 3) query points to their k nearest foreground gaussians
    at t = 0. Returns (indices (Q, k), weights (Q, k), local offsets
    (Q, k, 3))."""
    d2 = torch.sum((queries[:, None, :] - means0[None, :, :]) ** 2, -1)
    d2 = torch.where(is_fg[None, :], d2, torch.full_like(d2, float("inf")))
    dk2, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    if sigma is None:
        # adaptive: the median neighbour distance of each query
        sig2 = torch.clamp(_median_lastdim(dk2), min=1e-12)
    else:
        sig2 = torch.tensor(sigma, dtype=torch.float32,
                            device=queries.device) ** 2
    w = torch.exp(-dk2 / (2.0 * sig2))
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    mu = means0[idx]                                  # (Q, k, 3)
    r0 = quat.quat_to_rotmat(rots0[idx], normalized=True)   # (Q, k, 3, 3)
    with no_tf32():
        local = torch.einsum("qkij,qki->qkj", r0, queries[:, None, :] - mu)
    return idx, w, local


def track_points_3d(stacked: Dict, queries: torch.Tensor, k: int = 8,
                    sigma: Optional[float] = None) -> torch.Tensor:
    """(T, Q, 3) world trajectories of (Q, 3) query points at t = 0."""
    means, rots, is_fg = _as_stacked(stacked, queries.device)
    idx, w, local = attach_queries(means[0], rots[0], is_fg, queries, k=k,
                                   sigma=sigma)
    r = quat.quat_to_rotmat(rots[:, idx], normalized=True)  # (T, Q, k, 3, 3)
    with no_tf32():
        cand = means[:, idx] + torch.einsum("tqkij,qkj->tqki", r, local)
    return torch.sum(w[None, ..., None] * cand, dim=2)


def track_rotations(stacked: Dict, queries: torch.Tensor, k: int = 8,
                    sigma: Optional[float] = None) -> torch.Tensor:
    """(T, Q, 4) unit quaternions: the blended relative rotation of each
    query (the rotational half of the 6-DOF track)."""
    means, rots, is_fg = _as_stacked(stacked, queries.device)
    idx, w, _ = attach_queries(means[0], rots[0], is_fg, queries, k=k,
                               sigma=sigma)
    inv0 = quat.conjugate(rots[0][idx])               # (Q, k, 4)
    rel = quat.quat_mult(rots[:, idx], inv0)          # (T, Q, k, 4)
    # hemisphere-align to the first (nearest) neighbour, then weigh
    ref = rel[:, :, :1, :]
    sign = torch.where(torch.sum(rel * ref, -1, keepdim=True) < 0, -1.0, 1.0)
    q = torch.sum(w[None, ..., None] * rel * sign, dim=2)
    return quat.normalize(q)


def project_tracks(tracks_3d: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(T, Q, 3) world tracks -> (T, Q, 2) pixel tracks through `cam`."""
    v = cam.w2c
    with no_tf32():
        p = tracks_3d @ v[:3, :3].T + v[:3, 3]
    z = torch.clamp(p[..., 2], min=1e-8)
    u = p[..., 0] / z * cam.fx + cam.cx
    vv = p[..., 1] / z * cam.fy + cam.cy
    return torch.stack([u, vv], dim=-1)


def unproject_queries(px: torch.Tensor, depth: torch.Tensor,
                      alpha: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(Q, 2) pixel queries and the rendered depth and alpha at t = 0 ->
    (Q, 3) world points, at the un-premultiplied depth (depth / alpha) of
    the pixel each query falls in (coordinates truncated toward zero)."""
    xi = torch.clamp(px[:, 0].to(torch.int32), 0, cam.width - 1).long()
    yi = torch.clamp(px[:, 1].to(torch.int32), 0, cam.height - 1).long()
    z = depth[yi, xi] / torch.clamp(alpha[yi, xi], min=1e-6)
    x = (px[:, 0] - cam.cx) / cam.fx * z
    y = (px[:, 1] - cam.cy) / cam.fy * z
    p_cam = torch.stack([x, y, z], dim=-1)
    with no_tf32():
        c2w = torch.linalg.inv(cam.w2c)
        return p_cam @ c2w[:3, :3].T + c2w[:3, 3]


def track_pixels(stacked: Dict, cam: Camera, px_queries, k: int = 8,
                 render_config=None, method: str = "auto",
                 device: DeviceLike = None) -> torch.Tensor:
    """(Q, 2) pixels at t = 0 -> (T, Q, 2) pixel tracks in `cam`, on
    `device` (default `cuda`). Renders t = 0 once for the depth lift, then
    replays the gaussians' motion; score against keypoints with
    `eval.metrics.pck`."""
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame)
    dev = resolve_device(device)
    px = torch.as_tensor(np.asarray(px_queries, np.float32), device=dev) \
        if not isinstance(px_queries, torch.Tensor) else px_queries.to(dev)
    out = render_frame(params_at_t(stacked, 0), cam, config=render_config,
                       method=method, device=dev)
    q3 = unproject_queries(px, out.depth, out.alpha, cam)
    tracks = track_points_3d(stacked, q3, k=k)
    return project_tracks(tracks, cam)
