"""Optical-flow priors: warping, composition, flow losses and model flow.

Port of `dynamic3dgaussians_tpu/train/flow.py`:

  * `bilinear_sample` (border clamp), `warp_image`, `compose_flows` and
    `accumulate_flows`: the pseudo-view flow chain's math;
  * `trimmed_mse` and `flow_consistency_loss`: the robust loss against a
    flow prior;
  * `load_flow_npz`: DynIBaR-layout flow files;
  * `render_flow`: dense model flow in ONE render, the per-gaussian screen
    displacement between two projections composited as two extra channels
    (on the card through K1, and K2 when differentiated);
  * `make_torch_raft_flow_fn`: torchvision's RAFT-large as a flow prior,
    only from weights already on disk.

All flows are (H, W, 2) in pixels, flow[y, x] = (dx, dy) mapping frame A
pixel (x, y) to frame B pixel (x + dx, y + dy).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.ops.rasterize import render


def _grid(h: int, w: int, device) -> torch.Tensor:
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([px, py], dim=-1)                      # (H, W, 2)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, C) `img` at float pixel `coords` (..., 2) = (x, y);
    coordinates outside the image clamp to the border."""
    h, w = img.shape[:2]

    def clip(v, hi):
        # jnp.clip's form: on the border itself the gradient is halved, as
        # maximum and minimum split a tie
        return torch.minimum(torch.maximum(v, v.new_tensor(0.0)),
                             v.new_tensor(hi))

    x = clip(coords[..., 0], w - 1.0)
    y = clip(coords[..., 1], h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: out[p] = img[p + flow[p]]."""
    h, w = flow.shape[:2]
    return bilinear_sample(img, _grid(h, w, flow.device) + flow)


def compose_flows(flow_ab: torch.Tensor,
                  flow_bc: torch.Tensor) -> torch.Tensor:
    """a -> b composed with b -> c: f_ac(p) = f_ab(p) + f_bc(p + f_ab(p))."""
    return flow_ab + warp_image(flow_bc, flow_ab)


def accumulate_flows(flows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Chain stepwise flows into one long-range flow."""
    total = flows[0]
    for f in flows[1:]:
        total = compose_flows(total, f)
    return total


def trimmed_mse(err: torch.Tensor, trim: float = 0.1) -> torch.Tensor:
    """Mean of the squared errors without the `trim` share of the largest."""
    se = (err * err).reshape(-1)
    k = max(int(se.shape[0] * (1.0 - trim)), 1)
    return torch.mean(torch.topk(se, k, largest=False).values)


def flow_consistency_loss(model_flow: torch.Tensor, prior_flow: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          trim: float = 0.1) -> torch.Tensor:
    """Trimmed MSE of the end-point error between the model's flow and a
    flow prior, optionally masked."""
    err = torch.linalg.vector_norm(model_flow - prior_flow, dim=-1)
    if mask is not None:
        err = err * mask
    return trimmed_mse(err, trim)


def render_flow(cam, means_t0: torch.Tensor, means_t1: torch.Tensor,
                colors_dummy: torch.Tensor, opacity: torch.Tensor,
                scales: torch.Tensor, rotations: torch.Tensor,
                config=None, method: str = "auto",
                device: DeviceLike = None) -> torch.Tensor:
    """(H, W, 2) model flow from t0 to t1 in ONE render.

    Projects every gaussian at t0 and at t1 with the same camera,
    composites the screen displacement as two extra channels at the t0
    configuration and divides by alpha (floored at 1e-6). Runs on `device`
    (default `cuda`), where `cam` must be.
    """
    dev = resolve_device(device)

    def on_dev(t):
        return torch.as_tensor(t, dtype=torch.float32).to(dev)

    means_t0, means_t1 = on_dev(means_t0), on_dev(means_t1)
    scales, rotations = on_dev(scales), on_dev(rotations)
    p0 = project(means_t0, scales, rotations, cam)
    p1 = project(means_t1, scales, rotations, cam)
    disp = torch.stack([p1.x2d - p0.x2d, p1.y2d - p0.y2d], dim=-1)
    out = render(cam, means_t0, colors_dummy, opacity, scales, rotations,
                 extra_channels=disp, config=config, method=method,
                 device=dev)
    return out.extra / torch.clamp(out.alpha[..., None], min=1e-6)


def load_flow_npz(flow_dir: str, frame_a: int, frame_b: int) -> np.ndarray:
    """DynIBaR-layout flow reader: `{a:05d}_{fwd|bwd}.npz` with key 'flow'
    ((H, W, 2), or channel-first (2, H, W) on disk) -> (H, W, 2) float32."""
    kind = "fwd" if frame_b > frame_a else "bwd"
    data = np.load(os.path.join(flow_dir, f"{frame_a:05d}_{kind}.npz"))
    flow = data["flow"].astype(np.float32)
    if flow.shape[0] == 2:
        flow = flow.transpose(1, 2, 0)
    return flow


def make_torch_raft_flow_fn(weights_path: Optional[str] = None,
                            device: DeviceLike = None) -> Callable:
    """flow_fn(im0, im1) -> (H, W, 2) numpy: torchvision's RAFT-large on
    `device` (default `cuda`), images (H, W, 3) in [0, 1].

    The weights are read from `weights_path`, by default torchvision's
    file in the torch hub cache. Nothing is downloaded: without torchvision
    or the file this raises.
    """
    try:
        from torchvision.models.optical_flow import (Raft_Large_Weights,
                                                     raft_large)
    except ImportError as e:
        raise RuntimeError(f"torchvision RAFT unavailable: {e}") from e
    if weights_path is None:
        url = Raft_Large_Weights.DEFAULT.url
        weights_path = os.path.join(torch.hub.get_dir(), "checkpoints",
                                    os.path.basename(url))
    if not os.path.exists(weights_path):
        raise RuntimeError(f"RAFT weights not on disk at {weights_path}; "
                           f"nothing is downloaded")
    dev = resolve_device(device)
    model = raft_large(weights=None)
    model.load_state_dict(torch.load(weights_path, map_location="cpu",
                                     weights_only=True))
    model = model.eval().to(dev)

    def flow_fn(im0: np.ndarray, im1: np.ndarray) -> np.ndarray:
        def t(im):
            return torch.as_tensor(np.asarray(im, np.float32)).permute(
                2, 0, 1)[None].to(dev) * 2 - 1
        with torch.no_grad():
            pred = model(t(im0), t(im1))[-1][0]
        return pred.permute(1, 2, 0).cpu().numpy()

    return flow_fn
