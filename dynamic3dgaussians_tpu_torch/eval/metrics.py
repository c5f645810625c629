"""Evaluation metrics: masked PSNR and SSIM, PCK, mask IoU, depth and pose
errors.

Port of `dynamic3dgaussians_tpu/eval/metrics.py`, every function: the image
metrics in PyTorch on the images' device, the pose errors (`ate`, `rpe`)
in numpy. Images are channels-last (H, W, C) float in [0, 1].
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops import ssim as ssim_mod
from dynamic3dgaussians_tpu_torch.ops.ssim import calc_ssim


def masked_psnr(pred, gt, mask: Optional[torch.Tensor] = None,
                max_val: float = 1.0) -> torch.Tensor:
    """PSNR over the (optionally masked) pixels."""
    se = (pred - gt) ** 2
    if mask is not None:
        m = mask[..., None] if mask.dim() == se.dim() - 1 else mask
        m = m.to(se.dtype)
        mse = torch.sum(se * m) / torch.clamp(
            torch.sum(m.expand(se.shape)), min=1.0)
    else:
        mse = torch.mean(se)
    # a true division (a number over a tensor is a reciprocal in torch)
    return 20.0 * torch.log10(torch.full_like(mse, max_val) / torch.sqrt(
        torch.clamp(mse, min=1e-12)))


def masked_ssim(pred, gt, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """SSIM; with a mask, the pixels outside it take gt's values (so they
    score 1) and the mean runs over the masked pixels only (mSSIM)."""
    if mask is None:
        return calc_ssim(pred, gt)
    m = mask[..., None].to(pred.dtype)
    pred_m = pred * m + gt * (1 - m)
    win = ssim_mod._gaussian_window(11, 1.5)

    def blur(x):     # (H, W, C) through the channel-major blur
        return ssim_mod._blur_chw(x.permute(2, 0, 1), win).permute(1, 2, 0)

    mu1, mu2 = blur(pred_m), blur(gt)
    s1 = blur(pred_m * pred_m) - mu1 ** 2
    s2 = blur(gt * gt) - mu2 ** 2
    s12 = blur(pred_m * gt) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    # mean over the masked pixels and the channels (m is (H, W, 1))
    n_chan = pred.shape[-1]
    return torch.sum(smap * m) / torch.clamp(torch.sum(m) * n_chan, min=1.0)


def pck(pred_kps, gt_kps, img_wh, ratio: float = 0.05,
        reduce: str = "mean") -> torch.Tensor:
    """Percentage of correct keypoints at ratio * max(W, H) pixels.

    pred_kps / gt_kps: (..., K, 2) pixel coordinates.
    """
    thresh = ratio * max(img_wh)
    dist = torch.linalg.norm(pred_kps - gt_kps, dim=-1)
    correct = (dist < thresh).to(torch.float32)
    return torch.mean(correct) if reduce == "mean" else correct


def mask_iou(pred_mask, gt_mask, thresh: float = 0.5) -> torch.Tensor:
    """Binary mask IoU."""
    p = pred_mask > thresh
    g = gt_mask > thresh
    inter = torch.sum(p & g)
    union = torch.sum(p | g)
    return inter / torch.clamp(union, min=1)


def depth_abs_rel(pred_depth, gt_depth, mask=None) -> torch.Tensor:
    """mean |pred - gt| / gt over the valid (gt > 0) pixels."""
    valid = gt_depth > 1e-6
    if mask is not None:
        valid = valid & (mask > 0.5)
    rel = torch.abs(pred_depth - gt_depth) / torch.clamp(gt_depth, min=1e-6)
    return torch.sum(torch.where(valid, rel, torch.zeros_like(rel))) / \
        torch.clamp(torch.sum(valid), min=1)


# ---------- pose metrics (numpy; offline evaluation)

def ate(pred_c2w: np.ndarray, gt_c2w: np.ndarray) -> float:
    """Absolute trajectory error after aligning the translations' means."""
    p = pred_c2w[:, :3, 3]
    g = gt_c2w[:, :3, 3]
    p = p - p.mean(0)
    g = g - g.mean(0)
    return float(np.sqrt(((p - g) ** 2).sum(-1).mean()))


def rpe(pred_c2w: np.ndarray, gt_c2w: np.ndarray):
    """Relative pose errors (translation, rotation in degrees) between
    consecutive frames."""
    def rel(seq):
        return np.linalg.inv(seq[:-1]) @ seq[1:]
    dp = rel(pred_c2w)
    dg = rel(gt_c2w)
    err = np.linalg.inv(dg) @ dp
    t_err = np.linalg.norm(err[:, :3, 3], axis=-1)
    cos = (np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2
    r_err = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    return float(t_err.mean()), float(r_err.mean())


def lpips(pred, gt, feature_fn: Optional[Callable] = None) -> torch.Tensor:
    """LPIPS-style distance given a feature extractor
    `feature_fn(img) -> list of (H', W', C') feature maps`; raises without
    one (the trained AlexNet metric is `eval/lpips.py`)."""
    if feature_fn is None:
        raise ValueError(
            "lpips needs a feature_fn (no pretrained AlexNet is bundled); "
            "see eval/lpips.py for the AlexNet tower")
    fp, fg = feature_fn(pred), feature_fn(gt)
    dists = []
    for a, b in zip(fp, fg):
        a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                            min=1e-10)
        b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                            min=1e-10)
        dists.append(torch.mean(torch.sum((a - b) ** 2, dim=-1)))
    return torch.mean(torch.stack(dists))


def unproject_image(depth: torch.Tensor, k: torch.Tensor,
                    c2w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lift a (H, W) view-depth map to (H, W, 3) points through the (3, 3)
    intrinsics `k`; with `c2w`, in world space."""
    h, w = depth.shape
    ys = torch.arange(h, dtype=torch.float32, device=depth.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=depth.device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    x = (px - k[0, 2]) / k[0, 0] * depth
    y = (py - k[1, 2]) / k[1, 1] * depth
    pts = torch.stack([x, y, depth], dim=-1)
    if c2w is not None:
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    return pts


def reproject_points(pts_world: torch.Tensor, k: torch.Tensor,
                     w2c: torch.Tensor):
    """World points -> (pixel xy, view z) in the camera (k, w2c)."""
    pv = pts_world @ w2c[:3, :3].T + w2c[:3, 3]
    z = torch.clamp(pv[..., 2], min=1e-8)
    u = pv[..., 0] / z * k[0, 0] + k[0, 2]
    v = pv[..., 1] / z * k[1, 1] + k[1, 2]
    return torch.stack([u, v], dim=-1), pv[..., 2]


def depth_abs_rel_reprojected(pred_depth: torch.Tensor,
                              gt_depth: torch.Tensor, k: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Depth abs-rel through a point-cloud reprojection: unproject the
    prediction, reproject it into the same camera, and compare the view z
    with gt where gt is valid."""
    pts = unproject_image(pred_depth, k)
    eye = torch.eye(4, dtype=torch.float32, device=pred_depth.device)
    _, z = reproject_points(pts, k, eye)
    return depth_abs_rel(z, gt_depth, mask)
