"""Training losses of the first timestep: image, segmentation, depth.

Port of the t = 0 terms of `dynamic3dgaussians_tpu/train/losses.py`:

  * l1 / weighted-l2 primitives, masked mean, PSNR, Pearson correlation
  * 0.8 * L1 + 0.2 * DSSIM image loss
  * the depth Pearson loss (min over two inverse-depth variants)
  * the per-camera colour correction exp(m) * img + c
  * the default loss weights

The physics losses of t > 0 (`physics_losses`) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from dynamic3dgaussians_tpu_torch.ops.ssim import calc_ssim

DEFAULT_LOSS_WEIGHTS: Dict[str, float] = {
    "im": 5.0, "seg": 2.0, "depth": 0.0, "rigid": 4.0, "rot": 4.0,
    "iso": 2.0, "floor": 2.0, "bg": 20.0, "soft_col_cons": 0.01,
    "feature": 0.1,
}


def _abs(x):
    """|x| with derivative +1 at 0, the reference's convention (torch.abs
    has 0 there): an exact tie, such as a segmentation channel that is 0
    in both render and ground truth, then gets the reference's gradient."""
    return torch.where(x >= 0, x, -x)


def l1_loss_v1(x, y):
    return torch.mean(_abs(x - y))


def l1_loss_v2(x, y):
    return torch.mean(torch.sum(_abs(x - y), dim=-1))


def weighted_l2_loss_v1(x, y, w):
    return torch.mean(torch.sqrt((x - y) ** 2 * w + 1e-20))


def weighted_l2_loss_v2(x, y, w):
    return torch.mean(torch.sqrt(torch.sum((x - y) ** 2, dim=-1) * w
                                 + 1e-20))


def masked_mean(x, mask):
    # where (not multiply): NaN or inf in masked-out rows must not reach the
    # sum or its gradient
    m = mask.to(x.dtype)
    return (torch.sum(torch.where(mask, x, torch.zeros_like(x)))
            / torch.clamp(torch.sum(m), min=1.0))


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def pearson_corrcoef(x, y):
    x = x.reshape(-1) - torch.mean(x)
    y = y.reshape(-1) - torch.mean(y)
    denom = torch.sqrt(torch.sum(x * x) * torch.sum(y * y)) + 1e-12
    return torch.sum(x * y) / denom


def image_loss(pred, gt, l1_weight: float = 0.8):
    """0.8 * L1 + 0.2 * (1 - SSIM), channels-last images."""
    return l1_weight * l1_loss_v1(pred, gt) + (1.0 - l1_weight) * (
        1.0 - calc_ssim(pred, gt))


def depth_pearson_loss(pred_depth, gt_depth):
    """min over the two inverse-depth Pearson variants."""
    a = 1.0 - pearson_corrcoef(-gt_depth, pred_depth)
    b = 1.0 - pearson_corrcoef(1.0 / (gt_depth + 200.0), pred_depth)
    return torch.minimum(a, b)


def apply_cam_correction(img, cam_m, cam_c):
    """Per-camera affine colour correction exp(m) * img + c."""
    return torch.exp(cam_m)[None, None, :] * img + cam_c[None, None, :]
