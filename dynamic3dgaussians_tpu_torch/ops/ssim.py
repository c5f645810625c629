"""SSIM with an 11x11 Gaussian window (plain PyTorch).

Port of `dynamic3dgaussians_tpu/ops/ssim.py`: sigma 1.5 separable window,
zero padding of window_size // 2, per-channel blur, c1 = 0.01^2,
c2 = 0.03^2; images are channels-last (H, W, C).

The blur is the reference's separable shifted-add sum, not a grouped
`conv2d`: on the card a float32 convolution goes through cuDNN in TF32 by
default (about three decimal digits), and the shifted adds are plain
float32 elementwise operations on every device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_chw(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable zero-padded blur of (C, H, W) by shifted adds."""
    n = win.shape[0]
    pad = n // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, pad, pad))
    y = sum(float(win[t]) * xp[:, t:t + h, :] for t in range(n))
    yp = F.pad(y, (pad, pad))
    return sum(float(win[t]) * yp[:, :, t:t + w] for t in range(n))


def calc_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """SSIM between (H, W, C) images in [0, 1]."""
    win = _gaussian_window(window_size, sigma)
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)

    def blur(x):
        return _blur_chw(x, win)

    mu1, mu2 = blur(a), blur(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(a * a) - mu1_sq
    sigma2_sq = blur(b * b) - mu2_sq
    sigma12 = blur(a * b) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean() if size_average else ssim_map.mean(dim=(1, 2))


def dssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM), the structural term of the image loss."""
    return 1.0 - calc_ssim(img1, img2)
