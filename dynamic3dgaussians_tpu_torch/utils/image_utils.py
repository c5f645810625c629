"""Image-space utilities: feature PCA, edges, normals, label colours, and
the network viewer's render modes.

Port of `dynamic3dgaussians_tpu/utils/image_utils.py`, in PyTorch on the
tensors' own device (`label_colormap` is NumPy).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def feature_pca(feature_map: torch.Tensor, n_components: int = 3,
                basis: Optional[torch.Tensor] = None):
    """(H, W, F) features -> ((H, W, n_components) RGB in [0, 1], basis).

    The basis (F, n_components) is the top right singular vectors of the
    centred features, unless one is given (to reuse it across frames).
    Each component is stretched between its 1st and 99th percentile.
    """
    h, w, f = feature_map.shape
    x = feature_map.reshape(-1, f)
    xc = x - torch.mean(x, dim=0, keepdim=True)
    if basis is None:
        _, _, vh = torch.linalg.svd(xc, full_matrices=False)
        basis = vh[:n_components].T
    proj = xc @ basis
    q = torch.tensor([0.01, 0.99], dtype=proj.dtype, device=proj.device)
    lo, hi = torch.quantile(proj, q, dim=0, keepdim=True)
    rgb = torch.clamp((proj - lo) / torch.clamp(hi - lo, min=1e-9), 0, 1)
    return rgb.reshape(h, w, n_components), basis


def sobel_edges(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude of a (H, W) or (H, W, C) image (C averaged)."""
    if img.dim() == 3:
        img = torch.mean(img, dim=-1)
    kx = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
    ky = [list(r) for r in zip(*kx)]
    h, w = img.shape
    pad = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]

    def conv(k):
        out = torch.zeros_like(img)
        for dy in range(3):
            for dx in range(3):
                out = out + k[dy][dx] * pad[dy:dy + h, dx:dx + w]
        return out

    gx, gy = conv(kx), conv(ky)
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def depth_to_normal(depth: torch.Tensor, fx: float, fy: float
                    ) -> torch.Tensor:
    """(H, W) view-space depth -> (H, W, 3) unit view-space normals, from
    central differences with wrap-around at the borders."""
    dzdx = (torch.roll(depth, -1, 1) - torch.roll(depth, 1, 1)) * 0.5
    dzdy = (torch.roll(depth, -1, 0) - torch.roll(depth, 1, 0)) * 0.5
    z = torch.clamp(depth, min=1e-6)
    n = torch.stack([-dzdx * fx / z, -dzdy * fy / z, torch.ones_like(z)],
                    dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-9)


def label_colormap(n: int = 256) -> np.ndarray:
    """(n, 3) uint8 Pascal-VOC-style label palette."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def render_net_image(out, render_mode: str = "RGB", fx: float = 500.0,
                     fy: float = 500.0) -> torch.Tensor:
    """A RenderOutput as the network viewer's `render_mode` shows it:
    (H, W, 3) float32 in [0, 1] (depth, alpha, edges, normals, feature
    PCA, segmentation or RGB)."""
    mode = render_mode.lower()
    if mode.startswith("depth"):
        from dynamic3dgaussians_tpu_torch.viz.render import colormap_depth
        img = colormap_depth(out.depth, out.alpha)
        return torch.as_tensor(img, device=out.rgb.device).to(
            torch.float32) / 255.0
    if mode.startswith("alpha"):
        return out.alpha[..., None].repeat(1, 1, 3)
    if mode.startswith("edge"):
        e = sobel_edges(out.rgb)
        e = e / torch.clamp(e.max(), min=1e-9)
        return e[..., None].repeat(1, 1, 3)
    if mode.startswith("normal"):
        safe = out.depth / torch.clamp(out.alpha, min=1e-6)
        return depth_to_normal(safe, fx, fy) * 0.5 + 0.5
    if mode.startswith("feature") and out.extra is not None:
        rgb, _ = feature_pca(out.extra)
        return rgb
    if mode.startswith("seg") and out.extra is not None:
        return torch.clamp(out.extra[..., :3], 0, 1)
    return torch.clamp(out.rgb, 0, 1)
