"""Oracle renderer: globally depth-sorted, all gaussians against all pixels.

Port of `dynamic3dgaussians_tpu/ops/rasterize_ref.py`: no tiling of the
work, no capacity limits, exact depth order, a loop over depth-sorted chunks
with the shared compositing math. O(N * H * W): tests and small scenes only.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.ops import compositing
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, tile_rect


def render_primitives_reference(cam: Camera, proj: Projected,
                                colors: torch.Tensor, opacity: torch.Tensor,
                                bg: Optional[torch.Tensor] = None,
                                chunk: int = 256, tile_h: int = 16,
                                tile_w: int = 16):
    """Composite projected primitives over the full image.

    A gaussian reaches only the pixels of tiles its 3-sigma rect touches
    (the visible support cutoff every implementation shares).

    Returns a dict: channels (H, W, C), depth (H, W), alpha (H, W).
    """
    dev = proj.x2d.device
    n = proj.x2d.shape[0]
    n_chan = colors.shape[-1]
    h, w = cam.height, cam.width
    if bg is None:
        bg = torch.zeros((n_chan,), dtype=torch.float32, device=dev)

    # invalid gaussians sort to the back; stable, like the original's radix
    # sort tie-breaking
    sort_depth = torch.where(proj.valid, proj.depth,
                             torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(sort_depth, stable=True)

    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    depth = proj.depth[order]
    op = opacity[order]
    vals = compositing.pack_values(colors[order], depth)
    valid = proj.valid[order]
    grid_h, grid_w = -(-h // tile_h), -(-w // tile_w)
    tx0, ty0, tx1, ty1, _ = tile_rect(proj, tile_h, tile_w, grid_h, grid_w)
    rect_min = torch.stack([tx0, ty0], dim=-1)[order]
    rect_max = torch.stack([tx1, ty1], dim=-1)[order]

    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    pix_tx = (px // tile_w).to(torch.int32)
    pix_ty = (py // tile_h).to(torch.int32)

    T = torch.ones((h * w,), dtype=torch.float32, device=dev)
    acc = torch.zeros((h * w, n_chan + 2), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        alpha = compositing.chunk_alpha(mean2d[sl], conic[sl], op[sl],
                                        valid[sl], px, py)
        rmin, rmax = rect_min[sl], rect_max[sl]
        in_rect = ((pix_tx[None, :] >= rmin[:, 0:1])
                   & (pix_tx[None, :] < rmax[:, 0:1])
                   & (pix_ty[None, :] >= rmin[:, 1:2])
                   & (pix_ty[None, :] < rmax[:, 1:2]))
        alpha = torch.where(in_rect, alpha, torch.zeros_like(alpha))
        T, acc = compositing.composite_chunk(T, acc, alpha, vals[sl])
    channels, depth_img, alpha_img = compositing.finalize(T, acc, bg)
    return {
        "channels": channels.reshape(h, w, n_chan),
        "depth": depth_img.reshape(h, w),
        "alpha": alpha_img.reshape(h, w),
    }
