"""Depth-slab sharded rendering: one render spread over the ranks by
gaussians, merged front to back.

Port of `dynamic3dgaussians_tpu/parallel/gaussian_shard.py`. The gaussians
are ordered by view depth (invalid ones, at or before the near plane,
last) and cut into K slabs of ceil(N / K); rank d renders slab d through
the port's `render` (the kernels K1 and K2 on the card). Because slabs are
disjoint in depth, the ranks' images merge exactly by an ordered scan:

    C = sum_d (prod_{e<d} T_e) C_d,     T = prod_d T_d

with premultiplied channels. Each rank all-gathers the ranks' log
transmittance images, log1p(-min(alpha, 1 - 1e-7)), forms its exclusive
prefix, weights its [rgb, depth, alpha] by exp(prefix), and the weighted
images are summed over the ranks; the background goes on after the merge.
The slab of the last rank is padded with row N - 1 at zero opacity.

The gradient of a loss of the merged image flows through the merge,
through the other ranks' log transmittance too, and reaches each rank's
inputs whole (`collectives.enter_replicated` / `exit_replicated`).
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from dynamic3dgaussians_tpu_torch.parallel import collectives as C


def slab_rows(cam: Camera, means3d: torch.Tensor, k: int,
              d: int) -> torch.Tensor:
    """(ceil(N / K),) int64 rows of slab d: the stable argsort of view
    depth (invalid rows at inf), padded with row N - 1."""
    n = means3d.shape[0]
    per = -(-n // k)
    v = cam.w2c
    depth = (v[2, 0] * means3d[:, 0] + v[2, 1] * means3d[:, 1]
             + v[2, 2] * means3d[:, 2] + v[2, 3])
    key = torch.where(depth > cam.near, depth,
                      torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    order = torch.cat([order, order.new_full((per * k - n,), n - 1)])
    return order[d * per:(d + 1) * per]


def slab_inputs(cam: Camera, k: int, d: int, means3d, colors, opacity,
                scales, rotations):
    """The render inputs of slab d of k: the slab's rows of each input
    (`slab_rows`), the padding rows at zero opacity."""
    mine = slab_rows(cam, means3d.detach(), k, d)
    slot_ok = torch.arange(mine.shape[0], device=mine.device) \
        + d * mine.shape[0] < means3d.shape[0]
    op = opacity[mine]
    return (means3d[mine], colors[mine],
            torch.where(slot_ok, op, torch.zeros_like(op)), scales[mine],
            rotations[mine])


def make_depth_sharded_render(cam: Camera, group=None,
                              config: Optional[RasterConfig] = None,
                              method: str = "auto",
                              device: DeviceLike = None):
    """The depth-sharded renderer of `cam` over `group` (default: the world
    group) on `device` (default `cuda`; raises without one); each slab
    renders with `render(..., method=method)`.

    Returns fn(means3d, colors, opacity, scales, rotations, bg=None) ->
    dict(rgb, depth, alpha), fully composited, on every rank. The gaussian
    count must be at least the group's size.
    """
    dev = resolve_device(device)
    if cam.device != dev:
        raise ValueError(f"camera is on {cam.device}, render device is {dev}")
    k, d = C.axis_size(group), C.axis_index(group)

    def fn(means3d, colors, opacity, scales, rotations, bg=None):
        means3d, colors, opacity, scales, rotations = (
            C.enter_replicated(torch.as_tensor(x, dtype=torch.float32)
                               .to(dev), group)
            for x in (means3d, colors, opacity, scales, rotations))
        opacity = opacity.reshape(-1)
        n = means3d.shape[0]
        if n < k:
            raise ValueError(f"{n} gaussians cannot fill the group's {k} "
                             f"slabs")
        out = render(cam, *slab_inputs(cam, k, d, means3d, colors, opacity,
                                       scales, rotations),
                     config=config, method=method, device=dev)

        log_t = torch.log1p(-torch.clamp(out.alpha, max=1.0 - 1e-7))
        all_log_t = C.all_gather(log_t[None], group)            # (K, H, W)
        before = (torch.arange(k, device=dev) < d).reshape(k, 1, 1)
        prefix = torch.sum(torch.where(before, all_log_t,
                                       torch.zeros_like(all_log_t)), 0)
        wgt = torch.exp(prefix)
        part = torch.cat([out.rgb * wgt[..., None],
                          (out.depth * wgt)[..., None],
                          (out.alpha * wgt)[..., None]], -1)
        total = C.psum(part, group)
        rgb = total[..., :3]
        if bg is not None:
            bg = C.enter_replicated(torch.as_tensor(bg, dtype=torch.float32)
                                    .to(dev), group)
            rgb = rgb + (1.0 - total[..., 4:]) * bg
        full = C.exit_replicated(torch.cat([rgb, total[..., 3:]], -1), group)
        return {"rgb": full[..., :3], "depth": full[..., 3],
                "alpha": full[..., 4]}

    return fn
