"""Tile-stripe sharded rendering: one render spread over the ranks by rows
of tiles.

Port of `dynamic3dgaussians_tpu/parallel/tile_shard.py`. Every rank
projects all gaussians and emits their (gaussian, tile) pairs over the
whole grid (no exact cull, as in the reference; on the card through the
emission kernel E1, `ops/cuda/emit.py`), then keeps the pairs of
its own stripe of `grid_h / K` tile rows: of the live pairs, those on the
stripe are kept (in slot order, as the reference's sort drops the others
under the sentinel), their tile keys become stripe-local ids and the y
coordinates stripe-local pixels, since the kernels derive a pixel's
position from its local tile index. The stripe is composited
through `ops/sorted_raster.py::_SortComposite` (the forward kernel K1, and
K2 in the backward) and the stripes are all-gathered along the image's Y
axis. Each rank sorts and composites about 1/K of the pairs.

The inputs and the image are held whole by every rank, and the gradient
of a loss of the image reaches each rank's inputs whole
(`collectives.enter_replicated` / `exit_replicated`).

Of the settings that change the numerics, the stripes take
`kernel_precision` alone, as the reference's do (its stripe composite is
built with the precision and the defaults of the rest): `pack_records`
and `power_impl` have no effect here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.cuda.emit import emit_pairs_cuda
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (_SortComposite,
                                                            Variant,
                                                            _untile,
                                                            depth_key_bits,
                                                            record_columns)
from dynamic3dgaussians_tpu_torch.parallel import collectives as C


def stripe_table(cam: Camera, cfg: RasterConfig, k: int, d: int,
                 means3d, colors, opacity, scales, rotations):
    """What stripe d of k composites: (table (8 + CV, N) of record columns
    with stripe-local y, the stripe's live pairs (`binning.Pairs`, tile
    keys stripe-local), `_SortComposite`'s spec)."""
    th, tw = cfg.tile_h, cfg.tile_w
    grid_h, grid_w = -(-cam.height // th), -(-cam.width // tw)
    rows_local = grid_h // k
    tiles_local = rows_local * grid_w
    proj = project(means3d, scales, rotations, cam)
    op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    pairs = emit_pairs_cuda(proj, th, tw, grid_h, grid_w,
                            cfg.max_tiles_per_gaussian)
    t0 = d * tiles_local
    on = (pairs.tile >= t0) & (pairs.tile < t0 + tiles_local)
    keep = torch.nonzero(on).squeeze(1)
    n_on = on.sum()
    pairs = pairs._replace(
        tile=pairs.tile[keep] - t0, slot=pairs.slot[keep],
        counts=torch.stack([n_on, torch.zeros_like(n_on)]))
    proj = dataclasses.replace(
        proj, y2d=proj.y2d - float(d * rows_local * th))
    table = record_columns(proj, colors, op)
    bits_z = depth_key_bits(tiles_local) if cfg.fused_key else 0
    spec = (colors.shape[-1], tiles_local, grid_w, th, tw, cfg.chunk, bits_z,
            cfg.depth_mode, means3d.device.type == "cuda",
            Variant(kernel_precision=cfg.kernel_precision))
    return table, pairs, spec


def make_tile_sharded_render(cam: Camera, group=None,
                             config: Optional[RasterConfig] = None,
                             device: DeviceLike = None):
    """The tile-sharded renderer of `cam` over `group` (default: the world
    group) on `device` (default `cuda`, where the kernels run; raises
    without one; on the CPU the kernels' plain versions).

    Returns fn(means3d, colors, opacity, scales, rotations, bg=None) ->
    dict(rgb, depth, alpha), the whole image on every rank. The camera's
    tile rows must divide by the group's size (pad its height to a multiple
    of K tile rows).
    """
    dev = resolve_device(device)
    if cam.device != dev:
        raise ValueError(f"camera is on {cam.device}, render device is {dev}")
    cfg = config or RasterConfig()
    h, w = cam.height, cam.width
    th, tw = cfg.tile_h, cfg.tile_w
    grid_h, grid_w = -(-h // th), -(-w // tw)
    k, d = C.axis_size(group), C.axis_index(group)
    if grid_h % k:
        raise ValueError(f"tile rows {grid_h} must divide by the group's {k} "
                         f"ranks")
    rows_local = grid_h // k

    def fn(means3d, colors, opacity, scales, rotations, bg=None):
        n_chan = colors.shape[-1]
        if bg is None:
            bg = torch.zeros((n_chan,), dtype=torch.float32, device=dev)
        means3d, colors, opacity, scales, rotations, bg = (
            C.enter_replicated(torch.as_tensor(x, dtype=torch.float32)
                               .to(dev), group)
            for x in (means3d, colors, opacity, scales, rotations, bg))
        table, pairs, spec = stripe_table(
            cam, cfg, k, d, means3d, colors, opacity.reshape(-1), scales,
            rotations)
        raw = _SortComposite.apply(table, pairs, spec)

        alpha_t = raw[..., n_chan + 1]
        chan_t = raw[..., :n_chan] + (1.0 - alpha_t[..., None]) * bg
        stripe_h = rows_local * th
        stripe = _untile(torch.cat([chan_t, raw[..., n_chan:n_chan + 1],
                                    alpha_t[..., None]], -1),
                         rows_local, grid_w, th, tw, stripe_h, w, n_chan + 2)
        full = C.exit_replicated(C.all_gather(stripe, group), group)[:h]
        return {"rgb": full[..., :n_chan], "depth": full[..., n_chan],
                "alpha": full[..., n_chan + 1]}

    return fn
