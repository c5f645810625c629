"""Cached-order playback: render through a frozen sort order.

Port of `dynamic3dgaussians_tpu/ops/playback.py`. Along a smooth camera path
or a timeline seen from a fixed camera, the depth order and the tile
membership of the splats change slowly, so a frame is split into:

  * KEY frames (`build_cache`): projection, emission with the exact cull
    (on the card the kernel E1, `ops/cuda/emit.py`), and an argsort of
    the live pairs' float-bits (tile, depth) key, no payload. The cache
    keeps the order: each sorted pair's gaussian id and each tile's
    segment.
  * CACHED frames (`render_playback`): project fresh, build the
    per-gaussian record rows from the current geometry, colours and
    opacity, and gather them through the cached ids straight into the
    forward kernel's table (K1, `ops/cuda/raster_fwd.py::composite_tiles`).
    No emission and no sort.

What is stale on a cached frame, and only this: the depth order within a
tile, tile membership, and the cull decisions of the key frame. On the
cache of its own camera, `render_playback` composites the exact render's
pairs, with two differences: the reference's f16 transport of the conic,
opacity and channel rows (`sorted_raster.round_f16`), under one 8-bit
quantum except where it moves an alpha across the 1/255 gate; and the
order within a tile, which the float-bits key resolves to 2^-(bits_z - 8)
relative depth (2^-13 at a 920-tile grid), coarser than the exact
render's affine key, so near-equal depths may composite in another order.
x, y and the view depth ride in float32, the depth exact and fresh (not a
dequantized key).

Of the config, K1 takes kernel_precision and power_impl, as the
reference's does. Under power_impl="mxu_fused" the table's rows 6 and 7
are filled from the f16 opacity row (`sorted_raster.fused_opacity_rows`),
as the exact render's are. The reference leaves them at zero there, so its
cached frames read log2 opacity 0: opacity 1 and the clamp at alpha 1, not
0.99. That is a fault of the reference, which the port does not repeat.

Differences in the mechanics, not in the result: the reference sorts all
K*N emission slots and keeps a K*N-long gather index whose sentinel slots
sort past the last segment; the cache here keeps only the live pairs'
ids (the emission hands over the live pairs, one host read of their count
per key frame), so its record table is shorter, and the segments are the
same. Inference only, as in the
reference: no autograd through the frozen order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.binning import tile_ranges
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
    composite_tiles
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, project
from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                        RenderOutput)
from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (
    _key64, _untile, depth_key_bits, emit, fuse_tile_depth_key,
    f16_rows, fused_opacity_rows, record_columns, round_f16)


@dataclasses.dataclass(frozen=True)
class PlaybackCache:
    """Frozen sort order and tile segments of a key frame."""

    gidx: torch.Tensor           # (n_live,) int32 sorted pair -> gaussian
    starts: torch.Tensor         # (num_tiles,) int32 segment starts
    counts: torch.Tensor         # (num_tiles,) int32 segment lengths
    n_dropped_rect: torch.Tensor  # () int32 emission drops at the key frame


def _inputs(cam: Camera, device: DeviceLike, *tensors):
    dev = resolve_device(device)
    if cam.device != dev:
        raise ValueError(f"camera is on {cam.device}, render device is {dev}")
    return dev, [None if t is None else torch.as_tensor(
        t, dtype=torch.float32).to(dev) for t in tensors]


@torch.no_grad()
def build_cache(cam: Camera, means3d: torch.Tensor, opacity: torch.Tensor,
                scales: torch.Tensor, rotations: torch.Tensor, *,
                config: Optional[RasterConfig] = None,
                scale_modifier: float = 1.0,
                device: DeviceLike = None) -> PlaybackCache:
    """Key-frame pass: emission (the kernel E1 on the card) and a key-only
    sort on `device` (default `cuda`, where `cam` must already be).
    opacity (N,) or (N, 1) activated."""
    cfg = config or RasterConfig()
    dev, (means3d, opacity, scales, rotations) = _inputs(
        cam, device, means3d, opacity, scales, rotations)
    h, w = cam.height, cam.width
    num_tiles = -(-h // cfg.tile_h) * -(-w // cfg.tile_w)
    proj = project(means3d, scales, rotations, cam,
                   scale_modifier=scale_modifier)
    opacity = opacity.reshape(opacity.shape[0], -1)[:, 0]
    op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    pairs = emit(h, w, proj, op, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                 max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                 exact_cull=cfg.exact_cull, enum_cap=cfg.emit_enum_cap)
    lt = pairs.tile
    lg = pairs.slot % proj.depth.shape[0]
    depth = proj.depth[lg.long()]
    bits_z = depth_key_bits(num_tiles) if cfg.fused_key else 0
    if bits_z > 0:
        perm = torch.argsort(fuse_tile_depth_key(lt, depth, bits_z))
    else:
        perm = torch.argsort(_key64(lt, depth))
    starts, counts = tile_ranges(lt[perm].contiguous(), num_tiles)
    return PlaybackCache(gidx=lg[perm].contiguous(),
                         starts=starts.contiguous(),
                         counts=counts.contiguous(),
                         n_dropped_rect=pairs.n_dropped_rect)


def playback_records(proj: Projected, colors: torch.Tensor,
                     opacity: torch.Tensor, cache: PlaybackCache,
                     chunk: int, power_impl: str = "vpu") -> torch.Tensor:
    """K1's (8 + CV, NE_pad) record table of a cached frame: this frame's
    per-gaussian rows (`sorted_raster.record_columns`, the conic, opacity
    and channel rows through the f16 round trip; under "mxu_fused" rows 6
    and 7 from the rounded opacity) gathered through the cache's ids;
    NE_pad = (ceil(n_live / chunk) + 1) * chunk, zeros past the live pairs.
    colors (N, C), opacity (N,) zeroed for culled gaussians."""
    table = record_columns(proj, colors, opacity)
    for rows in f16_rows(colors.shape[-1]):
        table[rows] = round_f16(table[rows])
    if power_impl == "mxu_fused":
        table[6], table[7] = fused_opacity_rows(table[5])
    n_live = cache.gidx.shape[0]
    ne_pad = (-(-n_live // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32,
                        device=table.device)
    rec_t[:, :n_live] = table[:, cache.gidx.long()]
    return rec_t


@torch.no_grad()
def render_playback(cam: Camera, means3d: torch.Tensor, colors: torch.Tensor,
                    opacity: torch.Tensor, scales: torch.Tensor,
                    rotations: torch.Tensor, cache: PlaybackCache, *,
                    bg=None, extra_channels: Optional[torch.Tensor] = None,
                    config: Optional[RasterConfig] = None,
                    scale_modifier: float = 1.0, device: DeviceLike = None) -> RenderOutput:
    """Render one frame through a cached order on `device` (default
    `cuda`, where `cam` and `cache` must already be).

    Geometry, colours and opacity are this frame's; only the pair order and
    the tile segments come from the cache.
    """
    cfg = config or RasterConfig()
    dev, (means3d, colors, opacity, scales, rotations, extra_channels,
          bg) = _inputs(cam, device, means3d, colors, opacity, scales,
                        rotations, extra_channels, bg)
    h, w = cam.height, cam.width
    th, tw, chunk = cfg.tile_h, cfg.tile_w, cfg.chunk
    grid_h, grid_w = -(-h // th), -(-w // tw)
    num_tiles = grid_h * grid_w
    proj = project(means3d, scales, rotations, cam,
                   scale_modifier=scale_modifier)
    opacity = opacity.reshape(opacity.shape[0], -1)[:, 0]
    op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    all_chan = colors if extra_channels is None else torch.cat(
        [colors, extra_channels], dim=-1)
    n_chan, n_rgb = all_chan.shape[-1], colors.shape[-1]
    full_bg = torch.zeros((n_chan,), dtype=torch.float32, device=dev)
    if bg is not None:
        full_bg[:n_rgb] = bg

    rec_t = playback_records(proj, all_chan, op, cache, chunk,
                             power_impl=cfg.power_impl)
    raw, _, _ = composite_tiles(rec_t, cache.starts, cache.counts,
                                num_tiles=num_tiles, grid_w=grid_w,
                                tile_h=th, tile_w=tw, chunk=chunk,
                                precision=cfg.kernel_precision,
                                power_impl=cfg.power_impl)
    alpha_t = raw[..., n_chan + 1]
    chan_t = raw[..., :n_chan] + (1.0 - alpha_t[..., None]) * full_bg
    channels = _untile(chan_t, grid_h, grid_w, th, tw, h, w, n_chan)
    depth = _untile(raw[..., n_chan, None], grid_h, grid_w, th, tw, h, w,
                    1)[..., 0]
    alpha = _untile(alpha_t[..., None], grid_h, grid_w, th, tw, h, w,
                    1)[..., 0]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return RenderOutput(
        rgb=channels[..., :n_rgb],
        extra=None if extra_channels is None else channels[..., n_rgb:],
        depth=depth, alpha=alpha, radii=proj.radius,
        n_dropped_rect=cache.n_dropped_rect, n_dropped_capacity=zero,
        n_dropped_tile_overflow=zero)
