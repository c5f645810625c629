"""The render entry point: RasterConfig, RenderOutput, render.

Port of `dynamic3dgaussians_tpu/ops/rasterize.py`. Methods:

  "reference"  the O(N*H*W) oracle (`rasterize_ref.py`); gradients by
               plain autograd through it
  "torch"      the sorted-pair path with the plain PyTorch versions of the
               forward and backward tile kernels (K1, K2)
  "cuda"       the sorted-pair path through the CUDA kernels K1 and K2
  "tiled"      the reference's pure-XLA path, plain PyTorch here too: a
               fixed pair capacity (`binning.bin_gaussians`), each tile's
               first `max_per_tile` pairs gathered from one record table
               and composited chunk by chunk; gradients by autograd, each
               chunk recomputed in the backward (`torch.utils.checkpoint`,
               the reference's jax.checkpoint)
  "auto"       "cuda" on a CUDA device, "torch" on the CPU

On the sorted-pair paths the gradient goes through one
`torch.autograd.Function` (`sorted_raster._SortComposite`), the
counterpart of the reference's custom_vjp; autograd covers projection, SH
and the activations around it. `grad_mask` is the reference's `_grad_gate`
(the original's `label` gradient gating) and `mean2d_probe_ndc` its
densification probe.

The reference's TPU-only knobs (power_impl, scan_impl, tile_batch,
pack_records, unsort_impl, kernel_precision) are not ported: the kernels
compute the default power_impl="vpu" semantics in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from dynamic3dgaussians_tpu_torch.device import (DeviceLike, no_tf32,
                                                 resolve_device)
from dynamic3dgaussians_tpu_torch.ops import compositing
from dynamic3dgaussians_tpu_torch.ops.binning import TileBins, bin_gaussians
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
    tile_pixel_coords
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, project
from dynamic3dgaussians_tpu_torch.ops.rasterize_ref import \
    render_primitives_reference
from dynamic3dgaussians_tpu_torch.ops.sh import sh_to_color
from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (DEPTH_MODES,
                                                            _untile,
                                                            render_sorted)

METHODS = ("auto", "reference", "torch", "cuda", "tiled")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Tiling and sort settings (the reference's semantic fields)."""

    tile_h: int = 16
    tile_w: int = 16
    chunk: int = 128
    # emission slots per gaussian; pairs beyond them are counted in
    # RenderOutput.n_dropped_rect, never silent
    max_tiles_per_gaussian: int = 8
    # fuse (tile, depth) into one int32 key when the tile grid leaves >= 18
    # depth bits; "quantized" reads bucket depth back out of the key,
    # "exact" keeps exact depth values, "total" also sorts by exact depth
    fused_key: bool = True
    depth_mode: str = "quantized"
    # lossless cull of (gaussian, tile) pairs that cannot pass the 1/255
    # alpha gate; emit_enum_cap sizes the tested rect window (0 = auto)
    exact_cull: bool = True
    emit_enum_cap: int = 0
    # "tiled" path only: pairs composited per tile (more are counted in
    # RenderOutput.n_dropped_tile_overflow) and the pair capacity per
    # gaussian (`pair_capacity`; more are counted in n_dropped_capacity)
    max_per_tile: int = 1024
    pairs_per_gaussian: int = 8

    def __post_init__(self):
        if self.depth_mode not in DEPTH_MODES:
            raise ValueError(f"depth_mode must be one of {DEPTH_MODES}, got "
                             f"{self.depth_mode!r}")

    def pair_capacity(self, n: int) -> int:
        cap = self.pairs_per_gaussian * n
        return max(1024, -(-cap // 1024) * 1024)


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    rgb: torch.Tensor                      # (H, W, 3)
    depth: torch.Tensor                    # (H, W) sum z*alpha*T
    alpha: torch.Tensor                    # (H, W) sum alpha*T
    radii: torch.Tensor                    # (N,) int32, 0 = culled
    extra: Optional[torch.Tensor] = None   # (H, W, E) extra channels
    # () int32 drop counters, zero in a render that lost no pair; only the
    # "tiled" path has the capacity and per-tile ones
    n_dropped_rect: Optional[torch.Tensor] = None
    n_dropped_capacity: Optional[torch.Tensor] = None
    n_dropped_tile_overflow: Optional[torch.Tensor] = None
    # () int64, with a pair_cap only: the live pairs, and those past the
    # capacity (not a drop the reference makes: a result with any is to be
    # discarded, never counted among the drops above)
    n_live_pairs: Optional[torch.Tensor] = None
    n_pair_overflow: Optional[torch.Tensor] = None


def _grad_gate(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x with its gradient zeroed where mask == 0; the value is unchanged."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    return x * m + (x * (1.0 - m)).detach()


def _record_table(proj: Projected, colors: torch.Tensor,
                  opacity: torch.Tensor) -> torch.Tensor:
    """(N, F) per-gaussian fields of the "tiled" path: [0:2] mean2d, [2:5]
    conic, [5] opacity (zero for culled gaussians), [6:6+C] channels,
    [6+C] view depth, [7+C] ones, zero columns up to F % 8 == 0."""
    op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    table = torch.cat([proj.mean2d, proj.conic, op[:, None], colors,
                       proj.depth[:, None], torch.ones_like(op)[:, None]],
                      dim=-1)
    pad = (-table.shape[-1]) % 8
    if pad:
        table = torch.nn.functional.pad(table, (0, pad))
    return table


def _gather_and_composite(h: int, w: int, proj: Projected,
                          colors: torch.Tensor, opacity: torch.Tensor,
                          bg: torch.Tensor, cfg: RasterConfig,
                          bins: TileBins):
    """Composite every tile's first `max_per_tile` pairs, chunk by chunk
    -> (channels (H, W, C), depth (H, W), alpha (H, W))."""
    th, tw, chunk = cfg.tile_h, cfg.tile_w, cfg.chunk
    grid_h, grid_w = -(-h // th), -(-w // tw)
    num_tiles = grid_h * grid_w
    n_chan = colors.shape[-1]
    dev = opacity.device
    f32 = torch.float32

    mt = -(-cfg.max_per_tile // chunk) * chunk
    slot = torch.arange(mt, dtype=torch.int32, device=dev)
    idx = bins.tile_starts[:, None] + slot[None, :]               # (T, MT)
    in_list = slot[None, :] < torch.clamp(bins.tile_counts, max=mt)[:, None]
    ids = bins.gaussian_ids[torch.clamp(
        idx, 0, bins.gaussian_ids.shape[0] - 1).long()]
    rec = _record_table(proj, colors, opacity)[ids.long()]       # (T, MT, F)
    g_op = torch.where(in_list, rec[..., 5], torch.zeros_like(rec[..., 5]))

    px, py = tile_pixel_coords(num_tiles, grid_w, th, tw, dev)
    batched_alpha = torch.func.vmap(compositing.chunk_alpha)
    batched_comp = torch.func.vmap(compositing.composite_chunk)

    def body(t_in, acc, k):
        sl = slice(k * chunk, (k + 1) * chunk)
        g = rec[:, sl]                                            # (T, G, F)
        alpha = batched_alpha(g[..., 0:2], g[..., 2:5], g_op[:, sl],
                              in_list[:, sl], px, py)
        with no_tf32():
            return batched_comp(t_in, acc, alpha, g[..., 6:6 + n_chan + 2])

    t_run = torch.ones((num_tiles, th * tw), dtype=f32, device=dev)
    acc = torch.zeros((num_tiles, th * tw, n_chan + 2), dtype=f32,
                      device=dev)
    for k in range(mt // chunk):
        if torch.is_grad_enabled():
            t_run, acc = torch.utils.checkpoint.checkpoint(
                body, t_run, acc, k, use_reentrant=False)
        else:
            t_run, acc = body(t_run, acc, k)

    channels, depth, alpha = torch.func.vmap(compositing.finalize,
                                             in_dims=(0, 0, None))(
        t_run, acc, bg)
    return (_untile(channels, grid_h, grid_w, th, tw, h, w, n_chan),
            _untile(depth[..., None], grid_h, grid_w, th, tw, h, w, 1)[..., 0],
            _untile(alpha[..., None], grid_h, grid_w, th, tw, h, w, 1)[..., 0])


def render(cam: Camera,
           means3d: torch.Tensor,
           colors: torch.Tensor,
           opacity: torch.Tensor,
           scales: Optional[torch.Tensor] = None,
           rotations: Optional[torch.Tensor] = None,
           *,
           extra_channels: Optional[torch.Tensor] = None,
           bg=None,
           sh: Optional[torch.Tensor] = None,
           sh_degree: int = 0,
           cov3d_precomp: Optional[torch.Tensor] = None,
           scale_modifier: float = 1.0,
           mean2d_probe_ndc: Optional[torch.Tensor] = None,
           grad_mask: Optional[torch.Tensor] = None,
           method: str = "auto",
           config: Optional[RasterConfig] = None,
           device: DeviceLike = None,
           pair_cap: Optional[int] = None,
           pair_stats: bool = False) -> RenderOutput:
    """Differentiable gaussian-splat render.

    means3d (N, 3); colors (N, 3) linear RGB, ignored when `sh` (N, K, 3) is
    given; opacity (N,) or (N, 1) activated; scales (N, 3) activated and
    rotations (N, 4) unit wxyz, unless cov3d_precomp (N, 6) is given;
    extra_channels (N, E) composited in the same pass over a zero
    background; bg (3,) RGB background; mean2d_probe_ndc (N, 2) zeros whose
    gradient is the densification statistic; grad_mask (N,) {0, 1} zeroes
    every gradient of the masked gaussians. Runs on `device` (default
    `cuda`), where `cam` must already be; the other inputs are moved there.
    pair_cap (sorted-pair paths): a fixed pair capacity for the record
    table, so that the render reads nothing back from the device (a step
    captured in a CUDA graph); live pairs past it are missing from the
    image and counted in `n_pair_overflow`, which the caller must check.
    None: the table holds exactly the live pairs (one host read of their
    count), and `n_live_pairs` / `n_pair_overflow` are set only with
    pair_stats (to the count and 0).
    """
    if method not in METHODS:
        raise ValueError(f"unknown render method {method!r}; one of "
                         f"{METHODS}")
    dev = resolve_device(device)
    if cam.device != dev:
        raise ValueError(f"camera is on {cam.device}, render device is {dev}")
    if method == "auto":
        method = "cuda" if dev.type == "cuda" else "torch"
    if method == "cuda" and dev.type != "cuda":
        raise ValueError(f"method 'cuda' needs a CUDA device, got {dev}")
    cfg = config or RasterConfig()

    def on_dev(t):
        return None if t is None else torch.as_tensor(
            t, dtype=torch.float32).to(dev)

    means3d, colors, opacity = on_dev(means3d), on_dev(colors), on_dev(opacity)
    scales, rotations = on_dev(scales), on_dev(rotations)
    extra_channels, sh = on_dev(extra_channels), on_dev(sh)
    cov3d_precomp = on_dev(cov3d_precomp)
    mean2d_probe_ndc, grad_mask = on_dev(mean2d_probe_ndc), on_dev(grad_mask)

    opacity = opacity.reshape(opacity.shape[0], -1)[:, 0]
    if sh is not None:
        colors = sh_to_color(sh_degree, sh, means3d, cam.cam_center)
    if grad_mask is not None:
        means3d = _grad_gate(means3d, grad_mask)
        colors = _grad_gate(colors, grad_mask)
        opacity = _grad_gate(opacity, grad_mask)
        if scales is not None:
            scales = _grad_gate(scales, grad_mask)
        if rotations is not None:
            rotations = _grad_gate(rotations, grad_mask)
        if extra_channels is not None:
            extra_channels = _grad_gate(extra_channels, grad_mask)
    all_chan = colors if extra_channels is None else torch.cat(
        [colors, extra_channels], dim=-1)
    n_rgb = colors.shape[-1]
    full_bg = torch.zeros((all_chan.shape[-1],), dtype=torch.float32,
                          device=dev)
    if bg is not None:
        full_bg[:n_rgb] = on_dev(bg)

    proj = project(means3d, scales, rotations, cam,
                   scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
                   mean2d_probe_ndc=mean2d_probe_ndc)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_dropped_capacity = n_tile_overflow = zero
    stats = None

    if method == "reference":
        out = render_primitives_reference(cam, proj, all_chan, opacity,
                                          bg=full_bg, chunk=cfg.chunk,
                                          tile_h=cfg.tile_h,
                                          tile_w=cfg.tile_w)
        channels, depth, alpha = out["channels"], out["depth"], out["alpha"]
        n_dropped_rect = zero
    elif method == "tiled":
        th, tw = cfg.tile_h, cfg.tile_w
        grid_h, grid_w = -(-cam.height // th), -(-cam.width // tw)
        bins = bin_gaussians(proj, th, tw, grid_h, grid_w,
                             pair_capacity=cfg.pair_capacity(
                                 opacity.shape[0]),
                             max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
        mt = -(-cfg.max_per_tile // cfg.chunk) * cfg.chunk
        n_tile_overflow = torch.sum(torch.clamp(bins.tile_counts - mt,
                                                min=0)).to(torch.int32)
        channels, depth, alpha = _gather_and_composite(
            cam.height, cam.width, proj, all_chan, opacity, full_bg, cfg,
            bins)
        n_dropped_rect = bins.n_dropped_rect
        n_dropped_capacity = bins.n_dropped_capacity
    else:
        op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
        channels, depth, alpha, n_dropped_rect, stats = render_sorted(
            cam.height, cam.width, proj, all_chan, op, full_bg,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w, chunk=cfg.chunk,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            fused_key=cfg.fused_key, depth_mode=cfg.depth_mode,
            exact_cull=cfg.exact_cull, enum_cap=cfg.emit_enum_cap,
            use_kernel=method == "cuda", pair_cap=pair_cap,
            pair_stats=pair_stats)

    return RenderOutput(
        rgb=channels[..., :n_rgb],
        extra=None if extra_channels is None else channels[..., n_rgb:],
        depth=depth, alpha=alpha, radii=proj.radius,
        n_dropped_rect=n_dropped_rect, n_dropped_capacity=n_dropped_capacity,
        n_dropped_tile_overflow=n_tile_overflow,
        n_live_pairs=None if stats is None else stats[0],
        n_pair_overflow=None if stats is None else stats[1])
