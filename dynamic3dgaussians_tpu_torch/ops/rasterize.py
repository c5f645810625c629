"""The render entry point: RasterConfig, RenderOutput, render.

Port of `dynamic3dgaussians_tpu/ops/rasterize.py`. Methods:

  "reference"  the O(N*H*W) oracle (`rasterize_ref.py`); gradients by
               plain autograd through it
  "torch"      the sorted-pair path with the plain PyTorch versions of the
               forward and backward tile kernels (K1, K2)
  "cuda"       the sorted-pair path through the CUDA kernels K1 and K2
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

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.ops.rasterize_ref import \
    render_primitives_reference
from dynamic3dgaussians_tpu_torch.ops.sh import sh_to_color
from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (DEPTH_MODES,
                                                            render_sorted)

METHODS = ("auto", "reference", "torch", "cuda")


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

    def __post_init__(self):
        if self.depth_mode not in DEPTH_MODES:
            raise ValueError(f"depth_mode must be one of {DEPTH_MODES}, got "
                             f"{self.depth_mode!r}")


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    rgb: torch.Tensor                      # (H, W, 3)
    depth: torch.Tensor                    # (H, W) sum z*alpha*T
    alpha: torch.Tensor                    # (H, W) sum alpha*T
    radii: torch.Tensor                    # (N,) int32, 0 = culled
    extra: Optional[torch.Tensor] = None   # (H, W, E) extra channels
    n_dropped_rect: Optional[torch.Tensor] = None   # () int32


def _grad_gate(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x with its gradient zeroed where mask == 0; the value is unchanged."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    return x * m + (x * (1.0 - m)).detach()


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
           device: DeviceLike = None) -> RenderOutput:
    """Differentiable gaussian-splat render.

    means3d (N, 3); colors (N, 3) linear RGB, ignored when `sh` (N, K, 3) is
    given; opacity (N,) or (N, 1) activated; scales (N, 3) activated and
    rotations (N, 4) unit wxyz, unless cov3d_precomp (N, 6) is given;
    extra_channels (N, E) composited in the same pass over a zero
    background; bg (3,) RGB background; mean2d_probe_ndc (N, 2) zeros whose
    gradient is the densification statistic; grad_mask (N,) {0, 1} zeroes
    every gradient of the masked gaussians. Runs on `device` (default
    `cuda`), where `cam` must already be; the other inputs are moved there.
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

    if method == "reference":
        out = render_primitives_reference(cam, proj, all_chan, opacity,
                                          bg=full_bg, chunk=cfg.chunk,
                                          tile_h=cfg.tile_h,
                                          tile_w=cfg.tile_w)
        channels, depth, alpha = out["channels"], out["depth"], out["alpha"]
        n_dropped_rect = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
        channels, depth, alpha, n_dropped_rect = render_sorted(
            cam.height, cam.width, proj, all_chan, op, full_bg,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w, chunk=cfg.chunk,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            fused_key=cfg.fused_key, depth_mode=cfg.depth_mode,
            exact_cull=cfg.exact_cull, enum_cap=cfg.emit_enum_cap,
            use_kernel=method == "cuda")

    return RenderOutput(
        rgb=channels[..., :n_rgb],
        extra=None if extra_channels is None else channels[..., n_rgb:],
        depth=depth, alpha=alpha, radii=proj.radius,
        n_dropped_rect=n_dropped_rect)
