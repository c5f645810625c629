"""Tile binning: (gaussian, tile) pair emission and per-tile ranges.

Port of `dynamic3dgaussians_tpu/ops/binning.py` (`emit_pairs`,
`tile_ranges`). Every gaussian owns K = `max_tiles_per_gaussian` emission
slots, laid out k-major (slot = k * N + gaussian), with `num_tiles` as the
sentinel of an unused slot. Keeping the K slots means `n_dropped_rect`
counts the same drops as the reference: pairs that a gaussian's K slots
could not hold.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, tile_rect


def emit_pairs(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
               grid_w: int, max_tiles_per_gaussian: int,
               opacity: torch.Tensor = None, enum_cap: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Enumerate each gaussian's tile rect into flat (K*N,) int32 pair keys.

    Returns (tile_key, gid, n_dropped_rect). With `opacity` given and
    enum_cap > K, candidate tiles are exact-culled first: a pair whose
    largest possible alpha over the tile's pixel box is below the 1/255 gate
    only ever contributes zeros, so dropping it is lossless. Survivors among
    the first `enum_cap` rect cells are rank-compacted into the K slots;
    `n_dropped_rect` is a conservative (never low) count of pairs lost.
    """
    k_cap = max_tiles_per_gaussian
    num_tiles = grid_h * grid_w
    n = proj.depth.shape[0]
    dev = proj.depth.device
    i32 = torch.int32
    tx0, ty0, tx1, ty1, raw_count = tile_rect(proj, tile_h, tile_w,
                                              grid_h, grid_w)
    gid = torch.arange(n, dtype=i32, device=dev).expand(k_cap, n)

    if opacity is None or enum_cap <= k_cap:
        count = torch.clamp(raw_count, max=k_cap)
        n_dropped_rect = torch.sum(raw_count - count).to(i32)
        kk = torch.arange(k_cap, dtype=i32, device=dev)[:, None]
        rw = torch.clamp(tx1 - tx0, min=1)[None, :]
        ty = ty0[None, :] + torch.div(kk, rw, rounding_mode="floor")
        tx = tx0[None, :] + kk % rw
        ok = kk < count[None, :]
        tile_key = torch.where(ok, ty * grid_w + tx,
                               torch.full_like(ty, num_tiles)).to(i32)
        return tile_key.reshape(-1), gid.reshape(-1), n_dropped_rect

    # ---- exact cull: test up to enum_cap rect cells per gaussian ----
    cc = torch.arange(enum_cap, dtype=i32, device=dev)[:, None]
    rw = torch.clamp(tx1 - tx0, min=1)[None, :]
    ty = ty0[None, :] + torch.div(cc, rw, rounding_mode="floor")
    tx = tx0[None, :] + cc % rw
    in_rect = cc < torch.clamp(raw_count, max=enum_cap)[None, :]

    # lam_min * |d|^2 lower-bounds the conic quadratic form, so the bound
    # upper-bounds every pixel's alpha in the tile box
    mid = 0.5 * (proj.conic_a + proj.conic_c)
    dif = 0.5 * (proj.conic_a - proj.conic_c)
    lam_min = torch.clamp(
        mid - torch.sqrt(dif * dif + proj.conic_b * proj.conic_b), min=0.0)
    bx0 = (tx * tile_w).to(torch.float32)
    by0 = (ty * tile_h).to(torch.float32)
    x, y = proj.x2d[None, :], proj.y2d[None, :]
    ddx = torch.clamp(torch.maximum(bx0 - x, x - (bx0 + (tile_w - 1))),
                      min=0.0)
    ddy = torch.clamp(torch.maximum(by0 - y, y - (by0 + (tile_h - 1))),
                      min=0.0)
    d2 = ddx * ddx + ddy * ddy
    bound = opacity[None, :] * torch.exp(-0.5 * lam_min[None, :] * d2)
    # 0.999: margin so float noise never crosses the gate
    ok_cell = in_rect & (bound >= ALPHA_EPS * 0.999)

    ok_i = ok_cell.to(i32)
    rank = torch.cumsum(ok_i, dim=0, dtype=i32) - 1
    key_cell = torch.where(ok_cell, ty * grid_w + tx, torch.zeros_like(ty))
    slots = []
    for k in range(k_cap):
        hit = ok_cell & (rank == k)
        slots.append(torch.sum(torch.where(hit, key_cell + 1,
                                           torch.zeros_like(key_cell)),
                               dim=0, dtype=i32) - 1)
    tile_key = torch.stack(slots, 0)
    tile_key = torch.where(tile_key >= 0, tile_key,
                           torch.full_like(tile_key, num_tiles)).to(i32)

    pass_count = torch.sum(ok_i, dim=0, dtype=i32)
    # Conservative drop count: passing cells beyond the K slots, plus the
    # untested rect cells past the enum window, capped by the alpha-reach
    # bound dmax = sqrt(2 ln(op/eps) / lam_min) (cells whose box lies
    # farther than dmax from the center cannot pass)
    safe_op = torch.clamp(opacity, min=ALPHA_EPS)
    dmax = torch.sqrt(2.0 * torch.log(safe_op / (ALPHA_EPS * 0.999))
                      / torch.clamp(lam_min, min=1e-12))
    dmax = torch.clamp(dmax, max=float(
        (grid_w + 1) * tile_w + (grid_h + 1) * tile_h))
    nx = (torch.floor((proj.x2d + dmax) / tile_w)
          - torch.floor((proj.x2d - dmax) / tile_w) + 1.0)
    ny = (torch.floor((proj.y2d + dmax) / tile_h)
          - torch.floor((proj.y2d - dmax) / tile_h) + 1.0)
    passable = (nx * ny).to(i32)
    beyond = torch.minimum(torch.clamp(raw_count - enum_cap, min=0), passable)
    n_dropped_rect = (torch.sum(torch.clamp(pass_count - k_cap, min=0))
                      + torch.sum(beyond)).to(i32)
    return tile_key.reshape(-1), gid.reshape(-1), n_dropped_rect


def tile_ranges(sorted_tile: torch.Tensor, num_tiles: int):
    """Per-tile (starts, counts) of a tile-sorted int32 pair list."""
    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=sorted_tile.dtype,
                                  device=sorted_tile.device),
        right=False).to(torch.int32)
    return bounds[:-1], bounds[1:] - bounds[:-1]
