"""Tile binning: (gaussian, tile) pair emission, sort and per-tile ranges.

Port of `dynamic3dgaussians_tpu/ops/binning.py` (`emit_pairs`,
`tile_ranges`, `sort_pairs`, `bin_gaussians`). Every gaussian owns K =
`max_tiles_per_gaussian` emission slots, laid out k-major (slot = k * N +
gaussian), with `num_tiles` as the sentinel of an unused slot. Keeping the
K slots means `n_dropped_rect` counts the same drops as the reference:
pairs that a gaussian's K slots could not hold. `bin_gaussians` feeds the
plain "tiled" render path, with the reference's fixed pair capacity.

The sorted-pair paths take the live pairs only (`Pairs`): compacted in
slot order, each with its tile key and its emission slot. The emission
kernel E1 (`ops/cuda/emit.py::emit_pairs_cuda`) writes that form on the
card; its plain version is `emit_live_pairs`, the K-slot `emit_pairs`
followed by `compact_pairs`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, tile_rect


class Pairs(NamedTuple):
    """The live (gaussian, tile) pairs of an emission, compacted in slot
    order (slot = k * N + gaussian, k-major: the order of `torch.nonzero`
    over the K-slot keys). With a capacity M the first M live pairs are
    kept and the columns past the live count hold the sentinel tile and
    the sink slot `n_slots`; without one M is the live count."""

    tile: torch.Tensor            # (M,) int32 tile key
    slot: torch.Tensor            # (M,) int32 emission slot
    counts: torch.Tensor          # (2,) int64 [live pairs, past the capacity]
    n_dropped_rect: torch.Tensor  # () int32
    n_slots: int                  # K * N, the sink slot


class TileBins(NamedTuple):
    gaussian_ids: torch.Tensor   # (pair_capacity,) int32, by (tile, depth)
    tile_starts: torch.Tensor    # (num_tiles,) int32 index into gaussian_ids
    tile_counts: torch.Tensor    # (num_tiles,) int32 pairs per tile
    num_pairs: torch.Tensor      # () int32 pairs emitted, before the cap
    n_dropped_capacity: torch.Tensor  # () int32 pairs past pair_capacity
    n_dropped_rect: torch.Tensor      # () int32 pairs past the K slots


def slot_gaussian_ids(n: int, k_cap: int, device) -> torch.Tensor:
    """(K*N,) int32 gaussian id of each k-major emission slot."""
    return torch.arange(n, dtype=torch.int32, device=device).expand(
        k_cap, n).reshape(-1)


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
    gid = slot_gaussian_ids(n, k_cap, dev)

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
        return tile_key.reshape(-1), gid, n_dropped_rect

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
    return tile_key.reshape(-1), gid, n_dropped_rect


def compact_pairs(tile_key: torch.Tensor, num_tiles: int,
                  pair_cap: int = None):
    """(tile (M,) int32, slot (M,) int32, counts (2,) int64) of the live
    slots of K-slot keys (`emit_pairs`), in slot order: `nonzero`, or with
    a `pair_cap` a cumulative sum and a scatter (no host read) into M =
    pair_cap columns, the sentinel tile and the sink slot K*N past the
    live count. counts: [live pairs, live pairs past pair_cap]."""
    n_slots = tile_key.shape[0]
    dev = tile_key.device
    live = tile_key < num_tiles
    if pair_cap is None:
        idx = torch.nonzero(live).squeeze(1)
        n_live = torch.full((), idx.numel(), dtype=torch.int64, device=dev)
        return (tile_key[idx], idx.to(torch.int32),
                torch.stack([n_live, torch.zeros_like(n_live)]))
    pos = torch.cumsum(live, 0, dtype=torch.int64) - 1
    n_live = pos[-1] + 1 if n_slots else torch.zeros(
        (), dtype=torch.int64, device=dev)
    # the k-th live slot to column k; the rest to column pair_cap, cut off
    col = torch.where(live & (pos < pair_cap), pos,
                      torch.full_like(pos, pair_cap))
    tile = torch.full((pair_cap + 1,), num_tiles, dtype=torch.int32,
                      device=dev)
    slot = torch.full((pair_cap + 1,), n_slots, dtype=torch.int32,
                      device=dev)
    tile[col] = tile_key.to(torch.int32)
    slot[col] = torch.arange(n_slots, dtype=torch.int32, device=dev)
    return (tile[:pair_cap], slot[:pair_cap],
            torch.stack([n_live, torch.clamp(n_live - pair_cap, min=0)]))


def emit_live_pairs(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                    grid_w: int, max_tiles_per_gaussian: int,
                    opacity: torch.Tensor = None, enum_cap: int = 0,
                    pair_cap: int = None) -> Pairs:
    """The plain version of the kernel E1: `emit_pairs`, then
    `compact_pairs` of its keys."""
    tile_key, _, n_dropped_rect = emit_pairs(
        proj, tile_h, tile_w, grid_h, grid_w, max_tiles_per_gaussian,
        opacity=opacity, enum_cap=enum_cap)
    tile, slot, counts = compact_pairs(tile_key, grid_h * grid_w, pair_cap)
    return Pairs(tile, slot, counts, n_dropped_rect, tile_key.shape[0])


def tile_ranges(sorted_tile: torch.Tensor, num_tiles: int):
    """Per-tile (starts, counts) of a tile-sorted int32 pair list."""
    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=sorted_tile.dtype,
                                  device=sorted_tile.device),
        right=False).to(torch.int32)
    return bounds[:-1], bounds[1:] - bounds[:-1]


def sort_pairs(tile_key: torch.Tensor, depth_key: torch.Tensor,
               payload: Sequence[torch.Tensor]):
    """Sort pairs by (tile, depth), carrying payload rows along: a stable
    sort by depth, then a stable sort by tile. Returns (sorted tile_key,
    sorted depth_key, sorted payload list). Equal (tile, depth) keys keep
    their emission order, one of the orders the reference's unstable sort
    may give."""
    order = torch.sort(depth_key, stable=True).indices
    order = order[torch.sort(tile_key[order], stable=True).indices]
    return tile_key[order], depth_key[order], [p[order] for p in payload]


def bin_gaussians(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                  grid_w: int, pair_capacity: int,
                  max_tiles_per_gaussian: int = 16) -> TileBins:
    """Per-tile, depth-sorted gaussian id lists in a fixed pair capacity.

    Emission without the exact cull, the (tile, depth) sort with culled
    gaussians at depth inf, then the first `pair_capacity` pairs; the live
    pairs past it are counted in `n_dropped_capacity`.
    """
    num_tiles = grid_h * grid_w
    i32 = torch.int32
    tile_key, gid, n_dropped_rect = emit_pairs(proj, tile_h, tile_w, grid_h,
                                               grid_w, max_tiles_per_gaussian)
    depth = torch.where(proj.valid, proj.depth,
                        torch.full_like(proj.depth, float("inf")))
    sorted_tile, _, (sorted_gid,) = sort_pairs(
        tile_key, depth.repeat(max_tiles_per_gaussian), (gid,))
    num_pairs = torch.sum((sorted_tile < num_tiles).to(i32))
    cap = min(pair_capacity, sorted_tile.shape[0])
    sorted_tile, sorted_gid = sorted_tile[:cap], sorted_gid[:cap]
    if cap < pair_capacity:
        pad = pair_capacity - cap
        sorted_tile = torch.cat([sorted_tile, torch.full(
            (pad,), num_tiles, dtype=i32, device=sorted_tile.device)])
        sorted_gid = torch.cat([sorted_gid, torch.zeros(
            (pad,), dtype=i32, device=sorted_gid.device)])
    starts, counts = tile_ranges(sorted_tile.contiguous(), num_tiles)
    return TileBins(
        gaussian_ids=sorted_gid, tile_starts=starts, tile_counts=counts,
        num_pairs=num_pairs.to(i32),
        n_dropped_capacity=torch.clamp(num_pairs - cap, min=0).to(i32),
        n_dropped_rect=n_dropped_rect)
