"""Sorted-pair rasterization: sort, record table, composite, and back.

Port of `dynamic3dgaussians_tpu/ops/sorted_raster.py`: the (tile, depth)
key, the merged record table of `_prepare`, `render_sorted`, and the
`custom_vjp` of `_make_composite` as a `torch.autograd.Function` that spans
table -> sort -> forward kernel (K1) and, backwards, the backward kernel
(K2) -> pair-to-gaussian reduction. Differences in the mechanics, not in
the result:

  * The reference sorts every one of the K*N emission slots with its record
    payload. Here the live pairs are compacted first (one host read of their
    count per frame, as the CUDA original reads back its pair count), only
    their keys are sorted, and the table is built by gathering per-gaussian
    columns through the sorted gaussian ids. Sentinel slots never reach the
    table; the kernel never reads past a tile's segment, and the table keeps
    the reference's chunk of zero slack at its end.
  * `prepare_records_static` is the same with no host read, for a step
    captured in a CUDA graph: the live pairs go into a fixed `pair_cap`
    columns (a cumulative sum and a scatter in slot order, where the eager
    form uses `nonzero`), the unused columns sort last under the sentinel
    tile and stay zero, and the count of live pairs past `pair_cap` comes
    back on the device. With pair_cap >= the live count its table, ranges
    and slots are bitwise the eager form's.
  * depth_mode "total" and the two-key fallback (no depth bits left in a
    32-bit key) sort one 64-bit key, (key << 32) | float bits of depth.
    Live pairs have depth > near > 0, where float bits order like floats.
  * The backward reduces the per-pair gradient rows to gaussians the way
    the reference's unsort + K-axis sum does, deterministically: each live
    pair keeps its emission slot (k-major, slot = k * N + gaussian), its
    rows are stored at that slot of a zeroed (rows, K * N) buffer (a plain
    indexed store: slots are unique; the static form's unused columns carry
    distinct unused emission slots, whose rows are zero), and the buffer is
    summed over K. No index_add_: on CUDA it sums with atomics in an order
    that changes from run to run. The depth row's gradient passes to the
    view depth as identity in every depth mode (as the reference does for
    the quantized key depth); the row of ones takes none.

The sorts are stable: pairs with equal keys keep their emission order (one
of the orders the reference's unstable sorts may give) in both forms.
"""

from __future__ import annotations

import torch

from dynamic3dgaussians_tpu_torch.ops.binning import emit_pairs, tile_ranges
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import (
    composite_tiles_bwd, composite_tiles_bwd_torch)
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
    GEOM_ROWS, composite_tiles, composite_tiles_torch)
from dynamic3dgaussians_tpu_torch.ops.projection import Projected

DEPTH_MODES = ("quantized", "exact", "total")
LOG2E = 1.4426950408889634


def depth_key_bits(num_tiles: int) -> int:
    """Bits of quantized depth in a fused (tile | depth) int32 key, or 0 when
    the tile grid leaves fewer than 18 (then a two-key sort is used)."""
    bits_tile = max(1, num_tiles.bit_length())
    bits_z = 31 - bits_tile
    return bits_z if bits_z >= 18 else 0


def fuse_tile_depth_key(tile_key: torch.Tensor, depth: torch.Tensor,
                        bits_z: int) -> torch.Tensor:
    """tile << bits_z | the top bits of float_bits(max(depth, 1e-30)): the
    float-bits fused key of the playback cache (not the affine key of
    `prepare_records`). Positive float bits order like the floats, so the
    key orders by depth down to ~2^-(bits_z - 8) relative. int32."""
    d = torch.clamp(depth, min=1e-30).contiguous()
    shift = 31 - bits_z
    # logical shift right: mask off the sign copies of the arithmetic one
    zq = (d.view(torch.int32) >> shift) & ((1 << (32 - shift)) - 1)
    return (tile_key << bits_z) | zq


def dequantize_depth_key(key: torch.Tensor, bits_z: int) -> torch.Tensor:
    """Bucket-centre depth back out of a float-bits fused key."""
    bits = (key & ((1 << bits_z) - 1)) << (31 - bits_z)
    bits = bits | (1 << (31 - bits_z - 1))
    return bits.contiguous().view(torch.float32)


def round_f16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float16 (round to nearest even) -> float32: the values the
    reference's packed f16 gather transport (`pack2_f16`, `unpack2_f16`)
    delivers. Magnitudes past 65504 become inf, as there."""
    return x.to(torch.float16).to(torch.float32)


def affine_depth_range(live: torch.Tensor, depth: torch.Tensor):
    """(dmin, inv_width) of the live pairs' depth for the affine key."""
    big = torch.full((), 3e38, dtype=torch.float32, device=depth.device)
    dmin = torch.min(torch.where(live, depth, big))
    dmax = torch.max(torch.where(live, depth, -big))
    inv_width = 1.0 / torch.clamp(dmax - dmin, min=1e-20)
    return dmin, inv_width


def fuse_tile_depth_key_affine(tile_key: torch.Tensor, depth: torch.Tensor,
                               bits_z: int, dmin: torch.Tensor,
                               inv_width: torch.Tensor) -> torch.Tensor:
    """tile << bits_z | round(u * (2^bits_z - 1)), u = (depth - dmin) /
    (dmax - dmin) over the frame's live pairs: the depth bits spread
    linearly over the scene's depth range. int32, non-negative."""
    u = torch.clamp((depth - dmin) * inv_width, 0.0, 1.0)
    top = (1 << bits_z) - 1
    # clamp AFTER the cast: for bits_z > 24, float32(2^bits_z - 1) rounds up
    # to 2^bits_z, and u == 1.0 would otherwise overflow into the tile bits
    zq = torch.clamp((u * float(top) + 0.5).to(torch.int32), max=top)
    return (tile_key << bits_z) | zq


def dequantize_depth_key_affine(key: torch.Tensor, bits_z: int,
                                dmin: torch.Tensor, inv_width: torch.Tensor
                                ) -> torch.Tensor:
    """Bucket depth back out of an affine key (error <= half a bucket)."""
    zq = (key & ((1 << bits_z) - 1)).to(torch.float32)
    top = torch.full((), float((1 << bits_z) - 1), dtype=torch.float32,
                     device=key.device)
    return dmin + zq / (top * inv_width)


def _key64(hi32: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(hi32, depth) as one int64 key; depth > 0 for every live pair."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (hi32.to(torch.int64) << 32) | bits


def _sort_live(lt: torch.Tensor, ld: torch.Tensor, live: torch.Tensor,
               bits_z: int, depth_mode: str):
    """(perm, sorted depth) of the pairs' (tile, depth) keys, a stable sort.
    lt, ld: tile and view depth of each pair; `live` marks the pairs whose
    depth spans the affine key (the others carry the sentinel tile, which
    sorts them last)."""
    if bits_z > 0:
        dmin, inv_w = affine_depth_range(live, ld)
        key = fuse_tile_depth_key_affine(lt, ld, bits_z, dmin, inv_w)
        if depth_mode == "total":
            perm = torch.argsort(_key64(key, ld), stable=True)
        else:
            perm = torch.argsort(key, stable=True)
        if depth_mode == "quantized":
            return perm, dequantize_depth_key_affine(key[perm], bits_z, dmin,
                                                     inv_w)
        return perm, ld[perm]
    perm = torch.argsort(_key64(lt, ld), stable=True)
    return perm, ld[perm]


def prepare_records(tile_key: torch.Tensor, gid: torch.Tensor,
                    table: torch.Tensor, *, n_chan: int, num_tiles: int,
                    chunk: int, bits_z: int, depth_mode: str):
    """Sort the live pairs and build the merged record table.

    table: (8 + CV, N) per-gaussian record columns, the depth row holding
    the view depth. Returns (rec_t (8 + CV, NE_pad), starts, counts, slot)
    with NE_pad = (ceil(n_live / chunk) + 1) * chunk and slot (n_live,) the
    emission slot of each sorted pair. Reads the live-pair count from the
    device (one host synchronisation).
    """
    dev = table.device
    depth_row = GEOM_ROWS + n_chan
    live_idx = torch.nonzero(tile_key < num_tiles).squeeze(1)
    n_live = int(live_idx.numel())
    ne_pad = (-(-n_live // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32,
                        device=dev)
    if n_live == 0:
        zeros = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
        return rec_t, zeros, zeros.clone(), live_idx
    lt = tile_key[live_idx]
    lg = gid[live_idx].long()
    ld = table[depth_row, lg]
    perm, sd = _sort_live(lt, ld, torch.ones_like(lt, dtype=torch.bool),
                          bits_z, depth_mode)
    starts, counts = tile_ranges(lt[perm].contiguous(), num_tiles)
    rec_t[:, :n_live] = table[:, lg[perm]]
    rec_t[depth_row, :n_live] = sd
    return rec_t, starts.contiguous(), counts.contiguous(), live_idx[perm]


def prepare_records_static(tile_key: torch.Tensor, gid: torch.Tensor,
                           table: torch.Tensor, *, n_chan: int,
                           num_tiles: int, chunk: int, bits_z: int,
                           depth_mode: str, pair_cap: int):
    """`prepare_records` at a fixed pair capacity, with no host read.

    The live slots are compacted in slot order into `pair_cap` columns,
    and the columns past the live count take the unused emission slots in
    slot order (there are at least as many: pair_cap <= K * N): they carry
    the sentinel tile, sort last, stay zero in the table, and give the
    backward distinct slots whose rows are zero. Returns (rec_t (8 + CV,
    NE_pad), starts, counts, slot (pair_cap,), stats) with NE_pad =
    (ceil(pair_cap / chunk) + 1) * chunk
    and stats int64 [live pairs, live pairs past pair_cap]: when the second
    is zero, rec_t[:, :n_live], starts, counts and slot[:n_live] are bitwise
    `prepare_records`'s; when it is not, the pairs past the capacity are
    missing from the table.
    """
    dev = table.device
    depth_row = GEOM_ROWS + n_chan
    n_slots = tile_key.shape[0]
    i64 = torch.int64
    live = tile_key < num_tiles
    pos = torch.cumsum(live, 0, dtype=i64) - 1
    n_live = pos[-1] + 1
    # the k-th live slot (in slot order) to column k, the k-th unused one
    # to column n_live + k; what falls past the capacity to column
    # pair_cap, which is cut off
    col = torch.where(live, pos, n_live + torch.arange(
        n_slots, dtype=i64, device=dev) - pos - 1)
    col = torch.where(col < pair_cap, col, torch.full_like(col, pair_cap))
    src = torch.empty((pair_cap + 1,), dtype=i64, device=dev)
    src[col] = torch.arange(n_slots, dtype=i64, device=dev)
    src = src[:pair_cap]
    valid = torch.arange(pair_cap, dtype=i64, device=dev) < n_live
    lt = tile_key[src]
    lg = gid[src].long()
    ld = table[depth_row, lg]
    # an unused column's depth (some gaussian's, maybe culled) must not
    # reach the affine key's range or its rounding
    ld = torch.where(valid, ld, torch.zeros_like(ld))
    perm, sd = _sort_live(lt, ld, valid, bits_z, depth_mode)
    valid = valid[perm]
    starts, counts = tile_ranges(lt[perm].contiguous(), num_tiles)
    cols = table[:, lg[perm]]
    cols[depth_row] = sd
    ne_pad = (-(-pair_cap // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32,
                        device=dev)
    rec_t[:, :pair_cap] = torch.where(valid[None], cols,
                                      torch.zeros_like(cols))
    slot = src[perm]
    stats = torch.stack([n_live, torch.clamp(n_live - pair_cap, min=0)])
    return rec_t, starts.contiguous(), counts.contiguous(), slot, stats


def _untile(x, grid_h, grid_w, th, tw, h, w, c):
    img = x.reshape(grid_h, grid_w, th, tw, c).permute(0, 2, 1, 3, 4)
    return img.reshape(grid_h * th, grid_w * tw, c)[:h, :w]


def record_columns(proj: Projected, colors: torch.Tensor,
                   opacity: torch.Tensor) -> torch.Tensor:
    """(8 + CV, N) per-gaussian record columns: x, y, conic a, b, c (scaled
    by log2 e: the kernels work in base-2 log space), opacity, 0, 0, then
    the channels, the view depth, ones and zero rows up to CV % 8 == 0.

    Built with differentiable ops, so autograd chains the log2 e scale of
    the conic rows, as the reference does outside its custom_vjp.
    """
    n = opacity.shape[0]
    log2e = torch.full((), LOG2E, dtype=torch.float32,
                       device=opacity.device)
    zero = torch.zeros((n,), dtype=torch.float32, device=opacity.device)
    n_chan = colors.shape[-1]
    cv_pad = -(-(n_chan + 2) // 8) * 8
    rows = [proj.x2d, proj.y2d, proj.conic_a * log2e, proj.conic_b * log2e,
            proj.conic_c * log2e, opacity, zero, zero, *colors.T,
            proj.depth, torch.ones_like(zero)]
    rows += [zero] * (cv_pad - n_chan - 2)
    return torch.stack(rows)


def emit(h: int, w: int, proj: Projected, opacity: torch.Tensor, *,
         tile_h: int, tile_w: int, max_tiles_per_gaussian: int,
         exact_cull: bool, enum_cap: int):
    """(tile_key, gid, n_dropped_rect) of the K-slot pair emission."""
    grid_h, grid_w = -(-h // tile_h), -(-w // tile_w)
    k_cap = max_tiles_per_gaussian
    cap = (enum_cap or max(16, 2 * k_cap)) if exact_cull else 0
    return emit_pairs(proj, tile_h, tile_w, grid_h, grid_w, k_cap,
                      opacity=opacity if exact_cull else None, enum_cap=cap)


def sorted_records(h: int, w: int, proj: Projected, colors: torch.Tensor,
                   opacity: torch.Tensor, *, tile_h: int = 16,
                   tile_w: int = 16, chunk: int = 128,
                   max_tiles_per_gaussian: int = 8, fused_key: bool = True,
                   depth_mode: str = "quantized", exact_cull: bool = True,
                   enum_cap: int = 0):
    """Emission, sort and merged record table: the kernels' inputs.

    colors (N, C) linear channels, opacity (N,) activated and zeroed for
    invalid gaussians. Returns (rec_t, starts, counts, n_dropped_rect).
    """
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"depth_mode must be one of {DEPTH_MODES}, got "
                         f"{depth_mode!r}")
    num_tiles = -(-h // tile_h) * -(-w // tile_w)
    tile_key, gid, n_dropped_rect = emit(
        h, w, proj, opacity, tile_h=tile_h, tile_w=tile_w,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        exact_cull=exact_cull, enum_cap=enum_cap)
    table = record_columns(proj, colors, opacity).detach()
    bits_z = depth_key_bits(num_tiles) if fused_key else 0
    rec_t, starts, counts, _ = prepare_records(
        tile_key, gid, table, n_chan=colors.shape[-1], num_tiles=num_tiles,
        chunk=chunk, bits_z=bits_z, depth_mode=depth_mode)
    return rec_t, starts, counts, n_dropped_rect


class _SortComposite(torch.autograd.Function):
    """table -> sort -> K1 forward; K2 -> pair-to-gaussian sum backward.

    forward(table (8 + CV, N), tile_key (K*N,), gid (K*N,), spec,
    pair_cap=None, pair_stats=False) returns the raw accumulators (T, P,
    CV), and with a pair_cap or pair_stats also int64 [live pairs, live
    pairs past pair_cap] (no gradient): `prepare_records_static`'s, or the
    eager table's [live pairs, 0]. spec = (n_chan, num_tiles, grid_w,
    tile_h, tile_w, chunk, bits_z, depth_mode, use_kernel).
    """

    @staticmethod
    def forward(ctx, table, tile_key, gid, spec, pair_cap=None,
                pair_stats=False):
        (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, bits_z,
         depth_mode, use_kernel) = spec
        kw = dict(n_chan=n_chan, num_tiles=num_tiles, chunk=chunk,
                  bits_z=bits_z, depth_mode=depth_mode)
        if pair_cap is None:
            rec_t, starts, counts, slot = prepare_records(
                tile_key, gid, table.detach(), **kw)
            stats = torch.tensor([slot.shape[0], 0], dtype=torch.int64,
                                 device=table.device) if pair_stats else None
        else:
            rec_t, starts, counts, slot, stats = prepare_records_static(
                tile_key, gid, table.detach(), pair_cap=pair_cap, **kw)
        composite = composite_tiles if use_kernel else composite_tiles_torch
        raw, log_t, n_active = composite(
            rec_t, starts, counts, num_tiles=num_tiles, grid_w=grid_w,
            tile_h=tile_h, tile_w=tile_w, chunk=chunk)
        ctx.save_for_backward(rec_t, starts, counts, log_t, n_active, slot)
        ctx.spec = spec
        ctx.n_slots = tile_key.shape[0]
        ctx.n_gauss = table.shape[1]
        if stats is None:
            return raw
        ctx.mark_non_differentiable(stats)
        return raw, stats

    @staticmethod
    def backward(ctx, d_raw, *_):
        rec_t, starts, counts, log_t, n_active, slot = ctx.saved_tensors
        (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, _, _,
         use_kernel) = ctx.spec
        bwd = composite_tiles_bwd if use_kernel else composite_tiles_bwd_torch
        d_out = bwd(rec_t, starts, counts, n_active.reshape(-1), log_t,
                    d_raw.contiguous(), num_tiles=num_tiles, grid_w=grid_w,
                    tile_h=tile_h, tile_w=tile_w, chunk=chunk)
        n_rows = rec_t.shape[0]
        per_slot = torch.zeros((n_rows, ctx.n_slots), dtype=torch.float32,
                               device=rec_t.device)
        per_slot[:, slot] = d_out[:, :slot.shape[0]]
        d_table = per_slot.reshape(n_rows, -1, ctx.n_gauss).sum(1)
        d_table[GEOM_ROWS + n_chan + 1:] = 0.0     # ones and pad rows
        return d_table, None, None, None, None, None


def render_sorted(h: int, w: int, proj: Projected, colors: torch.Tensor,
                  opacity: torch.Tensor, bg: torch.Tensor, *,
                  tile_h: int = 16, tile_w: int = 16, chunk: int = 128,
                  max_tiles_per_gaussian: int = 8, fused_key: bool = True,
                  depth_mode: str = "quantized", exact_cull: bool = True,
                  enum_cap: int = 0, use_kernel: bool = True,
                  pair_cap: int = None, pair_stats: bool = False):
    """Differentiable sorted-pair render.

    colors (N, C) linear channels, opacity (N,) activated and zeroed for
    invalid gaussians, bg (C,) composited as bg * (1 - alpha). use_kernel
    picks the CUDA kernels (`composite_tiles`, `composite_tiles_bwd`) or
    their plain versions. Gradients reach proj's x2d, y2d, conic and depth,
    colors and opacity. pair_cap: the table's fixed pair capacity
    (`prepare_records_static`, no host read), or None for the eager table.

    Returns (channels (H, W, C), depth (H, W), alpha (H, W), n_dropped_rect,
    pair_stats): pair_stats is the static table's int64 [live pairs, live
    pairs past pair_cap]; for the eager table [live pairs, 0] when
    `pair_stats` asks for it, else None.
    """
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"depth_mode must be one of {DEPTH_MODES}, got "
                         f"{depth_mode!r}")
    grid_h, grid_w = -(-h // tile_h), -(-w // tile_w)
    num_tiles = grid_h * grid_w
    n_chan = colors.shape[-1]
    tile_key, gid, n_dropped_rect = emit(
        h, w, proj, opacity.detach(), tile_h=tile_h, tile_w=tile_w,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        exact_cull=exact_cull, enum_cap=enum_cap)
    table = record_columns(proj, colors, opacity)
    bits_z = depth_key_bits(num_tiles) if fused_key else 0
    spec = (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, bits_z,
            depth_mode, use_kernel)
    if pair_cap is None and not pair_stats:
        raw, stats = _SortComposite.apply(table, tile_key, gid, spec), None
    else:
        raw, stats = _SortComposite.apply(table, tile_key, gid, spec,
                                          pair_cap, True)

    alpha_t = raw[..., n_chan + 1]
    depth_t = raw[..., n_chan]
    chan_t = raw[..., :n_chan] + (1.0 - alpha_t[..., None]) * bg
    channels = _untile(chan_t, grid_h, grid_w, tile_h, tile_w, h, w, n_chan)
    depth_img = _untile(depth_t[..., None], grid_h, grid_w, tile_h, tile_w,
                        h, w, 1)[..., 0]
    alpha_img = _untile(alpha_t[..., None], grid_h, grid_w, tile_h, tile_w,
                        h, w, 1)[..., 0]
    return channels, depth_img, alpha_img, n_dropped_rect, stats
