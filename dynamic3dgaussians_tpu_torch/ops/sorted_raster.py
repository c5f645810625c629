"""Sorted-pair rasterization: sort, record table, composite, and back.

Port of `dynamic3dgaussians_tpu/ops/sorted_raster.py`: the (tile, depth)
key, the merged record table of `_prepare`, `render_sorted`, and the
`custom_vjp` of `_make_composite` as a `torch.autograd.Function` that spans
table -> sort -> forward kernel (K1) and, backwards, the backward kernel
(K2) -> pair-to-gaussian reduction. Differences in the mechanics, not in
the result:

  * The reference sorts every one of the K*N emission slots with its record
    payload. Here the emission hands over the live pairs only, compacted in
    slot order (`binning.Pairs`: on the card the kernel E1 writes them, one
    host read of their count per frame, as the CUDA original reads back its
    pair count), only their keys are sorted, and the table is built by
    gathering per-gaussian columns through the sorted gaussian ids (slot %
    N). Sentinel slots never reach the table; the kernel never reads past a
    tile's segment, and the table keeps the reference's chunk of zero slack
    at its end.
  * `prepare_records_static` is the same with no host read, for a step
    captured in a CUDA graph: the emission writes the live pairs into a
    fixed `pair_cap` columns, the unused columns carry the sentinel tile
    and the sink slot K*N, sort last and stay zero, and the count of live
    pairs past `pair_cap` comes back on the device. With pair_cap >= the
    live count its table, ranges and slots are bitwise the eager form's.
  * depth_mode "total" and the two-key fallback (no depth bits left in a
    32-bit key) sort one 64-bit key, (key << 32) | float bits of depth.
    Live pairs have depth > near > 0, where float bits order like floats.
  * The backward reduces the per-pair gradient rows to gaussians the way
    the reference's unsort + K-axis sum does, deterministically: each live
    pair keeps its emission slot (k-major, slot = k * N + gaussian), and
    each gaussian's rows are summed over its live pairs in ascending k,
    from +0.0, adding only live terms (`ops/cuda/unsort.py`: on the card
    the kernel U1, `unsort_sum_cuda`, through an int map from slot to
    column and a pair-major copy of the gradient columns; its plain
    version `unsort_sum_plain`, bitwise the same). The static form's
    unused columns carry the sink slot K * N and add nothing; a
    gaussian's live slots may be any subset of its K (a tile stripe's).
    No float (rows, K * N) buffer and no float atomics, so a replayed
    window repeats bitwise. `slot_sum`, the zeroed per-slot buffer
    summed over K, stays as the yardstick the tests hold both to. The
    depth row's gradient passes to the view depth as identity in every
    depth mode (as the reference does for the quantized key depth); the
    row of ones and the pad rows take none.

The sorts are stable: pairs with equal keys keep their emission order (one
of the orders the reference's unstable sorts may give) in both forms.

The reference's settings that change the numerics (`Variant`) act here
and in the kernels:

  * pack_records (with a fused key, bits_z > 0): the reference sends the
    forward payload through its sort as f16 pairs (`pack2_f16`) and the
    backward's gradient rows through its unsort as bf16 pairs
    (`pack2_bf16`). The port has no payload sort, so it applies the same
    rounding to the gathered table (`pack_columns`): x and y relative to
    the pair's own tile (its sorted tile key), then rounded to f16, then
    the tile origin added back; conic a, b, c, opacity and the channel
    rows rounded to f16; the depth and ones rows as they are. In the
    backward the gradient rows of x, y, the conic, opacity, depth and the
    channels are rounded as `pack2_bf16` rounds (`round_bf16`) before the
    sum over K.
  * power_impl="mxu_fused": rows 6 and 7 of the table hold log2 opacity
    and its clamp (`fused_opacity_rows`, from the opacity row after the
    f16 rounding), for K1's FUSED variant; the backward runs K2's default
    body, as the reference's does.
  * kernel_precision="default": K1's and K2's BF16 variants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic3dgaussians_tpu_torch.ops.binning import (Pairs, emit_live_pairs,
                                                      tile_ranges)
from dynamic3dgaussians_tpu_torch.ops.cuda.emit import emit_pairs_cuda
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import (
    composite_tiles_bwd, composite_tiles_bwd_torch)
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
    GEOM_ROWS, LOG2_ALPHA_MAX, composite_tiles, composite_tiles_torch)
from dynamic3dgaussians_tpu_torch.ops.cuda.unsort import (unsort_sum_cuda,
                                                          unsort_sum_plain)
from dynamic3dgaussians_tpu_torch.ops.projection import Projected

DEPTH_MODES = ("quantized", "exact", "total")
LOG2E = 1.4426950408889634


class Variant(NamedTuple):
    """The reference's raster settings that change what the sorted-pair
    path computes (`RasterConfig` fields of the same names)."""

    pack_records: bool = False
    power_impl: str = "vpu"
    kernel_precision: str = "highest"

    def kernel_kw(self) -> dict:
        """K1's variant keywords (K2 takes `precision` alone)."""
        return dict(precision=self.kernel_precision,
                    power_impl=self.power_impl)


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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the bf16 value the reference's gradient transport
    (`pack2_bf16`, `unpack2_bf16`) delivers, as float32: 0x8000 added to
    the bits of a finite value (round to nearest, ties away from zero, the
    carry reaching the exponent, so past the largest bf16 it is inf), then
    the low 16 bits cleared; inf and NaN only truncated."""
    bits = x.contiguous().view(torch.int32)
    bits = torch.where(torch.isfinite(x), bits + 0x8000, bits)
    return (bits & -65536).view(torch.float32)


def fused_opacity_rows(op: torch.Tensor):
    """(r6, r7) of the fused variant from the opacity row: r6 = log2(max(op,
    2^-100)), r7 = min(r6, log2 0.99), as the reference's `_prepare`
    fills them under power_impl="mxu_fused"."""
    r6 = torch.log2(torch.clamp(op, min=2.0 ** -100))
    return r6, torch.clamp(r6, max=LOG2_ALPHA_MAX)


def f16_rows(n_chan: int):
    """The table rows the reference's record pack sends as f16 besides x and
    y, as slices: conic a, b, c and opacity; the channels. (Slices, not
    an index list: a list becomes a host tensor copied to the device,
    which a CUDA graph capture refuses.)"""
    return slice(2, 6), slice(GEOM_ROWS, GEOM_ROWS + n_chan)


def pack_columns(cols: torch.Tensor, tile: torch.Tensor, *, n_chan: int,
                 grid_w: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """The record pack's rounding of gathered table columns (8 + CV, n),
    in place: x and y relative to the origin of `tile` (each column's
    tile), rounded to f16 and moved back; `f16_rows` rounded to f16."""
    tx = ((tile % grid_w) * tile_w).to(torch.float32)
    ty = (torch.div(tile, grid_w, rounding_mode="floor")
          * tile_h).to(torch.float32)
    cols[0] = round_f16(cols[0] - tx) + tx
    cols[1] = round_f16(cols[1] - ty) + ty
    for rows in f16_rows(n_chan):
        cols[rows] = round_f16(cols[rows])
    return cols


def _finish_columns(cols, tile, *, n_chan, bits_z, variant, grid_w, tile_h,
                    tile_w):
    """The variant's rounding and rows of gathered columns, in place."""
    if variant.pack_records and bits_z > 0:
        if grid_w <= 0:
            raise ValueError("pack_records needs the tile grid (grid_w, "
                             "tile_h, tile_w)")
        pack_columns(cols, tile, n_chan=n_chan, grid_w=grid_w,
                     tile_h=tile_h, tile_w=tile_w)
    if variant.power_impl == "mxu_fused":
        cols[6], cols[7] = fused_opacity_rows(cols[5])
    return cols


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


def prepare_records(pairs: Pairs, table: torch.Tensor, *, n_chan: int,
                    num_tiles: int, chunk: int, bits_z: int,
                    depth_mode: str, variant: Variant = Variant(),
                    grid_w: int = 0, tile_h: int = 16, tile_w: int = 16):
    """Sort the live pairs and build the merged record table.

    pairs: the emission's live pairs, as many as there are (no capacity).
    table: (8 + CV, N) per-gaussian record columns, the depth row holding
    the view depth. Returns (rec_t (8 + CV, NE_pad), starts, counts, slot)
    with NE_pad = (ceil(n_live / chunk) + 1) * chunk and slot (n_live,)
    int64 the emission slot of each sorted pair. `variant`'s pack (which
    needs the tile grid: grid_w, tile_h, tile_w) and fused rows apply to
    the sorted columns.
    """
    dev = table.device
    depth_row = GEOM_ROWS + n_chan
    n_live = pairs.tile.shape[0]
    ne_pad = (-(-n_live // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32,
                        device=dev)
    if n_live == 0:
        zeros = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
        return rec_t, zeros, zeros.clone(), pairs.slot.long()
    lt = pairs.tile
    lg = pairs.slot.long() % table.shape[1]
    ld = table[depth_row, lg]
    perm, sd = _sort_live(lt, ld, torch.ones_like(lt, dtype=torch.bool),
                          bits_z, depth_mode)
    st = lt[perm].contiguous()
    starts, counts = tile_ranges(st, num_tiles)
    rec_t[:, :n_live] = _finish_columns(
        table[:, lg[perm]], st, n_chan=n_chan, bits_z=bits_z,
        variant=variant, grid_w=grid_w, tile_h=tile_h, tile_w=tile_w)
    rec_t[depth_row, :n_live] = sd
    return (rec_t, starts.contiguous(), counts.contiguous(),
            pairs.slot[perm].long())


def prepare_records_static(pairs: Pairs, table: torch.Tensor, *,
                           n_chan: int, num_tiles: int, chunk: int,
                           bits_z: int, depth_mode: str, pair_cap: int,
                           variant: Variant = Variant(), grid_w: int = 0,
                           tile_h: int = 16, tile_w: int = 16):
    """`prepare_records` at a fixed pair capacity, with no host read.

    pairs: the emission at capacity `pair_cap`: the first pair_cap live
    pairs in slot order, then columns of the sentinel tile and the sink
    slot K * N, which sort last, stay zero in the table and take the
    backward's sink column. Returns (rec_t (8 + CV, NE_pad), starts,
    counts, slot (pair_cap,) int64, stats) with NE_pad = (ceil(pair_cap /
    chunk) + 1) * chunk and stats the emission's int64 [live pairs, live
    pairs past pair_cap]: when the second is zero, rec_t[:, :n_live],
    starts, counts and slot[:n_live] are bitwise `prepare_records`'s; when
    it is not, the pairs past the capacity are missing from the table.
    """
    if pairs.tile.shape[0] != pair_cap:
        raise ValueError(f"the emission holds {pairs.tile.shape[0]} pairs, "
                         f"the table's capacity is {pair_cap}")
    dev = table.device
    depth_row = GEOM_ROWS + n_chan
    n_live = pairs.counts[0]
    valid = torch.arange(pair_cap, dtype=torch.int64, device=dev) < n_live
    lt = pairs.tile
    src = pairs.slot.long()
    lg = src % table.shape[1]
    ld = table[depth_row, lg]
    # an unused column's depth (some gaussian's, maybe culled) must not
    # reach the affine key's range or its rounding
    ld = torch.where(valid, ld, torch.zeros_like(ld))
    perm, sd = _sort_live(lt, ld, valid, bits_z, depth_mode)
    valid = valid[perm]
    st = lt[perm].contiguous()
    starts, counts = tile_ranges(st, num_tiles)
    cols = _finish_columns(table[:, lg[perm]], st, n_chan=n_chan,
                           bits_z=bits_z, variant=variant, grid_w=grid_w,
                           tile_h=tile_h, tile_w=tile_w)
    cols[depth_row] = sd
    ne_pad = (-(-pair_cap // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32,
                        device=dev)
    rec_t[:, :pair_cap] = torch.where(valid[None], cols,
                                      torch.zeros_like(cols))
    return (rec_t, starts.contiguous(), counts.contiguous(), src[perm],
            pairs.counts)


# Columns of the per-slot buffer past its K * N slots: the sink, and 3
# more, so that a row stays a multiple of 4 floats where K * N is one.
# CUDA's reduction over K vectorizes its outputs by 4 only when every
# row is, and a reduction vectorized otherwise sums in another order: with
# SINK_PAD columns the sum is bitwise that of a (rows, K * N) buffer.
SINK_PAD = 4


def slot_sum(slot: torch.Tensor, d_pairs: torch.Tensor, n_slots: int,
             n_gauss: int) -> torch.Tensor:
    """(rows, N): the columns of d_pairs (rows, M) stored at their emission
    slots (M,) of a zeroed per-slot buffer and summed over K (slot = k * N
    + gaussian; slot n_slots = K * N is the sink, dropped). The yardstick
    of `ops/cuda/unsort.py`'s sum, for tests and `chip_smoke.py`: the
    backward runs no (rows, K * N) buffer."""
    rows = d_pairs.shape[0]
    per_slot = torch.zeros((rows, n_slots + SINK_PAD), dtype=d_pairs.dtype,
                           device=d_pairs.device)
    per_slot[:, slot] = d_pairs
    return per_slot[:, :n_slots].view(rows, -1, n_gauss).sum(1)


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
         exact_cull: bool, enum_cap: int, use_kernel: bool = True,
         pair_cap: int = None) -> Pairs:
    """The live pairs of the emission (`binning.Pairs`, at `pair_cap`
    columns when given): through the kernel E1 (`emit_pairs_cuda`) or,
    with use_kernel False, its plain version `emit_live_pairs`."""
    grid_h, grid_w = -(-h // tile_h), -(-w // tile_w)
    k_cap = max_tiles_per_gaussian
    cap = (enum_cap or max(16, 2 * k_cap)) if exact_cull else 0
    fn = emit_pairs_cuda if use_kernel else emit_live_pairs
    return fn(proj, tile_h, tile_w, grid_h, grid_w, k_cap,
              opacity=opacity if exact_cull else None, enum_cap=cap,
              pair_cap=pair_cap)


def sorted_records(h: int, w: int, proj: Projected, colors: torch.Tensor,
                   opacity: torch.Tensor, *, tile_h: int = 16,
                   tile_w: int = 16, chunk: int = 128,
                   max_tiles_per_gaussian: int = 8, fused_key: bool = True,
                   depth_mode: str = "quantized", exact_cull: bool = True,
                   enum_cap: int = 0, variant: Variant = Variant()):
    """Emission (through E1 on the card), sort and merged record table:
    the kernels' inputs.

    colors (N, C) linear channels, opacity (N,) activated and zeroed for
    invalid gaussians. Returns (rec_t, starts, counts, n_dropped_rect).
    """
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"depth_mode must be one of {DEPTH_MODES}, got "
                         f"{depth_mode!r}")
    num_tiles = -(-h // tile_h) * -(-w // tile_w)
    pairs = emit(h, w, proj, opacity, tile_h=tile_h, tile_w=tile_w,
                 max_tiles_per_gaussian=max_tiles_per_gaussian,
                 exact_cull=exact_cull, enum_cap=enum_cap)
    table = record_columns(proj, colors, opacity).detach()
    bits_z = depth_key_bits(num_tiles) if fused_key else 0
    rec_t, starts, counts, _ = prepare_records(
        pairs, table, n_chan=colors.shape[-1], num_tiles=num_tiles,
        chunk=chunk, bits_z=bits_z, depth_mode=depth_mode, variant=variant,
        grid_w=-(-w // tile_w), tile_h=tile_h, tile_w=tile_w)
    return rec_t, starts, counts, pairs.n_dropped_rect


class _SortComposite(torch.autograd.Function):
    """table -> sort -> K1 forward; K2 -> pair-to-gaussian sum (U1)
    backward.

    forward(table (8 + CV, N), pairs (`binning.Pairs`, at pair_cap
    columns when it is given), spec, pair_cap=None, pair_stats=False)
    returns the raw accumulators (T, P, CV), and with a pair_cap or
    pair_stats also the emission's int64 [live pairs, live pairs past
    pair_cap] (no gradient). spec = (n_chan, num_tiles, grid_w,
    tile_h, tile_w, chunk, bits_z, depth_mode, use_kernel, variant).
    """

    @staticmethod
    def forward(ctx, table, pairs, spec, pair_cap=None, pair_stats=False):
        (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, bits_z,
         depth_mode, use_kernel, variant) = spec
        kw = dict(n_chan=n_chan, num_tiles=num_tiles, chunk=chunk,
                  bits_z=bits_z, depth_mode=depth_mode, variant=variant,
                  grid_w=grid_w, tile_h=tile_h, tile_w=tile_w)
        if pair_cap is None:
            rec_t, starts, counts, slot = prepare_records(
                pairs, table.detach(), **kw)
            stats = pairs.counts if pair_stats else None
        else:
            rec_t, starts, counts, slot, stats = prepare_records_static(
                pairs, table.detach(), pair_cap=pair_cap, **kw)
        composite = composite_tiles if use_kernel else composite_tiles_torch
        raw, log_t, n_active = composite(
            rec_t, starts, counts, num_tiles=num_tiles, grid_w=grid_w,
            tile_h=tile_h, tile_w=tile_w, chunk=chunk, **variant.kernel_kw())
        ctx.save_for_backward(rec_t, starts, counts, log_t, n_active, slot)
        ctx.spec = spec
        ctx.n_slots = pairs.n_slots
        ctx.n_gauss = table.shape[1]
        if stats is None:
            return raw
        ctx.mark_non_differentiable(stats)
        return raw, stats

    @staticmethod
    def backward(ctx, d_raw, *_):
        rec_t, starts, counts, log_t, n_active, slot = ctx.saved_tensors
        (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, bits_z, _,
         use_kernel, variant) = ctx.spec
        bwd = composite_tiles_bwd if use_kernel else composite_tiles_bwd_torch
        d_out = bwd(rec_t, starts, counts, n_active.reshape(-1), log_t,
                    d_raw.contiguous(), num_tiles=num_tiles, grid_w=grid_w,
                    tile_h=tile_h, tile_w=tile_w, chunk=chunk,
                    precision=variant.kernel_precision)
        d_pairs = d_out[:, :slot.shape[0]]
        if variant.pack_records and bits_z > 0:
            # the rows the reference's unsort carries: x, y, the conic,
            # opacity; the channels and depth
            for rows in (slice(0, 6),
                         slice(GEOM_ROWS, GEOM_ROWS + n_chan + 1)):
                d_pairs[rows] = round_bf16(d_pairs[rows])
        # the ones and pad rows, past the depth row, take no gradient
        unsort = unsort_sum_cuda if use_kernel else unsort_sum_plain
        d_table = unsort(slot, d_pairs, ctx.n_slots, ctx.n_gauss,
                         GEOM_ROWS + n_chan + 1)
        return d_table, None, None, None, None


def render_sorted(h: int, w: int, proj: Projected, colors: torch.Tensor,
                  opacity: torch.Tensor, bg: torch.Tensor, *,
                  tile_h: int = 16, tile_w: int = 16, chunk: int = 128,
                  max_tiles_per_gaussian: int = 8, fused_key: bool = True,
                  depth_mode: str = "quantized", exact_cull: bool = True,
                  enum_cap: int = 0, use_kernel: bool = True,
                  pair_cap: int = None, pair_stats: bool = False,
                  variant: Variant = Variant()):
    """Differentiable sorted-pair render.

    colors (N, C) linear channels, opacity (N,) activated and zeroed for
    invalid gaussians, bg (C,) composited as bg * (1 - alpha). use_kernel
    picks the CUDA kernels (`emit_pairs_cuda`, `composite_tiles`,
    `composite_tiles_bwd`) or their plain versions. Gradients reach proj's
    x2d, y2d, conic and depth, colors and opacity. pair_cap: the table's
    fixed pair capacity (`prepare_records_static`, no host read), or None
    for the eager table.

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
    pairs = emit(h, w, proj, opacity.detach(), tile_h=tile_h, tile_w=tile_w,
                 max_tiles_per_gaussian=max_tiles_per_gaussian,
                 exact_cull=exact_cull, enum_cap=enum_cap,
                 use_kernel=use_kernel, pair_cap=pair_cap)
    table = record_columns(proj, colors, opacity)
    bits_z = depth_key_bits(num_tiles) if fused_key else 0
    spec = (n_chan, num_tiles, grid_w, tile_h, tile_w, chunk, bits_z,
            depth_mode, use_kernel, variant)
    if pair_cap is None and not pair_stats:
        raw, stats = _SortComposite.apply(table, pairs, spec), None
    else:
        raw, stats = _SortComposite.apply(table, pairs, spec, pair_cap, True)

    alpha_t = raw[..., n_chan + 1]
    depth_t = raw[..., n_chan]
    chan_t = raw[..., :n_chan] + (1.0 - alpha_t[..., None]) * bg
    channels = _untile(chan_t, grid_h, grid_w, tile_h, tile_w, h, w, n_chan)
    depth_img = _untile(depth_t[..., None], grid_h, grid_w, tile_h, tile_w,
                        h, w, 1)[..., 0]
    alpha_img = _untile(alpha_t[..., None], grid_h, grid_w, tile_h, tile_w,
                        h, w, 1)[..., 0]
    return channels, depth_img, alpha_img, pairs.n_dropped_rect, stats
