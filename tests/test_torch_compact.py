"""The sorted-pair consumers of the compacted emission, on the CPU.

The emission hands the record tables the live pairs only, compacted in
slot order (`ops/binning.py::Pairs`; on the card the kernel E1 writes
them). Here, on drawn tables (`torch_emit_model.emit_table`: dead rows,
rects past enum_cap, bounds on the gate):

  * `prepare_records` and `prepare_records_static` fed the compacted form
    give rec_t, starts, counts and slot bitwise those that the K-slot form
    gave them, through a copy of those K-slot versions kept here
    (`kslot_prepare_records`, `kslot_prepare_records_static`: `nonzero`
    over the K*N slot keys, and the static form's cumulative sum and
    scatter, whose unused columns took distinct unused slots), in every
    depth mode, with and without the fused key, with the record pack;
  * `_SortComposite`'s gradient of the table is bitwise between the eager
    form and the static form, whose unused columns all go to the sink
    column of the per-slot buffer;
  * the per-slot buffer with its sink column (`slot_sum`) sums over K
    bitwise as the K*N-column buffer did.
"""

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops import binning as tbin
from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
from torch_emit_model import GRID_H, GRID_W, H, TILE, W, emit_table

torch.set_num_threads(1)

NUM_TILES = GRID_H * GRID_W
K = 64
ENUM = 128


def kslot_prepare_records(tile_key, gid, table, *, n_chan, num_tiles, chunk,
                          bits_z, depth_mode, variant=SR.Variant(),
                          grid_w=0, tile_h=16, tile_w=16):
    """`prepare_records` on the K-slot keys, as it was before the
    emission compacted them."""
    depth_row = SR.GEOM_ROWS + n_chan
    live_idx = torch.nonzero(tile_key < num_tiles).squeeze(1)
    n_live = int(live_idx.numel())
    ne_pad = (-(-n_live // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32)
    lt = tile_key[live_idx]
    lg = gid[live_idx].long()
    ld = table[depth_row, lg]
    perm, sd = SR._sort_live(lt, ld, torch.ones_like(lt, dtype=torch.bool),
                             bits_z, depth_mode)
    st = lt[perm].contiguous()
    starts, counts = tbin.tile_ranges(st, num_tiles)
    rec_t[:, :n_live] = SR._finish_columns(
        table[:, lg[perm]], st, n_chan=n_chan, bits_z=bits_z,
        variant=variant, grid_w=grid_w, tile_h=tile_h, tile_w=tile_w)
    rec_t[depth_row, :n_live] = sd
    return rec_t, starts, counts, live_idx[perm]


def kslot_prepare_records_static(tile_key, gid, table, *, n_chan,
                                 num_tiles, chunk, bits_z, depth_mode,
                                 pair_cap, variant=SR.Variant(), grid_w=0,
                                 tile_h=16, tile_w=16):
    """`prepare_records_static` on the K-slot keys, as it was before the
    emission compacted them."""
    depth_row = SR.GEOM_ROWS + n_chan
    n_slots = tile_key.shape[0]
    i64 = torch.int64
    live = tile_key < num_tiles
    pos = torch.cumsum(live, 0, dtype=i64) - 1
    n_live = pos[-1] + 1
    col = torch.where(live, pos, n_live + torch.arange(n_slots, dtype=i64)
                      - pos - 1)
    col = torch.where(col < pair_cap, col, torch.full_like(col, pair_cap))
    src = torch.empty((pair_cap + 1,), dtype=i64)
    src[col] = torch.arange(n_slots, dtype=i64)
    src = src[:pair_cap]
    valid = torch.arange(pair_cap, dtype=i64) < n_live
    lt = tile_key[src]
    lg = gid[src].long()
    ld = torch.where(valid, table[depth_row, lg], torch.zeros(()))
    perm, sd = SR._sort_live(lt, ld, valid, bits_z, depth_mode)
    valid = valid[perm]
    st = lt[perm].contiguous()
    starts, counts = tbin.tile_ranges(st, num_tiles)
    cols = SR._finish_columns(table[:, lg[perm]], st, n_chan=n_chan,
                              bits_z=bits_z, variant=variant, grid_w=grid_w,
                              tile_h=tile_h, tile_w=tile_w)
    cols[depth_row] = sd
    ne_pad = (-(-pair_cap // chunk) + 1) * chunk
    rec_t = torch.zeros((table.shape[0], ne_pad), dtype=torch.float32)
    rec_t[:, :pair_cap] = torch.where(valid[None], cols,
                                      torch.zeros_like(cols))
    stats = torch.stack([n_live, torch.clamp(n_live - pair_cap, min=0)])
    return rec_t, starts, counts, src[perm], stats


def _scene(seed, n=300):
    """(proj, op, table (8 + CV, N), CV) of a drawn table, 4 channels."""
    proj, op, _ = emit_table(seed, n=n, enum_cap=ENUM)
    rng = np.random.RandomState(seed)
    chans = torch.as_tensor(rng.uniform(0, 1, (n, 4)).astype(np.float32))
    return proj, op, SR.record_columns(proj, chans, op).detach(), 4


def _emit(proj, op, pair_cap=None):
    return SR.emit(H, W, proj, op, tile_h=TILE, tile_w=TILE,
                   max_tiles_per_gaussian=K, exact_cull=True, enum_cap=ENUM,
                   use_kernel=False, pair_cap=pair_cap)


def _kw(n_chan, fused, depth_mode, variant=SR.Variant()):
    return dict(n_chan=n_chan, num_tiles=NUM_TILES, chunk=64,
                bits_z=SR.depth_key_bits(NUM_TILES) if fused else 0,
                depth_mode=depth_mode, variant=variant, grid_w=GRID_W,
                tile_h=TILE, tile_w=TILE)


CASES = [(mode, fused, SR.Variant()) for mode in SR.DEPTH_MODES
         for fused in (True, False)] + [
    ("quantized", True, SR.Variant(pack_records=True,
                                   power_impl="mxu_fused"))]


@pytest.mark.parametrize("depth_mode,fused,variant", CASES)
def test_records_from_compacted_pairs_match_kslot(depth_mode, fused,
                                                  variant):
    proj, op, table, n_chan = _scene(3)
    key, gid, _ = tbin.emit_pairs(proj, TILE, TILE, GRID_H, GRID_W, K,
                                  opacity=op, enum_cap=ENUM)
    kw = _kw(n_chan, fused, depth_mode, variant)
    want = kslot_prepare_records(key, gid, table, **kw)
    got = SR.prepare_records(_emit(proj, op), table, **kw)
    n_live = got[3].shape[0]
    assert n_live > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for room in (0, 50):
        cap = n_live + room
        want_s = kslot_prepare_records_static(key, gid, table, pair_cap=cap,
                                              **kw)
        got_s = SR.prepare_records_static(_emit(proj, op, cap), table,
                                          pair_cap=cap, **kw)
        for a, b in zip(got_s[:3], want_s[:3]):
            assert torch.equal(a, b)
        assert torch.equal(got_s[3][:n_live], want_s[3][:n_live])
        assert got_s[4].tolist() == want_s[4].tolist() == [n_live, 0]
        # the unused columns: the sink slot, where the K-slot form took
        # distinct unused slots
        assert bool((got_s[3][n_live:] == K * proj.depth.shape[0]).all())
    # below the live count: the same first pair_cap columns kept
    cap = n_live // 2
    want_s = kslot_prepare_records_static(key, gid, table, pair_cap=cap,
                                          **kw)
    got_s = SR.prepare_records_static(_emit(proj, op, cap), table,
                                      pair_cap=cap, **kw)
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth_mode", SR.DEPTH_MODES)
def test_table_gradient_static_bitwise_eager(depth_mode):
    """`_SortComposite` on the plain kernels: the same forward and the
    same d_table, bitwise, from the eager table and from the static one
    at a capacity above the live count (its unused columns in the sink)."""
    proj, op, table, n_chan = _scene(5)
    spec = (n_chan, NUM_TILES, GRID_W, TILE, TILE, 64,
            SR.depth_key_bits(NUM_TILES), depth_mode, False, SR.Variant())
    eager_pairs = _emit(proj, op)
    n_live = eager_pairs.tile.shape[0]
    outs = []
    for cap in (None, n_live + 77):
        leaf = table.clone().requires_grad_(True)
        if cap is None:
            raw = SR._SortComposite.apply(leaf, eager_pairs, spec)
        else:
            raw, stats = SR._SortComposite.apply(leaf, _emit(proj, op, cap),
                                                 spec, cap, True)
            assert stats.tolist() == [n_live, 0]
        d_raw = torch.as_tensor(np.random.RandomState(1).normal(
            size=raw.shape).astype(np.float32))
        (d_table,) = torch.autograd.grad(raw, leaf, d_raw)
        outs.append((raw.detach(), d_table))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert bool(outs[0][1].abs().sum() > 0)


@pytest.mark.parametrize("k,n", [(8, 1000), (64, 777), (16, 1002)])
def test_sink_column_sums_as_kslot_buffer(k, n):
    """`slot_sum`, the per-slot buffer with the sink column: bitwise the sum
    over K of a (rows, K*N) buffer holding the same columns; what goes to
    the sink is dropped."""
    rng = np.random.RandomState(k)
    rows, n_slots = 12, k * n
    slot = torch.as_tensor(rng.permutation(n_slots)[:n_slots // 3])
    d_pairs = torch.as_tensor(rng.normal(size=(rows, slot.numel()))
                              .astype(np.float32))
    old = torch.zeros((rows, n_slots))
    old[:, slot] = d_pairs
    got = SR.slot_sum(torch.cat([slot, torch.full((5,), n_slots)]),
                      torch.cat([d_pairs, torch.ones((rows, 5))], 1),
                      n_slots, n)
    assert torch.equal(got, old.reshape(rows, -1, n).sum(1))
