"""The render backward's pair-to-gaussian sum (`ops/cuda/unsort.py`) on
the CPU.

`unsort_sum_plain` (the plain version of the kernel U1, which on the card
takes its place) is held to `sorted_raster.slot_sum`, the zeroed per-slot
buffer summed over K: bitwise on dyadic values (small integers times
powers of two, which any order sums exactly), and within 2 (K - 1) 2^-24
sum |terms| per entry on normal draws (the buffer's sum over K may take
another order). The slots are drawn as the paths hand them over, in a
shuffled column order (the sort by tile and depth): each gaussian's prefix
k = 0..c-1 (E1's eager form), the same with sink columns (the static
form), the first half of the slot order (a capacity cut below the live
count), a random subset of each gaussian's slots (a tile stripe's); and
the plain emission's own pairs through `prepare_records`, eager, static
and cut to half the tiles. Also: the plain emission hands over prefix
slots, the rows past n_rows are zero, and `_SortComposite`'s backward
calls no `slot_sum`.
"""

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
from dynamic3dgaussians_tpu_torch.ops.cuda import unsort as U
from torch_emit_model import GRID_H, GRID_W, H, TILE, W, emit_table

torch.set_num_threads(1)

N = 300
ROWS = 16
NUM_TILES = GRID_H * GRID_W
ENUM = 128
DRAWN = ("prefix", "static", "cap", "subset")
EMITTED = ("emitted", "emitted_static", "stripe")


def drawn_slots(form, k, seed, n=N):
    """(slot (M,) int64, columns shuffled) of `form` over n gaussians."""
    rng = np.random.RandomState(seed)
    count = rng.randint(0, k + 1, n)
    count[rng.rand(n) < 0.3] = 0                      # dead rows
    ks = [rng.choice(k, c, replace=False) if form == "subset"
          else np.arange(c) for c in count]
    slots = np.sort(np.concatenate(
        [kk * n + g for g, kk in enumerate(ks)]).astype(np.int64))
    if form == "cap":
        slots = slots[:slots.size // 2]               # k-major prefix
    if form == "static":
        slots = np.concatenate([slots, np.full(37, k * n, np.int64)])
    return torch.as_tensor(rng.permutation(slots))


def _scene(seed, k, n=N):
    proj, op, _ = emit_table(seed, n=n, enum_cap=ENUM)
    chans = torch.as_tensor(np.random.RandomState(seed).uniform(
        0, 1, (n, 4)).astype(np.float32))
    return proj, op, SR.record_columns(proj, chans, op).detach()


def _emit(proj, op, k, pair_cap=None):
    return SR.emit(H, W, proj, op, tile_h=TILE, tile_w=TILE,
                   max_tiles_per_gaussian=k, exact_cull=True, enum_cap=ENUM,
                   use_kernel=False, pair_cap=pair_cap)


def emitted_slots(form, k, seed):
    """The sorted pairs' slots of the plain emission through
    `prepare_records` (the static form at a capacity past the live
    count; `stripe` keeps the pairs of the bottom half of the tile rows,
    as `tile_shard.stripe_table` keeps a stripe's: a gaussian that also
    meets the top half loses its first slots there)."""
    proj, op, table = _scene(seed, k)
    kw = dict(n_chan=4, num_tiles=NUM_TILES, chunk=64,
              bits_z=SR.depth_key_bits(NUM_TILES), depth_mode="quantized")
    pairs = _emit(proj, op, k)
    if form == "emitted_static":
        cap = pairs.tile.shape[0] + 50
        return SR.prepare_records_static(_emit(proj, op, k, cap), table,
                                         pair_cap=cap, **kw)[3]
    if form == "stripe":
        keep = pairs.tile >= (GRID_H // 2) * GRID_W
        pairs = pairs._replace(tile=pairs.tile[keep], slot=pairs.slot[keep])
    return SR.prepare_records(pairs, table, **kw)[3]


def values(kind, shape, seed):
    rng = np.random.RandomState(seed + 1)
    if kind == "dyadic":
        v = rng.randint(-8, 9, shape) * 2.0 ** rng.randint(-4, 5, shape)
    else:
        v = rng.normal(size=shape)
    return torch.as_tensor(v.astype(np.float32))


@pytest.mark.parametrize("kind", ("dyadic", "normal"))
@pytest.mark.parametrize("k", (8, 64))
@pytest.mark.parametrize("form", DRAWN + EMITTED)
def test_plain_sum_is_the_per_slot_buffers(form, k, kind):
    slot = (drawn_slots(form, k, seed=k) if form in DRAWN
            else emitted_slots(form, k, seed=k))
    n_slots = k * N
    live = slot < n_slots
    assert int(live.sum()) > 0
    assert bool((~live).any()) == form.endswith("static")
    d = values(kind, (ROWS, slot.numel()), seed=k)
    want = SR.slot_sum(slot, d, n_slots, N)
    got = U.unsort_sum_plain(slot, d, n_slots, N, ROWS)
    assert got.shape == want.shape == (ROWS, N)
    if kind == "dyadic":
        assert torch.equal(got, want)
    else:
        terms = SR.slot_sum(slot, d.abs(), n_slots, N)
        assert bool(((got - want).abs()
                     <= 2 * (k - 1) * 2.0 ** -24 * terms).all())
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch
    before = U.unsort_sum_cuda.launches
    assert torch.equal(U.unsort_sum_cuda(slot, d, n_slots, N, ROWS), got)
    assert U.unsort_sum_cuda.launches == before


@pytest.mark.parametrize("form", ("subset", "stripe"))
def test_subset_forms_are_not_prefixes(form):
    """The subset cases hold gaussians whose live slots skip a k: a walk
    that stopped at the first missing slot would drop their terms."""
    k = 64
    slot = (drawn_slots(form, k, seed=k) if form in DRAWN
            else emitted_slots(form, k, seed=k))
    slot = slot[slot < k * N]
    gauss, kk = slot % N, slot // N
    count = torch.bincount(gauss, minlength=N)
    last = torch.zeros(N, dtype=torch.int64).scatter_reduce(
        0, gauss, kk + 1, "amax")
    assert bool((last > count).any())


@pytest.mark.parametrize("k", (8, 64))
def test_emission_hands_over_prefix_slots(k):
    """The plain emission's live slots of each gaussian are k = 0..c-1:
    eagerly, at a capacity past the live count, and cut at half of it
    (the cut keeps the first pairs in k-major slot order)."""
    for seed in range(3):
        proj, op, _ = _scene(seed, k)
        n_live = _emit(proj, op, k).tile.shape[0]
        for cap in (None, n_live + 9, n_live // 2):
            pairs = _emit(proj, op, k, cap)
            slot = pairs.slot.long()
            slot = slot[slot < k * N]
            gauss, kk = slot % N, slot // N
            count = torch.bincount(gauss, minlength=N)
            seen = torch.zeros((k, N), dtype=torch.bool)
            seen[kk, gauss] = True
            want = torch.arange(k)[:, None] < count[None, :]
            assert torch.equal(seen, want), (seed, cap)


def test_rows_past_n_rows_are_zero():
    slot = drawn_slots("static", 8, seed=3)
    d = values("normal", (ROWS, slot.numel()), seed=3)
    full = U.unsort_sum_plain(slot, d, 8 * N, N, ROWS)
    got = U.unsort_sum_plain(slot, d, 8 * N, N, n_rows=11)
    assert torch.equal(got[:11], full[:11])
    assert not bool(got[11:].any())


def test_bad_arguments_raise():
    slot = drawn_slots("prefix", 8, seed=1)
    d = values("normal", (ROWS, slot.numel()), seed=1)
    with pytest.raises(ValueError, match="one slot per"):
        U.unsort_sum_plain(slot[1:], d, 8 * N, N, ROWS)
    with pytest.raises(ValueError, match="K x n_gauss"):
        U.unsort_sum_plain(slot, d, 8 * N + 1, N, ROWS)
    with pytest.raises(ValueError, match="n_rows"):
        U.unsort_sum_plain(slot, d, 8 * N, N, n_rows=ROWS + 1)


def test_backward_builds_no_per_slot_buffer(monkeypatch):
    """`_SortComposite`'s backward, eager and static, sums through the
    plain version and never calls `slot_sum`."""
    def refused(*a, **kw):
        raise AssertionError("slot_sum on the render path")
    monkeypatch.setattr(SR, "slot_sum", refused)
    proj, op, table = _scene(5, 64)
    spec = (4, NUM_TILES, GRID_W, TILE, TILE, 64,
            SR.depth_key_bits(NUM_TILES), "quantized", False, SR.Variant())
    n_live = _emit(proj, op, 64).tile.shape[0]
    for cap in (None, n_live + 77):
        leaf = table.clone().requires_grad_(True)
        if cap is None:
            raw = SR._SortComposite.apply(leaf, _emit(proj, op, 64), spec)
        else:
            raw, _ = SR._SortComposite.apply(leaf, _emit(proj, op, 64, cap),
                                             spec, cap, True)
        (d_table,) = torch.autograd.grad(raw, leaf, torch.ones_like(raw))
        assert bool(d_table.abs().sum() > 0)
        assert not bool(d_table[SR.GEOM_ROWS + 4 + 1:].any())
