"""The pair emission of the kernel E1, on the CPU.

E1 (`csrc/emit.cu`, wrapper `ops/cuda/emit.py::emit_pairs_cuda`) runs only
on the card; `tests/test_torch_gpu.py` holds it against the plain emission
there. Here:

  * `torch_emit_model.e1_model`, E1's per-gaussian loop written in numpy
    (rank by rect order, the sentinel fill, the per-gaussian drop terms),
    in the CPU's arithmetic, against the plain `ops/binning.py::
    emit_pairs`: keys and n_dropped_rect equal, exactly, on drawn tables
    with rects larger than enum_cap, raw count 0 and invalid gaussians,
    dead rows at opacity 0 and bounds on the gate, for K in {8, 16, 64}
    and enum_cap in {16, 32, 128} (both branches: enum_cap <= K takes the
    emission without the cull);
  * the plain emission against the JAX `emit_pairs` at K = 64, enum_cap
    128 on a capacity-padded table whose dead rows project on screen, so
    that the phantom drops (ROADMAP.md §3) are counted identically;
  * `torch_emit_model.e1_compact_model`, E1's three passes (per-gaussian
    pair counts with the dead rows' walks skipped, per-block per-slot
    counts, the scan, the in-block ranks from warp ballots) in numpy,
    against the plain composition `ops/binning.py::emit_live_pairs`
    (`emit_pairs`, then `compact_pairs`): tile keys, slots, the live count
    and its overflow past a capacity, and n_dropped_rect equal, exactly,
    for K in {8, 16, 64} and enum_cap in {16, 32, 128}, with and without
    the cull, with dead rows at opacity 0 and at NaN, gaussians with
    exactly K pairs, capacities below and above the live count and N not
    a multiple of the kernel's block;
  * the early-out as a claim: every row with !(op >= gate) has no passing
    cell in the full walk of the device's arithmetic;
  * the wrapper: on CPU tensors it is the plain version; on another
    device it raises.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic3dgaussians_tpu.ops import binning as jbin
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import projection as jproj
from dynamic3dgaussians_tpu_torch.ops import binning as tbin
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import projection as tproj
from dynamic3dgaussians_tpu_torch.ops.cuda import emit as E1
from tests.scenes import random_scene
from torch_emit_model import (GATE, GRID_H, GRID_W, TILE, device_math,
                              e1_compact_model, e1_model, emit_table,
                              gaussian_walks)

torch.set_num_threads(1)

CPU = device_math("cpu")
K_ENUM = list(itertools.product((8, 16, 64), (16, 32, 128)))


def _emit_both(proj, op, k, enum_cap, near_gate=None):
    model = e1_model(proj, op, TILE, TILE, GRID_H, GRID_W, k, enum_cap, CPU,
                     near_gate=near_gate)
    plain = tbin.emit_pairs(proj, TILE, TILE, GRID_H, GRID_W, k, opacity=op,
                            enum_cap=enum_cap)
    return model, plain


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), k_enum=st.sampled_from(K_ENUM),
       cull=st.booleans())
def test_model_matches_plain_emission(seed, k_enum, cull):
    k, enum_cap = k_enum
    proj, op, _ = emit_table(seed, enum_cap=enum_cap)
    op = op if cull else None
    (mk, md), (pk, pg, pd) = _emit_both(proj, op, k, enum_cap)
    np.testing.assert_array_equal(mk, pk.numpy())
    assert int(md) == int(pd)
    got = E1.emit_pairs_cuda(proj, TILE, TILE, GRID_H, GRID_W, k,
                             opacity=op, enum_cap=enum_cap)
    live = torch.nonzero(pk < GRID_H * GRID_W).squeeze(1)
    assert torch.equal(got.tile, pk[live]) and torch.equal(got.slot.long(),
                                                           live)
    assert got.counts.tolist() == [live.numel(), 0]
    assert int(got.n_dropped_rect) == int(pd) and got.n_slots == pk.numel()


@pytest.mark.parametrize("k,enum_cap", K_ENUM)
def test_model_matches_plain_on_every_feature(k, enum_cap):
    """Fixed seeds whose tables hold every case the emission must get
    right, each counted, keys and drops equal on all. enum_cap <= K is the
    emission without the cull, which has no gate."""
    seen = dict(rect_over_enum=0, raw_zero=0, invalid=0, dead=0,
                on_gate=0, near_gate_cells=0, drops=0, passing_over_k=0)
    if enum_cap <= k:
        del seen["near_gate_cells"]
    for seed in range(5):
        proj, op, on_gate = emit_table(seed, enum_cap=enum_cap)
        near = []
        (mk, md), (pk, pg, pd) = _emit_both(proj, op, k, enum_cap, near)
        np.testing.assert_array_equal(mk, pk.numpy())
        assert int(md) == int(pd)
        raw = tproj.tile_rect(proj, TILE, TILE, GRID_H, GRID_W)[4]
        seen["rect_over_enum"] += int((raw > enum_cap).sum())
        seen["raw_zero"] += int((raw == 0).sum())
        seen["invalid"] += int((~proj.valid).sum())
        seen["dead"] += int((op == 0).sum())
        seen["on_gate"] += on_gate
        if "near_gate_cells" in seen:
            seen["near_gate_cells"] += sum(near)
        seen["drops"] += int(pd)
        live = (pk.reshape(k, -1) < GRID_H * GRID_W).sum(0)
        seen["passing_over_k"] += int((live == k).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_plain_emission_matches_jax_capacity_padded_k64():
    """K = 64, enum_cap 128 on 200 gaussians padded to 800 rows as the
    trainers pad their tables: zero means, zero log-scales (scale 1),
    opacity 0. The dead rows project on screen with rects of the whole
    160-tile grid, past enum_cap, and add phantom drops; both packages
    count the same."""
    n, cap, k, enum_cap = 200, 800, 64, 128
    w, h, f = 256, 160, 200.0
    grid_h, grid_w = h // TILE, w // TILE
    kmat = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    means, _, opac, scales, quats = random_scene(n, seed=31, scale_lo=0.02,
                                                 scale_hi=0.3)
    pad = cap - n
    means = np.concatenate([means, np.zeros((pad, 3), np.float32)])
    scales = np.concatenate([scales, np.ones((pad, 3), np.float32)])
    quats = np.concatenate([quats, np.tile(np.float32([1, 0, 0, 0]),
                                           (pad, 1))])
    opac = np.concatenate([opac, np.zeros((pad,), np.float32)])
    jp = jproj.project(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), jcam.make_camera(w, h, kmat, w2c))
    tp = tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                       torch.as_tensor(quats),
                       tcam.make_camera(w, h, kmat, w2c, device="cpu"))
    jop = jnp.where(jp.valid, jnp.asarray(opac), 0.0)
    top = torch.where(tp.valid, torch.as_tensor(opac), 0.0)
    jk, jg, jd = jbin.emit_pairs(jp, TILE, TILE, grid_h, grid_w, k,
                                 opacity=jop, enum_cap=enum_cap)
    tk, tg, td = tbin.emit_pairs(tp, TILE, TILE, grid_h, grid_w, k,
                                 opacity=top, enum_cap=enum_cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(td) == int(jd)
    raw = tproj.tile_rect(tp, TILE, TILE, grid_h, grid_w)[4]
    assert bool((raw[n:] > enum_cap).all())
    live = tproj.Projected(**{fl.name: getattr(tp, fl.name)[:n]
                              for fl in dataclasses.fields(tp)})
    _, _, td_live = tbin.emit_pairs(live, TILE, TILE, grid_h, grid_w, k,
                                    opacity=top[:n], enum_cap=enum_cap)
    # each dead row adds 1-4 phantom drops (its `passable` square)
    assert pad <= int(td) - int(td_live) <= 4 * pad


def test_wrapper_takes_plain_on_cpu_and_refuses_other_devices():
    proj, op, _ = emit_table(7, enum_cap=32)
    before = E1.emit_pairs_cuda.launches
    for cap in (None, 40):
        got = E1.emit_pairs_cuda(proj, TILE, TILE, GRID_H, GRID_W, 16,
                                 opacity=op, enum_cap=32, pair_cap=cap)
        want = tbin.emit_live_pairs(proj, TILE, TILE, GRID_H, GRID_W, 16,
                                    opacity=op, enum_cap=32, pair_cap=cap)
        assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
        assert got.n_slots == want.n_slots == 16 * 60
    assert E1.emit_pairs_cuda.launches == before
    meta = tproj.Projected(**{fl.name: getattr(proj, fl.name).to("meta")
                              for fl in dataclasses.fields(proj)})
    with pytest.raises(ValueError, match="cuda or cpu"):
        E1.emit_pairs_cuda(meta, TILE, TILE, GRID_H, GRID_W, 16,
                           opacity=op.to("meta"), enum_cap=32)


def test_cull_constants_are_torchs_float32_scalars():
    """The float32 constants E1 takes for the plain emission's Python
    scalars: each as torch rounds it against a float32 tensor."""
    f32 = torch.float32
    gate, inv_gate, eps, floor, cap, inv_w, inv_h = E1.cull_consts(
        16, 8, 23, 40)
    assert gate == torch.tensor(E1.ALPHA_EPS * 0.999, dtype=f32).item()
    assert eps == torch.tensor(E1.ALPHA_EPS, dtype=f32).item()
    assert floor == torch.tensor(1e-12, dtype=f32).item()
    assert inv_gate == np.float32(1.0) / gate
    assert cap == (40 + 1) * 8 + (23 + 1) * 16
    assert (inv_w, inv_h) == (0.125, 0.0625)
    # a float32 tensor compared with the Python scalar, as with `gate`
    v = torch.tensor([gate, np.nextafter(gate, np.float32(0))], dtype=f32)
    assert (v >= E1.ALPHA_EPS * 0.999).tolist() == [True, False]


# ------------------------------------------------- the compacted emission

BLOCK = E1.BLOCK


def _nan_rows(op, seed, share=0.05):
    """op with a drawn share of its rows at NaN (a dead row the cull must
    skip as it skips opacity 0)."""
    rng = np.random.RandomState((seed + 1000) % 2 ** 32)
    op = op.clone()
    op[torch.as_tensor(rng.uniform(size=op.shape[0]) < share)] = float("nan")
    return op


def _compact_both(proj, op, k, enum_cap, pair_cap=None):
    model = e1_compact_model(proj, op, TILE, TILE, GRID_H, GRID_W, k,
                             enum_cap, CPU, pair_cap=pair_cap, block=BLOCK)
    plain = tbin.emit_live_pairs(proj, TILE, TILE, GRID_H, GRID_W, k,
                                 opacity=op, enum_cap=enum_cap,
                                 pair_cap=pair_cap)
    mt, ms, mc, md = model
    assert plain.tile.dtype == plain.slot.dtype == torch.int32
    np.testing.assert_array_equal(mt, plain.tile.numpy())
    np.testing.assert_array_equal(ms, plain.slot.numpy())
    assert mc.tolist() == plain.counts.tolist()
    assert int(md) == int(plain.n_dropped_rect)
    return plain


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), k_enum=st.sampled_from(K_ENUM),
       cull=st.booleans(), n=st.sampled_from([60, 300]),
       cap=st.sampled_from([None, 0.5, 1.0, 1.3]))
def test_compact_model_matches_plain(seed, k_enum, cull, n, cap):
    """E1's passes in numpy against `emit_pairs` + `compact_pairs` on
    drawn tables, eager and at capacities below, at and above the live
    count."""
    k, enum_cap = k_enum
    proj, op, _ = emit_table(seed, n=n, enum_cap=enum_cap)
    op = _nan_rows(op, seed) if cull else None
    eager = _compact_both(proj, op, k, enum_cap)
    if cap is not None:
        pair_cap = int(eager.tile.shape[0] * cap)
        got = _compact_both(proj, op, k, enum_cap, pair_cap)
        keep = min(pair_cap, eager.tile.shape[0])
        assert torch.equal(got.tile[:keep], eager.tile[:keep])
        assert torch.equal(got.slot[:keep], eager.slot[:keep])


@pytest.mark.parametrize("k,enum_cap", K_ENUM)
def test_compact_model_on_every_feature(k, enum_cap):
    """Fixed seeds whose tables hold every case the compaction must get
    right, each counted: dead rows at opacity 0 and NaN, gaussians with
    exactly K pairs, a capacity below the live count (overflow reported,
    the first pair_cap pairs those of the eager form) and above it (the
    sentinel and the sink past the live count), N not a multiple of the
    kernel's block; with and without the cull."""
    seen = dict(dead=0, nan=0, k_pairs=0, overflow=0, filled=0,
                ragged_blocks=0)
    num_tiles = GRID_H * GRID_W
    for seed in range(3):
        proj, op, _ = emit_table(seed, n=300, enum_cap=enum_cap)
        op = _nan_rows(op, seed)
        seen["dead"] += int((op == 0).sum())
        seen["nan"] += int(torch.isnan(op).sum())
        seen["ragged_blocks"] += int(300 % BLOCK != 0 and 300 > BLOCK)
        for cull in (op, None):
            eager = _compact_both(proj, cull, k, enum_cap)
            n_live = eager.tile.shape[0]
            per_g = torch.bincount(eager.slot.long() % 300, minlength=300)
            seen["k_pairs"] += int((per_g == k).sum())
            below = _compact_both(proj, cull, k, enum_cap, n_live // 2)
            assert below.counts.tolist() == [n_live, n_live - n_live // 2]
            assert torch.equal(below.tile, eager.tile[:n_live // 2])
            assert torch.equal(below.slot, eager.slot[:n_live // 2])
            seen["overflow"] += int(below.counts[1])
            above = _compact_both(proj, cull, k, enum_cap, n_live + 37)
            assert torch.equal(above.tile[:n_live], eager.tile)
            assert bool((above.tile[n_live:] == num_tiles).all())
            assert bool((above.slot[n_live:] == above.n_slots).all())
            seen["filled"] += int(above.tile.shape[0] - n_live)
    assert all(v > 0 for v in seen.values()), seen


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       enum_cap=st.sampled_from([16, 32, 128]))
def test_dead_rows_have_no_passing_cell(seed, enum_cap):
    """E1 skips the walk of a row with !(op >= gate): every such row of a
    drawn table (opacity 0, below the gate, NaN) has no passing cell in
    the full walk of the device's arithmetic, while it has rect cells to
    walk."""
    proj, op, _ = emit_table(seed, n=200, enum_cap=enum_cap)
    rng = np.random.RandomState(seed % 2 ** 31)
    below = torch.as_tensor(rng.uniform(size=200) < 0.1)
    op = torch.where(below, torch.as_tensor(
        rng.uniform(0, float(GATE), 200).astype(np.float32)), op)
    op = _nan_rows(op, seed, share=0.1)
    keys, _ = gaussian_walks(proj, op, TILE, TILE, GRID_H, GRID_W, 8,
                             enum_cap, CPU)
    raw = tproj.tile_rect(proj, TILE, TILE, GRID_H, GRID_W)[4]
    dead = ~(op >= float(GATE))
    assert all(keys[g].shape[0] == 0 for g in np.flatnonzero(dead.numpy()))
    assert int((dead & (raw > 0)).sum()) > 0


def test_compact_pairs_forms_agree():
    """`compact_pairs` eager (`nonzero`) and at a capacity (cumulative sum
    and scatter): the same live pairs in slot order, the overflow past a
    small capacity counted, the sentinel and the sink past the live
    count."""
    proj, op, _ = emit_table(11, n=300, enum_cap=128)
    key, _, _ = tbin.emit_pairs(proj, TILE, TILE, GRID_H, GRID_W, 64,
                                opacity=op, enum_cap=128)
    num_tiles = GRID_H * GRID_W
    tile, slot, counts = tbin.compact_pairs(key, num_tiles)
    live = torch.nonzero(key < num_tiles).squeeze(1)
    assert torch.equal(slot.long(), live) and torch.equal(tile, key[live])
    assert counts.tolist() == [live.numel(), 0]
    for cap in (1, live.numel() - 1, live.numel(), live.numel() + 5):
        t, sl, c = tbin.compact_pairs(key, num_tiles, cap)
        keep = min(cap, live.numel())
        assert torch.equal(t[:keep], tile[:keep])
        assert torch.equal(sl[:keep], slot[:keep])
        assert bool((t[keep:] == num_tiles).all())
        assert bool((sl[keep:] == key.numel()).all())
        assert c.tolist() == [live.numel(), max(live.numel() - cap, 0)]
