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
from torch_emit_model import (GRID_H, GRID_W, TILE, device_math, e1_model,
                              emit_table)

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
    wk, wg, wd = E1.emit_pairs_cuda(proj, TILE, TILE, GRID_H, GRID_W, k,
                                    opacity=op, enum_cap=enum_cap)
    assert torch.equal(wk, pk) and torch.equal(wg, pg)
    assert int(wd) == int(pd)


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
    got = E1.emit_pairs_cuda(proj, TILE, TILE, GRID_H, GRID_W, 16,
                             opacity=op, enum_cap=32)
    want = tbin.emit_pairs(proj, TILE, TILE, GRID_H, GRID_W, 16, opacity=op,
                           enum_cap=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
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
