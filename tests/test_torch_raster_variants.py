"""Port parity: the reference's raster settings that change what the
sorted-pair path computes -- `pack_records`, `power_impl="mxu_fused"` and
`kernel_precision="default"` -- against the JAX package (its Pallas
kernels in interpret mode), at the size of tests/test_pallas.py.

* `round_f16` / `round_bf16` bitwise against the reference's
  `unpack2_f16(pack2_f16(.))` / `unpack2_bf16(pack2_bf16(.))`, the
  non-finite values, the f16 overflow past 65504 and subnormals included.
* pack_records: the render and its gradients against the reference's,
  with its gradient rows unsorted by a payload sort and by a gather; the
  packed static table (`prepare_records_static`) bitwise the eager one.
* mxu_fused: the render and its gradients (through the unfused backward,
  as in the reference); the table's rows 6 and 7; K1's FUSED variant
  against the reference's fused kernel on the same table, and on a table
  whose rows 6-7 disagree with its opacity row, where both read the rows
  and the default variant does not; the footprint cull of the fused gate.
* kernel_precision="default" (the reference's CPU run computes this in
  float32: XLA ignores the precision there), K1 and K2: each product's
  operands are the float32 ones rounded to bf16 (nearest even, a numpy
  rounding), the outputs their float32 products and sums; and the
  outputs against the reference's within the bf16 bound.
* train_ship (the reference's shipped trainer settings: pack_records,
  unsort_impl "gather", power_impl "mxu"): one train step; a reference
  `cfg_args.json` with the pack, mxu_fused and the gather unsort trains
  under `cli train --config_json`.
* The reference's playback leaves rows 6-7 at zero under mxu_fused, so
  its cached frame is far from its exact render; the port's is not.

Each variant is also shown to move its output by more than the tolerance
it is held to, so that none can be the default path in disguise.
Tolerances, with their reasons, are in
tests/fixtures/TORCH_TOLERANCES.md.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic3dgaussians_tpu.data import synthetic as jsyn
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import playback as jpb
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.ops import sorted_raster as jsr
from dynamic3dgaussians_tpu.ops.pallas.raster_bwd import \
    pallas_composite_tiles_bwd
from dynamic3dgaussians_tpu.ops.pallas.raster_fwd import \
    pallas_composite_tiles
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import optim as jopt
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch import cli, convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.models import gaussians as TG
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import playback as tpb
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops import sorted_raster as tsr
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd as tbwd
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as tfwd
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from tests.scenes import random_scene

torch.set_num_threads(1)

ATOL_RGB, ATOL_DEPTH = 3e-5, 3e-4     # the CPU rows of TOLERANCES.md
ATOL_LOGT = 1e-3                      # K1's log2 T (chip_smoke.py)
BF16_STEP = 2.0 ** -8                 # one bf16 rounding step, relative
REL_FUSED_GRAD = 1e-3
F32_SUM = 2.0 ** -20                  # float32 sums of up to ~10^2 terms
QUANTUM = 3.9e-3
BG = np.array([0.2, 0.1, 0.4], np.float32)
NAMES = ("means", "colors", "opacity", "scales", "quats", "extra")


def _scene(n=150, seed=0, w=64, h=48, f=50.0):
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    arrays = list(random_scene(n, seed=seed))
    rng = np.random.RandomState(seed + 100)
    arrays.append(rng.rand(n, 3).astype(np.float32))          # extra
    cot = dict(rgb=rng.normal(size=(h, w, 3)).astype(np.float32),
               depth=rng.normal(size=(h, w)).astype(np.float32),
               extra=rng.normal(size=(h, w, 3)).astype(np.float32))
    return (jcam.make_camera(w, h, k, w2c),
            tcam.make_camera(w, h, k, w2c, device="cpu"), arrays, cot)


def _port(cam, arrays, cot, **over):
    """The port's render (plain kernels) and its gradients."""
    cfg = trast.RasterConfig(depth_mode="total", max_tiles_per_gaussian=64,
                             **over)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    m, c, o, s, q, e = ts
    out = trast.render(cam, m, c, o, s, q, extra_channels=e,
                       bg=torch.as_tensor(BG), method="torch", config=cfg,
                       device="cpu")
    assert int(out.n_dropped_rect) == 0
    loss = (torch.sum(out.rgb * torch.as_tensor(cot["rgb"]))
            + torch.sum(out.depth * torch.as_tensor(cot["depth"]))
            + torch.sum(out.extra * torch.as_tensor(cot["extra"]))
            + 0.3 * torch.sum(out.alpha))
    grads = [g.numpy() for g in torch.autograd.grad(loss, ts)]
    return {k: getattr(out, k).detach().numpy()
            for k in ("rgb", "alpha", "depth", "extra")}, grads


def _jax(cam, arrays, cot, **over):
    """The reference's render (Pallas, interpret mode) and its gradients;
    depth_mode "total", so that its unstable sorts order no equal keys."""
    cfg = jrast.RasterConfig(depth_mode="total", max_tiles_per_gaussian=64,
                             **over)

    def loss(m, c, o, s, q, e):
        out = jrast.render(cam, m, c, o, s, q, extra_channels=e,
                           bg=jnp.asarray(BG), method="pallas", config=cfg)
        return (jnp.sum(out.rgb * cot["rgb"])
                + jnp.sum(out.depth * cot["depth"])
                + jnp.sum(out.extra * cot["extra"])
                + 0.3 * jnp.sum(out.alpha)), out

    grads, out = jax.jit(jax.grad(loss, argnums=tuple(range(6)),
                                  has_aux=True))(*map(jnp.asarray, arrays))
    assert int(out.n_dropped_rect) == 0
    return ({k: np.asarray(getattr(out, k))
             for k in ("rgb", "alpha", "depth", "extra")},
            [np.asarray(g) for g in grads])


def _assert_images(t, j, depth_atol=ATOL_DEPTH, atol=ATOL_RGB):
    for key in ("rgb", "alpha", "extra"):
        np.testing.assert_allclose(t[key], j[key], atol=atol, err_msg=key)
    np.testing.assert_allclose(t["depth"], j["depth"], atol=depth_atol,
                               err_msg="depth")


def _max_diff(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _rel(a, b):
    """Largest |a - b| / max(|b|, 1) over the gradient groups."""
    return max(float((np.abs(x - y) / np.maximum(np.abs(y), 1.0)).max())
               for x, y in zip(a, b))


# ---------------------------------------------------------- transports

def _special_values():
    f32 = np.float32
    vals = [0.0, -0.0, 1.0, -1.0, 0.1, 1.5, 2.0 ** -14, 2.0 ** -24,
            6e-8, 3e-8, 1e-40, -1e-45, 65504.0, 65519.0, 65520.0, -65520.0,
            1e5, -3.0e38, 3.4e38, float(np.finfo(f32).max), np.inf, -np.inf,
            np.nan, -np.nan]
    rng = np.random.RandomState(0)
    rand = rng.normal(size=200) * 10.0 ** rng.uniform(-9, 9, 200)
    a = np.concatenate([np.asarray(vals, f32), rand.astype(f32)])
    # NaNs with payloads only in the low half, which bf16 truncation drops
    bits = np.array([0x7F800001, 0xFF800001, 0x7FC00000, 0x7F808000],
                    np.uint32).view(f32)
    return np.concatenate([a, bits])


def test_round_f16_and_round_bf16_are_the_reference_packs():
    a = _special_values()
    b = a[::-1].copy()
    got_a, got_b = (tsr.round_f16(torch.as_tensor(x)).numpy() for x in (a, b))
    lo, hi = (np.asarray(x) for x in jsr.unpack2_f16(
        jsr.pack2_f16(jnp.asarray(a), jnp.asarray(b))))
    for got, want in ((got_a, lo), (got_b, hi)):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                      want[~nan].view(np.uint32))
    got_a, got_b = (tsr.round_bf16(torch.as_tensor(x)).numpy()
                    for x in (a, b))
    lo, hi = (np.asarray(x) for x in jsr.unpack2_bf16(
        jsr.pack2_bf16(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got_a.view(np.uint32), lo.view(np.uint32))
    np.testing.assert_array_equal(got_b.view(np.uint32), hi.view(np.uint32))
    # the cases the rounding is about: inf stays inf, NaN non-finite, the
    # largest float32 carries into inf, a tie rounds away from zero
    r = tsr.round_bf16(torch.tensor([np.inf, np.nan, 3.4028235e38,
                                     1.0 + 2.0 ** -8])).numpy()
    assert r[0] == np.inf and np.isnan(r[1]) and r[2] == np.inf
    assert r[3] == np.float32(1.0 + 2.0 ** -7)


# ------------------------------------------------------------- the pack

@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def port_default(scene):
    _, tc, arrays, cot = scene
    return _port(tc, arrays, cot)


@pytest.mark.parametrize("unsort_impl", ["sort", "gather"])
def test_pack_records_matches_jax(scene, port_default, unsort_impl):
    jc, tc, arrays, cot = scene
    t_img, t_g = _port(tc, arrays, cot, pack_records=True,
                       unsort_impl=unsort_impl)
    j_img, j_g = _jax(jc, arrays, cot, pack_records=True,
                      unsort_impl=unsort_impl)
    _assert_images(t_img, j_img)
    for name, a, b in zip(NAMES, t_g, j_g):
        err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        assert err.max() <= BF16_STEP, (name, float(err.max()))
    # the pack moves the image and the gradients past those bounds
    assert _max_diff(t_img, port_default[0]) > 10 * ATOL_RGB
    assert _rel(t_g, port_default[1]) > 10 * BF16_STEP


def test_pack_records_static_table_matches_eager(scene):
    """The packed table at a fixed pair capacity (a captured step's) is
    bitwise the eager packed table, and differs from the unpacked one."""
    _, tc, arrays, _ = scene
    m, c, o, s, q, e = (torch.as_tensor(a) for a in arrays)
    proj = project(m, s, q, tc)
    op = torch.where(proj.valid, o, torch.zeros_like(o))
    chans = torch.cat([c, e], -1)
    def emit(pair_cap=None):
        return tsr.emit(48, 64, proj, op, tile_h=16, tile_w=16,
                        max_tiles_per_gaussian=16, exact_cull=True,
                        enum_cap=0, use_kernel=False, pair_cap=pair_cap)
    pairs = emit()
    table = tsr.record_columns(proj, chans, op)
    kw = dict(n_chan=6, num_tiles=12, chunk=64, bits_z=tsr.depth_key_bits(12),
              depth_mode="quantized", grid_w=4, tile_h=16, tile_w=16)
    pack = tsr.Variant(pack_records=True, power_impl="mxu_fused")
    rec_e, st_e, cn_e, slot_e = tsr.prepare_records(
        pairs, table, variant=pack, **kw)
    n = slot_e.shape[0]
    rec_s, st_s, cn_s, slot_s, stats = tsr.prepare_records_static(
        emit(n + 100), table, variant=pack, pair_cap=n + 100, **kw)
    assert stats.tolist() == [n, 0]
    assert torch.equal(rec_s[:, :n], rec_e[:, :n])
    assert not bool(rec_s[:, n:].any())
    assert torch.equal(st_s, st_e) and torch.equal(cn_s, cn_e)
    assert torch.equal(slot_s[:n], slot_e)
    rec_0 = tsr.prepare_records(pairs, table, **kw)[0]
    assert float((rec_e[:6] - rec_0[:6]).abs().max()) > 1e-4
    # x and y rounded relative to the origin of each pair's own tile
    tile = torch.repeat_interleave(torch.arange(12), cn_e.long())
    g = slot_e % proj.depth.shape[0]
    for row, src, origin in ((0, proj.x2d, (tile % 4) * 16),
                             (1, proj.y2d, (tile // 4) * 16)):
        o = origin.float()
        assert torch.equal(rec_e[row, :n], tsr.round_f16(src[g] - o) + o)


# ------------------------------------------------------------ mxu_fused

def test_mxu_fused_matches_jax(scene, port_default):
    """The render within the CPU rows; the gradients, which run the
    unfused backward on the fused forward's log T in both packages, per
    group within 1e-3 in norm (the reference's own bound for its fused
    path, whose backward evaluates the power on the MXU)."""
    jc, tc, arrays, cot = scene
    t_img, t_g = _port(tc, arrays, cot, power_impl="mxu_fused")
    j_img, j_g = _jax(jc, arrays, cot, power_impl="mxu_fused")
    _assert_images(t_img, j_img)
    for name, a, b in zip(NAMES, t_g, j_g):
        nb = float(np.linalg.norm(b))
        assert float(np.linalg.norm(a - b)) <= REL_FUSED_GRAD * nb, name
    # the same function as the default up to one rounding of log2 opacity
    _assert_images(t_img, port_default[0])


def _table(variant, chunk=64, k=16):
    jc, tc, arrays, _ = _scene(n=150, seed=3)
    m, c, o, s, q, e = (torch.as_tensor(a) for a in arrays)
    proj = project(m, s, q, tc)
    op = torch.where(proj.valid, o, torch.zeros_like(o))
    rec_t, starts, counts, drops = tsr.sorted_records(
        48, 64, proj, torch.cat([c, e], -1), op, chunk=chunk,
        max_tiles_per_gaussian=k, variant=variant)
    assert int(drops) == 0
    kw = dict(num_tiles=12, grid_w=4, tile_h=16, tile_w=16, chunk=chunk)
    return rec_t, starts, counts, kw


def _jax_fwd(rec_t, starts, counts, kw, **over):
    out = pallas_composite_tiles(jnp.asarray(rec_t.numpy()),
                                 jnp.asarray(starts.numpy()),
                                 jnp.asarray(counts.numpy()), **kw, **over)
    return [np.asarray(x) for x in out]


def _raw_close(t, j, n_chan=6):
    np.testing.assert_allclose(np.delete(t, n_chan, -1),
                               np.delete(j, n_chan, -1), atol=ATOL_RGB)
    np.testing.assert_allclose(t[..., n_chan], j[..., n_chan],
                               atol=ATOL_DEPTH)


def test_fused_kernel_reads_its_rows():
    """K1's FUSED variant (its plain version) against the reference's
    fused kernel on the same tables: the port's fused table (rows 6-7 the
    reference's formula of its opacity row), and that table with rows 6-7
    taken from half the opacity, which both fused kernels read and the
    default variant does not."""
    rec_t, starts, counts, kw = _table(tsr.Variant(power_impl="mxu_fused"))
    op = rec_t[5]
    n = int(counts.sum())
    r6 = np.asarray(jnp.log2(jnp.maximum(jnp.asarray(op[:n].numpy()),
                                         jnp.float32(2.0 ** -100))))
    np.testing.assert_allclose(rec_t[6, :n].numpy(), r6, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        rec_t[7, :n].numpy(), np.minimum(rec_t[6, :n].numpy(),
                                         np.float32(np.log2(0.99))))
    assert not bool(rec_t[6:8, n:].any())
    fused = dict(power_impl="mxu_fused")
    default = tfwd.composite_tiles_torch(rec_t, starts, counts, **kw)[0]
    for table in (rec_t, rec_t.clone()):
        if table is not rec_t:
            table[6], table[7] = tsr.fused_opacity_rows(0.5 * op)
        raw_t, logt_t, nact_t = tfwd.composite_tiles_torch(
            table, starts, counts, **kw, **fused)
        raw_j, logt_j, nact_j = _jax_fwd(table, starts, counts, kw, **fused)
        _raw_close(raw_t.numpy(), raw_j)
        np.testing.assert_allclose(logt_t.numpy(), logt_j, atol=ATOL_LOGT)
        np.testing.assert_array_equal(nact_t.numpy(), nact_j)
    # half the opacity in rows 6-7 moves the fused image far; the default
    # variant reads row 5 and cannot see it
    assert float((raw_t - default).abs().max()) > 0.05
    assert torch.equal(tfwd.composite_tiles_torch(
        table, starts, counts, **kw)[0], default)


EPS32 = float(np.float32(1.0 / 255.0))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(la=st.floats(-3.0, 1.0), lc=st.floats(-3.0, 1.0),
       r=st.floats(-0.999, 0.999),
       op=st.one_of(st.floats(EPS32 * 0.999, 1.0),
                    st.integers(-64, 64).map(
                        lambda k: float(np.float32(EPS32)
                                        * np.float32(1 + k * 2.0 ** -23)))),
       fx=st.floats(0.0, 1.0, exclude_max=True),
       fy=st.floats(0.0, 1.0, exclude_max=True))
def test_fused_footprint_holds_every_live_cell(la, lc, r, op, fx, fy):
    """The footprint box of the fused gate (`footprint_boxes(fused=True)`,
    the kernels' `record_box_fused`) holds every pixel at which the fused
    cell of `composite_tiles_torch` is live, opacities at the gate
    included."""
    a, c = 10.0 ** la, 10.0 ** lc
    rec = torch.zeros((8, 1), dtype=torch.float32)
    rec[:6, 0] = torch.tensor([100.0 + fx, 80.0 + fy, a,
                               r * np.sqrt(a * c), c, op])
    rec[6], rec[7] = tsr.fused_opacity_rows(rec[5])
    box = tfwd.footprint_boxes(rec, fused=True)[:, 0]
    half = 64
    px = torch.arange(100 - half, 100 + half + 1, dtype=torch.float32)
    py = torch.arange(80 - half, 80 + half + 1, dtype=torch.float32)
    py, px = torch.meshgrid(py, px, indexing="ij")
    dx, dy = rec[0, 0] - px, rec[1, 0] - py
    p0 = -0.5 * (rec[2, 0] * dx * dx + rec[4, 0] * dy * dy) \
        - rec[3, 0] * dx * dy
    m = torch.minimum(p0 + rec[6, 0], rec[7, 0])
    live = m >= tfwd.LOG2_ALPHA_EPS
    inside = (px >= box[0]) & (px <= box[1]) & (py >= box[2]) \
        & (py <= box[3])
    assert not bool((live & ~inside).any()), (rec[:, 0].tolist(),
                                              box.tolist())


# --------------------------------------------- kernel_precision="default"

def _bf16_np(x):
    """Round float32 to bf16, nearest even, in numpy (finite values)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def _bmm_operands(monkeypatch, fn):
    """fn() with every torch.bmm's operands recorded (as numpy)."""
    seen = []
    bmm = torch.bmm

    def rec(a, b):
        seen.append((a.numpy().copy(), b.numpy().copy()))
        return bmm(a, b)
    monkeypatch.setattr(torch, "bmm", rec)
    out = fn()
    monkeypatch.setattr(torch, "bmm", bmm)
    return out, seen


def test_kernel_precision_default_k1(monkeypatch):
    """K1's BF16 variant: its product operands are the default variant's
    rounded to bf16, its accumulators their float32 products and sums
    (within float32 rounding of sum |w| |v|), its transmittance and stop
    points the default's bitwise; against the reference's CPU run (float32)
    within 2 2^-8 sum |w| |v| per output plus the CPU rows."""
    rec_t, starts, counts, kw = _table(tsr.Variant())
    (raw_d, logt_d, nact_d), ops_d = _bmm_operands(
        monkeypatch, lambda: tfwd.composite_tiles_torch(
            rec_t, starts, counts, **kw))
    (raw_b, logt_b, nact_b), ops_b = _bmm_operands(
        monkeypatch, lambda: tfwd.composite_tiles_torch(
            rec_t, starts, counts, precision="default", **kw))
    assert torch.equal(logt_b, logt_d) and torch.equal(nact_b, nact_d)
    assert len(ops_b) == len(ops_d) > 1
    emul = np.zeros_like(raw_b.numpy())
    size = np.zeros_like(emul)
    for (w, v), (wb, vb) in zip(ops_d, ops_b):
        np.testing.assert_array_equal(wb.view(np.uint32),
                                      _bf16_np(w).view(np.uint32))
        np.testing.assert_array_equal(vb.view(np.uint32),
                                      _bf16_np(v).view(np.uint32))
        emul += np.matmul(_bf16_np(w), _bf16_np(v))
        size += np.matmul(np.abs(w), np.abs(v))
    assert np.all(np.abs(raw_b.numpy() - emul) <= F32_SUM * size + 1e-30)
    raw_j = _jax_fwd(rec_t, starts, counts, kw, precision="default")[0]
    _raw_close(raw_d.numpy(), raw_j)
    atol = np.full(emul.shape[-1], ATOL_RGB, np.float32)
    atol[6] = ATOL_DEPTH
    assert np.all(np.abs(raw_b.numpy() - raw_j)
                  <= 2 * BF16_STEP * size + atol)
    assert float((raw_b - raw_d).abs().max()) > 10 * ATOL_RGB


def test_kernel_precision_default_k2(monkeypatch):
    """K2's BF16 variant: the operands of both value products are the
    default variant's rounded to bf16; its geometry rows bitwise the
    default variant's on d_raw and the value rows rounded to bf16 first
    (the rounding is all that changes in them); its value rows against the
    reference's CPU run within 2 2^-8 sum_p |d_acc| |w| plus the CPU
    rows, and away from the default's by more than that."""
    rec_t, starts, counts, kw = _table(tsr.Variant())
    raw, log_t, nact = tfwd.composite_tiles_torch(rec_t, starts, counts,
                                                  **kw)
    d_raw = torch.as_tensor(np.random.RandomState(7).normal(
        size=tuple(raw.shape)).astype(np.float32))
    args = (rec_t, starts, counts, nact.reshape(-1), log_t, d_raw)
    out_d, ops_d = _bmm_operands(
        monkeypatch, lambda: tbwd.composite_tiles_bwd_torch(*args, **kw))
    out_b, ops_b = _bmm_operands(
        monkeypatch, lambda: tbwd.composite_tiles_bwd_torch(
            *args, precision="default", **kw))
    assert len(ops_b) == len(ops_d) > 2
    for (a, b), (ab, bb) in zip(ops_d, ops_b):
        np.testing.assert_array_equal(ab.view(np.uint32),
                                      _bf16_np(a).view(np.uint32))
        np.testing.assert_array_equal(bb.view(np.uint32),
                                      _bf16_np(b).view(np.uint32))
    rounded = rec_t.clone()
    rounded[8:] = torch.as_tensor(_bf16_np(rec_t[8:].numpy()))
    geo = tbwd.composite_tiles_bwd_torch(
        rounded, *args[1:5], torch.as_tensor(_bf16_np(d_raw.numpy())),
        **kw)
    assert torch.equal(out_b[:6], geo[:6])
    # the value rows' size, sum_p |d_acc| |w| at each pair's slot: the
    # second product of each chunk, walked last chunk first
    size = np.zeros(tuple(out_b.shape), np.float32)
    s, c = starts.long().numpy(), counts.long().numpy()
    base, chunk = s - s % kw["chunk"], kw["chunk"]
    lane = np.arange(chunk)
    chunks = list(range(int(nact.max()) - 1, -1, -1))
    for k, (da, w) in zip(chunks, ops_d[1::2]):
        ok = ((lane >= (s - base - k * chunk)[:, None])
              & (lane < (s - base + c - k * chunk)[:, None])
              & (k < nact.reshape(-1).numpy())[:, None])     # (T, G)
        part = np.matmul(np.abs(da), np.abs(w))              # (T, CV, G)
        slot = base[:, None] + k * chunk + lane[None, :]
        size[8:, slot[ok]] = part.transpose(1, 0, 2)[:, ok]
    d_j = np.asarray(pallas_composite_tiles_bwd(
        *(jnp.asarray(x.numpy()) for x in args), **kw, precision="default"))
    n = int(c.sum())
    atol = np.full((out_b.shape[0], 1), ATOL_RGB, np.float32)
    err = np.abs(out_b.numpy()[8:, :n] - d_j[8:, :n])
    assert np.all(err <= 2 * BF16_STEP * size[8:, :n] + atol[8:])
    np.testing.assert_allclose(out_d.numpy()[8:, :n], d_j[8:, :n],
                               atol=ATOL_RGB, rtol=1e-4)
    assert float((out_b[8:] - out_d[8:]).abs().max()) > 10 * ATOL_RGB


# ------------------------------------------------------------- training

SHIP = dict(pack_records=True, unsort_impl="gather", power_impl="mxu")


@pytest.fixture(scope="module")
def world():
    scene = tsyn.make_gt_scene(n_fg=60, n_bg=120, seed=0)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=1, num_cams=2, w=64, h=48,
                                    f=55.0, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    k = [[55.0, 0, 32], [0, 55.0, 24], [0, 0, 1]]
    ds = [{"camera": jcam.make_camera(64, 48, k, np.asarray(
               fr["camera"].w2c.numpy(), np.float64), near=0.01, far=100.0),
           "im": jnp.asarray(fr["im"].numpy()),
           "seg": jnp.asarray(fr["seg"].numpy()),
           "cam_id": jnp.int32(fr["cam_id"])} for fr in tds[0]]
    return ds, tds[0], pt, w2c


def _step(world, raster, port=True):
    ds, tds, pt, w2c = world
    kw = dict(num_timesteps=1, iters_first_timestep=1, capacity=512,
              densify_start=10 ** 9)
    jp, jv = JG.init_params(pt, w2c, capacity=512)
    js = jopt.init(jp)
    lrs = {k: float(v) * (float(jv["scene_radius"]) if k == "means3D"
                          else 1.0) for k, v in jconf.TrainConfig().lrs
           .items()}
    lrs = {k: lrs.get(k, 0.0) for k in jp}
    if not port:
        cfg = jconf.TrainConfig(raster=jconf.RasterSettings(
            chunk=64, method="pallas", **raster), **kw)
        step = jtr.make_train_step(cfg, jtr.raster_config(cfg))
        p2, _, _, m = step(jp, js, jv, ds[1],
                           {k: jnp.float32(v) for k, v in lrs.items()},
                           is_initial=True)
        return {k: np.asarray(v) for k, v in p2.items()}, float(m["loss"]), \
            lrs
    cfg = tconf.TrainConfig(raster=tconf.RasterSettings(
        chunk=64, method="torch", **raster), **kw)
    step = ttr.make_train_step(cfg, ttr.raster_config(cfg))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")
    p2, _, _, m = step(tp, convert.adam_state_from_jax(
        {k: np.asarray(v) for k, v in js.mu.items()},
        {k: np.asarray(v) for k, v in js.nu.items()}, js.step, "cpu"),
        convert.variables_from_jax({k: np.asarray(v) for k, v in jv.items()},
                                   "cpu"), tds[1],
        {k: torch.tensor(v) for k, v in lrs.items()}, True)
    return {k: v.numpy() for k, v in p2.items()}, float(m["loss"]), lrs


def test_train_ship_step_matches_jax(world):
    """One t = 0 train step under the reference's shipped settings: the
    loss within 1e-5 relative, the new parameters within 2 lr (Adam's
    first step moves each element by +-lr, its sign the gradient's, which
    a bf16 step of a near-zero gradient may flip), as in
    tests/test_torch_train.py; the pack moves the loss by more."""
    tp, tl, lrs = _step(world, SHIP)
    jp, jl, _ = _step(world, SHIP, port=False)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2 * lrs[k] + 1e-6,
                                   rtol=0, err_msg=k)
    _, tl0, _ = _step(world, {})
    assert abs(tl - tl0) > 1e-5 * abs(jl)


def test_cli_train_with_reference_cfg_json(tmp_path):
    """A `cfg_args.json` written by the reference with the record pack,
    the fused cell and the gather unsort trains under the port's `cli
    train --config_json`, and its output config keeps them."""
    scene = tsyn.make_gt_scene(n_fg=30, n_bg=60, seed=1)
    tsyn.write_reference_layout(str(tmp_path / "data"), "seq", num_t=1,
                                num_cams=3, w=48, h=32, f=40.0, scene=scene,
                                device="cpu")
    ref = jconf.TrainConfig(report_every=1, densify_start=10 ** 9,
                            raster=jconf.RasterSettings(
                                chunk=64, pack_records=True,
                                power_impl="mxu_fused",
                                unsort_impl="gather"))
    path = tmp_path / "cfg_args.json"
    path.write_text(ref.to_json())
    argv = ["train", "--data_root", str(tmp_path / "data"), "--seq", "seq",
            "--exp", "e", "--output", str(tmp_path / "out"),
            "--timesteps", "1", "--iters_first", "3", "--capacity", "512",
            "--config_json", str(path), "--device", "cpu"]
    assert cli.main(argv) == 0
    run = tmp_path / "out" / "e" / "seq"
    raster = json.loads((run / "cfg_args.json").read_text())["raster"]
    assert (raster["pack_records"], raster["power_impl"],
            raster["unsort_impl"]) == (True, "mxu_fused", "gather")
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["t0/loss"] for r in rows if "t0/loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()


# ------------------------------------------------------------- playback

def test_playback_fused_rows_fault_of_the_reference():
    """tests/test_playback.py's scene and camera: the reference's cached
    frame against its exact render is within its 8-bit bound at "vpu",
    but at "mxu_fused" it is far off (its playback table leaves rows 6-7
    at zero: log2 opacity 0 for every gaussian); the port fills them, and
    its cached frame stays within the bound of its exact render."""
    a = random_scene(300, seed=0)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    k = [[60, 0, 32], [0, 60, 24], [0, 0, 1]]
    jc = jcam.make_camera(64, 48, k, w2c)
    tc = tcam.make_camera(64, 48, k, w2c, device="cpu")
    ja = tuple(map(jnp.asarray, a))
    geom = (a[0], a[2], a[3], a[4])
    err = {}
    for power in ("vpu", "mxu_fused"):
        jcfg = jrast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                                  max_tiles_per_gaussian=16,
                                  power_impl=power)
        exact = jrast.render(jc, *ja, method="pallas", config=jcfg)
        cache = jpb.build_cache(jc, *map(jnp.asarray, geom), config=jcfg)
        pb = jpb.render_playback(jc, *ja, cache, config=jcfg)
        err[power] = max(float(jnp.abs(pb.rgb - exact.rgb).max()),
                         float(jnp.abs(pb.alpha - exact.alpha).max()))
    assert err["vpu"] <= QUANTUM and err["mxu_fused"] > 0.1, err
    tcfg = trast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                              max_tiles_per_gaussian=16,
                              power_impl="mxu_fused")
    exact = trast.render(tc, *a, config=tcfg, device="cpu")
    cache = tpb.build_cache(tc, *geom, config=tcfg, device="cpu")
    pb = tpb.render_playback(tc, *a, cache, config=tcfg, device="cpu")
    for key in ("rgb", "alpha"):
        np.testing.assert_allclose(getattr(pb, key).numpy(),
                                   getattr(exact, key).numpy(),
                                   atol=QUANTUM, err_msg=key)
    assert float(exact.alpha.max()) > 0.5


# ------------------------------------------------------------- validation

def test_mxu_power_needs_small_tiles_as_in_the_reference():
    """power_impl "mxu" / "mxu_fused" on tiles wider than 16 pixels raises
    at the forward kernel in both packages (the reference's bilinear pixel
    features are exact in bf16 only up to 16-px tiles); "vpu" runs; an
    unknown power_impl is refused by the config."""
    rec = np.zeros((16, 128), np.float32)
    zero = np.zeros((1,), np.int32)
    kw = dict(num_tiles=1, grid_w=1, tile_h=32, tile_w=32, chunk=128)
    for power in ("mxu", "mxu_fused"):
        with pytest.raises(ValueError, match="tile_h, tile_w <= 16"):
            pallas_composite_tiles(jnp.asarray(rec), jnp.asarray(zero),
                                   jnp.asarray(zero), power_impl=power, **kw)
        with pytest.raises(ValueError, match="tile_h, tile_w <= 16"):
            tfwd.composite_tiles(torch.as_tensor(rec), torch.as_tensor(zero),
                                 torch.as_tensor(zero), power_impl=power,
                                 **kw)
    raw = tfwd.composite_tiles(torch.as_tensor(rec), torch.as_tensor(zero),
                               torch.as_tensor(zero), **kw)[0]
    assert tuple(raw.shape) == (1, 1024, 8)
    with pytest.raises(ValueError, match="power_impl"):
        trast.RasterConfig(power_impl="tensor_core")


def test_shared_memory_sizes_and_the_refusal():
    """The blocks' shared memory as the launchers size it: K1 at CV 40 and
    chunk 256 (bench.py's chunk) stages 106,496 bytes, K2 at CV 48 and
    chunk 256 179,232; past the H100's 232,448 the wrappers raise with the
    size before any launch."""
    assert tfwd.fwd_shared_bytes(40, 256) == 106_496
    assert tbwd.bwd_shared_bytes(48, 256, 16, 16) == 179_232
    tfwd.check_shared("K2", tbwd.bwd_shared_bytes(48, 256, 16, 16), 48, 256)
    with pytest.raises(ValueError, match="245760 bytes"):
        tfwd.check_shared("K1", tfwd.fwd_shared_bytes(48, 512), 48, 512)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_smoke_bf16_check_rejects_default_body(monkeypatch, kernel):
    """chip_smoke.py's BF16 check, on the CPU (the wrappers take the plain
    versions there): the plain BF16 version passes it, and a kernel that
    ignores the BF16 bit and runs the default body fails it -- its mean
    distance to the plain BF16 version is no smaller than to the plain
    default one."""
    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd as K2
    from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "W", 160)
    monkeypatch.setattr(cs, "H", 96)
    rec, st, cn, n_chan, kw = cs.bench_records(cs.bench_scene(n=3000),
                                               "seg_colors", "cpu")

    def check():
        if kernel == "k1":
            return cs.k1_against_plain(rec, st, cn, n_chan, kw,
                                       precision="default")[0]
        return cs.k2_against_plain(rec, st, cn, kw, "cpu",
                                   precision="default")[0]
    honest = check()
    assert honest["ok"] and honest["bf16_mean_ratio"] == 0.0
    plain_f, plain_b = K1.composite_tiles, K2.composite_tiles_bwd
    monkeypatch.setattr(K1, "composite_tiles", lambda *a, precision=None,
                        **k: plain_f(*a, **k))
    monkeypatch.setattr(K2, "composite_tiles_bwd", lambda *a, precision=None,
                        **k: plain_b(*a, **k))
    wrong = check()
    assert not wrong["ok"]
    assert wrong["bf16_mean_ratio"] > cs.BF16_MEAN_RATIO
