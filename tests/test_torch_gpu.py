"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch with CUDA and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest sets JAX up.) Each kernel is held
against its plain PyTorch version on the same card. Tolerances of the
forward kernel K1: channel rows atol 1e-4, depth row and log2 transmittance
1e-3 -- the alpha chain is computed identically, the sums in another order
(sequential against cumsum + bmm) -- and n_active exact. Of the backward
kernel K2: per gradient row, |kernel - plain| <= 1e-3 |plain| + 1e-4 x the
row's largest magnitude -- the kernel sums the tile's pixels by warp and
then over warps, and the suffix sequentially, the plain version with
torch.sum and cumsum, so float32 sums of up to 256 x 128 terms are
reassociated. The cases that test the kernels' footprint cull (a record
grazing a warp's edge, alpha exactly at 1/255) also require the set of
live cells to be the same on both sides: a pixel's alpha row, and a
record's opacity gradient, are nonzero in the kernel exactly where they
are in the plain version. K2 must give bitwise the same output on a
second launch. Of the probe kernel K3: 1e-5 relative on each walk's
scalar for the compute
variants (the same cell pipeline; the scan and the sums over 256 pixels in
another order) and 1e-6 for dma_only (sums of 4096 values per block). The
pair emission E1 must equal the plain emission bitwise (keys, gaussian
ids, n_dropped_rect), and the numpy model of E1 (`torch_emit_model.py`)
in the card's arithmetic. The physics kernel P1 against the plain edge
terms on the card: the losses relative 1e-5 and each gradient group
within 1e-5 of its largest |plain| + 1e-5 |plain| (float32 sums of up to
2 M edges in another order: the kernel's blocks against torch.sum over
every capacity slot, the chain rule per edge against autograd's over K),
and against its numpy model (`torch_physics_model.py`, the CPU's rsqrt
and no FMA) the same; rows past the plan's prefix and masked rows exactly
0; a replayed graph of it, and a replayed training window through it,
bitwise repeatable. The pair-to-gaussian sum U1 must equal its plain
version bitwise (the same adds in the same order), repeat bitwise, and
count one device run a render in a replayed window.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_emit_model as EM
import torch_physics_model as PM
from dynamic3dgaussians_tpu_torch.ops import binning as tbin
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import projection as tproj
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops.cuda import emit as E1
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.cuda import physics as P1
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd as K2
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
from dynamic3dgaussians_tpu_torch.ops.cuda import sol_probe as K3
from dynamic3dgaussians_tpu_torch.ops.cuda import unsort as U
from dynamic3dgaussians_tpu_torch.train import losses as L
from test_torch_cases import (CASES, GRID_H, GRID_W, LOG2E, TH, TW,
                              kernel_kw, record_table)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    kraw, klogt, knact = K1.composite_tiles(*args, **kernel_kw(chunk))
    torch.cuda.synchronize()
    assert K1.composite_tiles.launches == before + 1
    praw, plogt, pnact = K1.composite_tiles_torch(*args, **kernel_kw(chunk))
    rows = [i for i in range(kraw.shape[-1]) if i != n_chan]
    torch.testing.assert_close(kraw[..., rows], praw[..., rows], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(kraw[..., n_chan], praw[..., n_chan],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(klogt, plogt, atol=1e-3, rtol=0)
    assert torch.equal(knact, pnact)


def test_cuda_kernel_refuses_unbuilt_width(cuda_device):
    """CV = 56 has no kernel instance: a CUDA tensor raises, it never falls
    back to the plain version."""
    rec, starts, counts, _ = record_table(seed=6, counts=[5] * 12,
                                          n_chan=50, chunk=64)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    with pytest.raises(ValueError):
        K1.composite_tiles(*args, **kernel_kw(64))
    assert K1.composite_tiles.launches == before


def _scene(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (means, colors, opac, scales, quats), seg


def test_cuda_render_matches_torch_path(cuda_device):
    arrays, seg = _scene(300, seed=3)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(128, 96, [[90.0, 0, 64], [0, 90.0, 48],
                                     [0, 0, 1]], w2c, device=cuda_device)
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    extra = torch.as_tensor(seg, device=cuda_device)
    before = K1.composite_tiles.launches
    k = trast.render(cam, *args, extra_channels=extra, device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    p = trast.render(cam, *args, extra_channels=extra, method="torch",
                     device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    assert int(k.n_dropped_rect) == 0
    for name in ("rgb", "alpha", "extra"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   atol=1e-4, rtol=0)
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3, rtol=0)
    torch.testing.assert_close(k.radii, p.radii, atol=0, rtol=0)


def assert_rows_close(got, want, rtol=1e-3, row_atol=1e-4):
    """|got - want| <= rtol |want| + row_atol * max |want| of the row."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    err = (got - want).abs() - rtol * want.abs() - row_atol * scale
    assert float(err.max()) <= 0.0, float(err.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_bwd_kernel_matches_plain(cuda_device, case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, _ = record_table(**spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    kw = kernel_kw(chunk)
    raw, log_t, n_active = K1.composite_tiles(*args, **kw)
    d_raw = torch.as_tensor(np.random.RandomState(11).normal(
        size=tuple(raw.shape)).astype(np.float32), device=cuda_device)
    bwd_args = args + [n_active.reshape(-1), log_t, d_raw]
    before = K2.composite_tiles_bwd.launches
    k = K2.composite_tiles_bwd(*bwd_args, **kw)
    torch.cuda.synchronize()
    assert K2.composite_tiles_bwd.launches == before + 1
    again = K2.composite_tiles_bwd(*bwd_args, **kw)
    p = K2.composite_tiles_bwd_torch(*bwd_args, **kw)
    assert torch.isfinite(k).all()
    assert float(k.abs().max()) > 0
    assert torch.equal(k, again)     # deterministic: no atomics
    assert_rows_close(k, p)


def test_cuda_bwd_kernel_refuses_unbuilt_width(cuda_device):
    rec, starts, counts, _ = record_table(seed=6, counts=[5] * 12,
                                          n_chan=50, chunk=64)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    n_val = rec.shape[0] - 8
    before = K2.composite_tiles_bwd.launches
    with pytest.raises(ValueError):
        K2.composite_tiles_bwd(
            *args, torch.ones(12, dtype=torch.int32, device=cuda_device),
            torch.zeros((12, 256, 1), device=cuda_device),
            torch.zeros((12, 256, n_val), device=cuda_device),
            **kernel_kw(64))
    assert K2.composite_tiles_bwd.launches == before


def test_cuda_train_step(cuda_device):
    """One train step through both kernels on the card: the gradients are
    finite and agree with the plain versions' on the same card (per group,
    rel 1e-3 against max(|g|, 1)), and the step updates the parameters."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)

    scene = synthetic.make_gt_scene(n_fg=60, n_bg=120, seed=0)
    data, w2c, _ = synthetic.make_dataset(scene, 1, num_cams=2, w=64, h=48,
                                          f=55.0, device=cuda_device)
    pt = synthetic.init_point_cloud(scene, noise=0.05)

    def grads(method):
        cfg = TrainConfig(num_timesteps=1, capacity=1024, raster=RasterSettings(
            chunk=64, max_tiles_per_gaussian=64, method=method))
        params, variables = G.init_params(pt, w2c, capacity=1024,
                                          device=cuda_device)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        probe = torch.zeros((1024, 2), device=cuda_device,
                            requires_grad=True)
        loss, _ = T.compute_loss(leaves, probe, data[0][0], variables,
                                 is_initial=True, cfg=cfg,
                                 rcfg=T.raster_config(cfg))
        keys = ["means3D", "rgb_colors", "logit_opacities", "log_scales",
                "unnorm_rotations"]
        g = torch.autograd.grad(loss, [leaves[k] for k in keys] + [probe])
        return cfg, params, variables, float(loss.detach()), dict(zip(keys + ["probe"],
                                                             g))

    k1, k2 = K1.composite_tiles.launches, K2.composite_tiles_bwd.launches
    cfg, params, variables, loss_k, g_k = grads("cuda")
    assert K1.composite_tiles.launches == k1 + 1
    assert K2.composite_tiles_bwd.launches == k2 + 1
    _, _, _, loss_p, g_p = grads("torch")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for name, g in g_k.items():
        assert torch.isfinite(g).all(), name
        scale = torch.clamp(g_p[name].abs(), min=1.0)
        assert float(((g - g_p[name]).abs() / scale).max()) <= 1e-3, name
    assert float(g_k["means3D"].abs().max()) > 0

    step = T.make_train_step(cfg, T.raster_config(cfg))
    lrs = {k: torch.tensor(cfg.lrs.get(k, 0.0), device=cuda_device)
           for k in params}
    new_params, _, new_vars, metrics = step(
        {k: v.detach() for k, v in params.items()}, optim.init(params),
        variables, data[0][1], lrs, True)
    assert np.isfinite(float(metrics["loss"]))
    assert float((new_params["rgb_colors"] - params["rgb_colors"].detach())
                 .abs().max()) > 0
    assert float(new_vars["denom"].sum()) > 0


def assert_k3_close(rec, kind):
    """K3 on `rec` against its plain version, each walk's two parts on
    their own: |kernel - plain| <= rtol |plain| + atol, with rtol 1e-5
    (compute variants) or 1e-6 (dma_only), atol 1e-3 on the acc part and
    1e-2 on the value corner (sums that may cancel). One launch."""
    before = K3.sol_probe.launches
    k = K3.sol_probe(rec, kind)
    torch.cuda.synchronize()
    assert K3.sol_probe.launches == before + 1
    p = K3.sol_probe_torch(rec, kind)
    assert k.shape == p.shape == (rec.shape[0], 2)
    assert torch.isfinite(k).all()
    rtol = 1e-6 if kind == "dma_only" else 1e-5
    atol = torch.tensor([0.0, 1e-2] if kind == "dma_only" else [1e-3, 0.0],
                        device=rec.device)
    assert bool(((k - p).abs() <= rtol * p.abs() + atol).all()), (k, p)


@pytest.mark.parametrize("kind", K3.KINDS)
def test_cuda_sol_probe_matches_plain(cuda_device, kind):
    """K3 over a batch of walks (8 blocks each) against its plain version."""
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import card_table
    assert_k3_close(card_table(6, 8, cuda_device, seed=2), kind)


@pytest.mark.parametrize("table", ("wide_alpha", "one_chunk"))
@pytest.mark.parametrize("kind", K3.KINDS)
def test_cuda_sol_probe_wide_alpha_and_one_chunk(cuda_device, kind, table):
    """K3 against its plain version on the wide-alpha table (a live cell's
    alpha spans [1/255, 0.99], so log2(1 - alpha) and transmittance range
    far beyond the bench table's) over 8 walks of 16 blocks, and on walks
    of a single block."""
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import (
        card_table, wide_alpha_table)
    assert_k3_close(wide_alpha_table(8, 16, cuda_device, seed=4)
                    if table == "wide_alpha"
                    else card_table(5, 1, cuda_device, seed=6), kind)


EPS32 = float(np.float32(1.0 / 255.0))


def explicit_table(tiles, n_chan=3, chunk=64, seed=0):
    """A record table from explicit records: `tiles` lists, per tile of the
    GRID_W x GRID_H grid, its records (x, y, a, b, c, op) in image pixels,
    the conic as the covariance's inverse (scaled by log2 e here). Values
    are seeded, depth rises in list order."""
    rng = np.random.RandomState(seed)
    counts = np.array([len(t) for t in tiles], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    ne = int(counts.sum())
    n_val = -(-(n_chan + 2) // 8) * 8
    rec = np.zeros((8 + n_val, (-(-ne // chunk) + 1) * chunk), np.float32)
    recs = [r for t in tiles for r in t]
    for j, (x, y, a, b, c, op) in enumerate(recs):
        rec[:6, j] = [x, y, a * LOG2E, b * LOG2E, c * LOG2E, op]
    rec[8:8 + n_chan, :ne] = rng.uniform(0, 1, (n_chan, ne))
    rec[8 + n_chan, :ne] = np.linspace(1.0, 8.0, ne)
    rec[8 + n_chan + 1, :ne] = 1.0
    return rec, starts, counts, n_chan


def _run_both(dev, rec, starts, counts, n_chan, chunk, live_grads=True):
    """K1 and K2 and their plain versions on one table: the tolerances of
    the tests above, K2's bitwise repeat, and the same live cells. With
    `live_grads`, a record's opacity gradient is nonzero in K2 exactly
    where it is in the plain version (not on opaque tiles, where T
    underflows and an exact zero depends on the order of the sums)."""
    args = [torch.as_tensor(a, device=dev) for a in (rec, starts, counts)]
    kw = kernel_kw(chunk)
    kraw, klogt, knact = K1.composite_tiles(*args, **kw)
    praw, plogt, pnact = K1.composite_tiles_torch(*args, **kw)
    rows = [i for i in range(kraw.shape[-1]) if i != n_chan]
    torch.testing.assert_close(kraw[..., rows], praw[..., rows], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(klogt, plogt, atol=1e-3, rtol=0)
    assert torch.equal(knact, pnact)
    # the alpha row (sum of w) is nonzero exactly where a cell is live
    assert torch.equal(kraw[..., n_chan + 1] > 0, praw[..., n_chan + 1] > 0)
    d_raw = torch.as_tensor(np.random.RandomState(5).normal(
        size=tuple(kraw.shape)).astype(np.float32), device=dev)
    bwd_args = args + [knact.reshape(-1), klogt, d_raw]
    k = K2.composite_tiles_bwd(*bwd_args, **kw)
    assert torch.equal(k, K2.composite_tiles_bwd(*bwd_args, **kw))
    p = K2.composite_tiles_bwd_torch(*bwd_args, **kw)
    assert torch.isfinite(k).all()
    assert_rows_close(k, p)
    if live_grads:    # d opacity: the live records
        assert torch.equal(k[5] != 0, p[5] != 0)
    return kraw, k, knact


def _origin(t):
    return (t % GRID_W) * TW, (t // GRID_W) * TH


def test_cuda_kernels_record_grazing_a_warp_edge(cuda_device):
    """Round and slanted splats placed so that their live region reaches a
    pixel on the first row or column of a neighbouring 8x4 warp within a
    relative 1e-6 to 1e-3 of the gate, from inside and outside: the warp
    whose edge is grazed walks the record whenever a cell of it is live."""
    a, op = 0.5, 0.5
    # live iff a d^2 <= 2 ln(op / EPS) (the table scales the conic by
    # log2 e, the gate is in base 2)
    r = np.sqrt(2.0 * np.log(op / EPS32) / a)        # b = 0
    tiles = []
    for t, eps in enumerate([-1e-3, -1e-5, -1e-6, 0.0, 1e-6, 1e-5, 1e-3,
                             -1e-6, 0.0, 1e-6, -1e-4, 1e-4]):
        ox, oy = _origin(t)
        if t < 7:     # from warp row 0 down onto row 4 (warp row 1)
            rec = (ox + 3.0, oy + 4.0 - r * (1 + eps), a, 0.0, a, op)
        elif t < 10:  # from warp column 1 left onto column 7 (column 0)
            rec = (ox + 7.0 + r * (1 + eps), oy + 9.0, a, 0.0, a, op)
        else:         # a slanted conic at its y-extreme, onto row 8
            ca, cb, cc = 0.3, 0.25, 0.6
            ry = np.sqrt(2.0 * np.log(op / EPS32) * ca
                         / (ca * cc - cb ** 2))
            dy = -ry * (1 + eps)
            rec = (ox + 5.0 - cb / ca * dy, oy + 8.0 + dy, ca, cb, cc, op)
        tiles.append([rec])
    rec, starts, counts, n_chan = explicit_table(tiles)
    raw, _, _ = _run_both(cuda_device, rec, starts, counts, n_chan, 64)
    assert float(raw[..., n_chan + 1].max()) > 0


def test_cuda_kernels_alpha_exactly_at_the_gate(cuda_device):
    """A record centred on a pixel with opacity 1/255 (float32) has alpha
    exactly 1/255 there (power 0) and is live at that pixel alone; one
    float32 step below it is dead everywhere. Both kernels and both plain
    versions put the cell on the same side of the gate."""
    below = float(np.nextafter(np.float32(EPS32), np.float32(0)))
    tiles = []
    for t in range(GRID_W * GRID_H):
        ox, oy = _origin(t)
        tiles.append([(ox + 2.0 + t % 5, oy + 3.0 + t % 7, 0.8, 0.1, 0.5,
                       EPS32 if t % 2 == 0 else below),
                      (ox + 13.0, oy + 14.5, 2.0, 0.1, 2.0, 0.6)])
    rec, starts, counts, n_chan = explicit_table(tiles)
    raw, d_out, _ = _run_both(cuda_device, rec, starts, counts, n_chan, 64)
    gate = raw[..., n_chan + 1]
    for t in range(GRID_W * GRID_H):
        px = 2 + t % 5 + TW * (3 + t % 7)
        assert (float(gate[t, px]) > 0) == (t % 2 == 0), t
        assert (float(d_out[5, 2 * t]) != 0) == (t % 2 == 0), t


def test_cuda_bwd_kernel_segment_sharing_a_chunk(cuda_device):
    """Segments that start inside the previous tile's last chunk: each
    block writes exactly its own segment's slots. K2 on the whole table
    equals, slot for slot and bit for bit, K2 run with every other tile
    emptied."""
    counts = np.array([100, 40, 90, 7, 64, 130, 1, 70, 33, 0, 95, 60],
                      np.int32)
    rec, starts, counts, n_chan = record_table(seed=7, counts=counts,
                                               n_chan=3, chunk=64)
    assert (starts % 64 != 0).sum() >= 8
    _, full, knact = _run_both(cuda_device, rec, starts, counts, n_chan, 64)
    dev = cuda_device
    args = [torch.as_tensor(a, device=dev) for a in (rec, starts)]
    kw = kernel_kw(64)
    raw, log_t, _ = K1.composite_tiles(*args, torch.as_tensor(counts,
                                                              device=dev),
                                       **kw)
    d_raw = torch.as_tensor(np.random.RandomState(5).normal(
        size=tuple(raw.shape)).astype(np.float32), device=dev)
    for t in (1, 3, 5, 6):
        only = np.zeros_like(counts)
        only[t] = counts[t]
        alone = K2.composite_tiles_bwd(
            *args, torch.as_tensor(only, device=dev), knact.reshape(-1),
            log_t, d_raw, **kw)
        seg = slice(int(starts[t]), int(starts[t] + counts[t]))
        assert torch.equal(alone[:, seg], full[:, seg]), t
        rest = torch.ones(alone.shape[1], dtype=torch.bool, device=dev)
        rest[seg] = False
        assert float(alone[:, rest].abs().max()) == 0.0, t


def test_cuda_kernels_opaque_stop_chunk128(cuda_device):
    """opaque_stop at the default chunk of 128 on 16x16 tiles: every tile
    dies in its first chunk of three, K2 walks only that one and leaves
    the later chunks' slots zero."""
    chunk = 128
    rec, starts, counts, n_chan = record_table(
        seed=3, counts=np.full(GRID_W * GRID_H, 258), n_chan=3, chunk=chunk,
        opaque=True)
    _, d_out, nact = _run_both(cuda_device, rec, starts, counts, n_chan,
                               chunk, live_grads=False)
    assert bool((nact == 1).all())
    for t in range(GRID_W * GRID_H):
        s = int(starts[t])
        first_end = (s // chunk + 1) * chunk
        assert float(d_out[:, first_end:s + int(counts[t])].abs().max()) \
            == 0.0
        assert float(d_out[:, s:first_end].abs().max()) > 0


# ---------------------------------------------------------------- E1

E1_K_ENUM = [(8, 16), (16, 32), (64, 128), (8, 128), (64, 16)]


def _on(proj, dev):
    return tproj.Projected(**{fl.name: getattr(proj, fl.name).to(dev)
                              for fl in dataclasses.fields(proj)})


@pytest.mark.parametrize("cull", (True, False))
@pytest.mark.parametrize("k,enum_cap", E1_K_ENUM)
def test_cuda_emit_matches_plain(cuda_device, k, enum_cap, cull):
    """E1 against its plain version (`emit_pairs` + `compact_pairs`) on the
    card, bitwise: the live pairs' tile keys and slots, the live count and
    n_dropped_rect, eagerly and at capacities below and above the live
    count; and against the numpy model of E1's passes in the card's
    arithmetic (torch's exp, log and sqrt there, division by a Python
    scalar as a multiplication by its float32 reciprocal). The tables hold
    bounds within an ulp of the gate and 300 rows (two blocks, the last
    ragged)."""
    math = EM.device_math(cuda_device)
    for seed in range(4):
        proj, op, _ = EM.emit_table(seed, n=300, enum_cap=enum_cap,
                                    math=math)
        op = op if cull else None
        dproj = _on(proj, cuda_device)
        dop = None if op is None else op.to(cuda_device)
        args = (EM.TILE, EM.TILE, EM.GRID_H, EM.GRID_W, k)
        before = E1.emit_pairs_cuda.launches
        got = E1.emit_pairs_cuda(dproj, *args, opacity=dop,
                                 enum_cap=enum_cap)
        torch.cuda.synchronize()
        assert E1.emit_pairs_cuda.launches == before + 1
        n_live = got.tile.shape[0]
        for cap in (None, n_live // 2, n_live + 9):
            got = E1.emit_pairs_cuda(dproj, *args, opacity=dop,
                                     enum_cap=enum_cap, pair_cap=cap)
            want = tbin.emit_live_pairs(dproj, *args, opacity=dop,
                                        enum_cap=enum_cap, pair_cap=cap)
            for a, b in zip(got[:4], want[:4]):
                assert torch.equal(a, b), (seed, cap)
            mt, ms, mc, md = EM.e1_compact_model(proj, op, *args, enum_cap,
                                                 math, pair_cap=cap,
                                                 block=E1.BLOCK)
            np.testing.assert_array_equal(got.tile.cpu().numpy(), mt)
            np.testing.assert_array_equal(got.slot.cpu().numpy(), ms)
            assert got.counts.tolist() == mc.tolist()
            assert int(got.n_dropped_rect) == int(md)


def test_cuda_emit_counts_its_runs_in_a_graph(cuda_device):
    """E1 at a pair capacity captured in a CUDA graph: each replay runs
    it (its device counter), the host count sees the capture once, and the
    replayed output is the eager one."""
    proj, op, _ = EM.emit_table(3, enum_cap=128,
                                math=EM.device_math(cuda_device))
    dproj, dop = _on(proj, cuda_device), op.to(cuda_device)
    args = (dproj, EM.TILE, EM.TILE, EM.GRID_H, EM.GRID_W, 64)
    kw = dict(opacity=dop, enum_cap=128)
    cap = E1.emit_pairs_cuda(*args, **kw).tile.shape[0] + 5
    want = E1.emit_pairs_cuda(*args, pair_cap=cap, **kw)
    launches.zero(E1.emit_pairs_cuda)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        E1.emit_pairs_cuda(*args, pair_cap=cap, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        got = E1.emit_pairs_cuda(*args, pair_cap=cap, **kw)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    assert E1.emit_pairs_cuda.launches == 2
    assert launches.runs(E1.emit_pairs_cuda) == 4


def test_cuda_render_emits_through_e1(cuda_device):
    """`render` on the card emits through E1 once per render; the plain
    path ("torch") never launches it."""
    arrays, seg = _scene(300, seed=5)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(128, 96, [[90.0, 0, 64], [0, 90.0, 48],
                                     [0, 0, 1]], w2c, device=cuda_device)
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = E1.emit_pairs_cuda.launches
    trast.render(cam, *args, device=cuda_device)
    assert E1.emit_pairs_cuda.launches == before + 1
    trast.render(cam, *args, method="torch", device=cuda_device)
    assert E1.emit_pairs_cuda.launches == before + 1


# ---------------------------------------------------------------- U1

# the table's channels: CV 8 (16 rows, RGB + 3 seg) and CV 40 (48 rows,
# RGB + 32 features + 3 seg)
U1_CHANS = {16: 6, 48: 38}
U1_FORMS = ("eager", "static", "stripe")
U1_K = 64


def _u1_case(dev, rows, form, seed=11):
    """(slot, d_pairs, n_slots, n, n_rows) of a rendered scene on the card:
    E1's pairs sorted into the record table (eagerly, at a capacity past
    the live count, or one of two `tile_shard.stripe_table` stripes, whose
    gaussians keep a subset of their slots), K1 forward and K2's gradient
    columns of a drawn upstream gradient (row stride NE_pad)."""
    from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
    from dynamic3dgaussians_tpu_torch.parallel.tile_shard import stripe_table
    n_chan = U1_CHANS[rows]
    arrays, _ = _scene(3000, seed=seed)
    means, _, opac, scales, quats = [torch.as_tensor(a, device=dev)
                                     for a in arrays]
    gen = torch.Generator(device=dev).manual_seed(seed)
    chans = torch.rand((means.shape[0], n_chan), generator=gen, device=dev)
    w2c = np.eye(4)
    w2c[2, 3] = 3.0
    cam = tcam.make_camera(320, 224, [[200.0, 0, 160], [0, 200.0, 112],
                                      [0, 0, 1]], w2c, device=dev)
    th = tw = 16
    grid_w = 320 // tw
    if form == "stripe":
        cfg = trast.RasterConfig(max_tiles_per_gaussian=U1_K)
        table, pairs, spec = stripe_table(cam, cfg, 2, 1, means, chans, opac,
                                          scales, quats)
        num_tiles = spec[1]
    else:
        proj = tproj.project(means, scales, quats, cam)
        op = torch.where(proj.valid, opac, torch.zeros_like(opac))
        table = SR.record_columns(proj, chans, op)
        num_tiles = grid_w * 224 // th

        def emit(pair_cap=None):
            return SR.emit(224, 320, proj, op, tile_h=th, tile_w=tw,
                           max_tiles_per_gaussian=U1_K, exact_cull=True,
                           enum_cap=0, pair_cap=pair_cap)
        pairs = emit()
    kw = dict(n_chan=n_chan, num_tiles=num_tiles, chunk=128,
              bits_z=SR.depth_key_bits(num_tiles), depth_mode="quantized",
              grid_w=grid_w, tile_h=th, tile_w=tw)
    table = table.detach()
    if form == "static":
        cap = pairs.tile.shape[0] + 1000
        rec_t, starts, counts, slot, _ = SR.prepare_records_static(
            emit(cap), table, pair_cap=cap, **kw)
    else:
        rec_t, starts, counts, slot = SR.prepare_records(pairs, table, **kw)
    geo = dict(num_tiles=num_tiles, grid_w=grid_w, tile_h=th, tile_w=tw,
               chunk=128)
    raw, log_t, n_active = K1.composite_tiles(rec_t, starts, counts, **geo)
    d_raw = torch.randn(raw.shape, generator=gen, device=dev)
    d_out = K2.composite_tiles_bwd(rec_t, starts, counts,
                                   n_active.reshape(-1), log_t, d_raw, **geo)
    n = table.shape[1]
    return (slot, d_out[:, :slot.shape[0]], U1_K * n, n,
            K1.GEOM_ROWS + n_chan + 1)


@pytest.mark.parametrize("form", U1_FORMS)
@pytest.mark.parametrize("rows", sorted(U1_CHANS))
def test_cuda_unsort_matches_plain(cuda_device, rows, form):
    """U1 against its plain version on the card, bitwise, on a rendered
    scene's pairs and K2's gradient columns: eagerly, in the static form
    (sink columns), on a tile stripe (subset slots); a second launch
    bitwise the first, one host launch and one device run each; the rows
    past the depth row zero; against the per-slot buffer's sum over K
    (`slot_sum`) within 2 (K - 1) 2^-24 sum |terms|."""
    from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
    slot, d_pairs, n_slots, n, n_rows = _u1_case(cuda_device, rows, form)
    assert d_pairs.shape[0] == rows and d_pairs.stride(0) > slot.shape[0]
    live = slot < n_slots
    assert int(live.sum()) > 1000
    assert bool((~live).any()) == (form == "static")
    launches.zero(U.unsort_sum_cuda)
    got = U.unsort_sum_cuda(slot, d_pairs, n_slots, n, n_rows)
    again = U.unsort_sum_cuda(slot, d_pairs, n_slots, n, n_rows)
    torch.cuda.synchronize()
    assert U.unsort_sum_cuda.launches == 2
    assert launches.runs(U.unsort_sum_cuda) == 2
    want = U.unsort_sum_plain(slot, d_pairs, n_slots, n, n_rows)
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    assert not bool(got[n_rows:].any()) and bool(got[:n_rows].any())
    full = SR.slot_sum(slot, d_pairs, n_slots, n)[:n_rows]
    terms = SR.slot_sum(slot, d_pairs.abs(), n_slots, n)[:n_rows]
    assert bool(((got[:n_rows] - full).abs()
                 <= 2 * (U1_K - 1) * 2.0 ** -24 * terms).all())
    if form == "stripe":
        # some gaussian's live slots skip a k
        s = slot[live]
        count = torch.bincount(s % n, minlength=n)
        last = torch.zeros(n, dtype=torch.int64, device=cuda_device)
        last = last.scatter_reduce(0, s % n, s // n + 1, "amax")
        assert bool((last > count).any())


def test_cuda_unsort_counts_its_runs_in_a_graph(cuda_device):
    """U1 captured in a CUDA graph: each replay runs it (its device
    counter), the host count sees the capture once, and every replay's
    output is bitwise the eager one."""
    slot, d_pairs, n_slots, n, n_rows = _u1_case(cuda_device, 16, "static")
    want = U.unsort_sum_cuda(slot, d_pairs, n_slots, n, n_rows)
    launches.zero(U.unsort_sum_cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        U.unsort_sum_cuda(slot, d_pairs, n_slots, n, n_rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = U.unsort_sum_cuda(slot, d_pairs, n_slots, n, n_rows)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert U.unsort_sum_cuda.launches == 2
    assert launches.runs(U.unsort_sum_cuda) == 4


# ---------------------------------------------------------------- P1

P1_TERMS = ("rigid", "rot", "iso")
P1_UPSTREAM = (4.0, 4.0, 2.0)
# (cap, n_pre, K, dead_nan): small graphs, and the bench training's table
# (800,768 rows, a 100,000-row foreground prefix, 20 neighbours)
P1_CASES = {"small_k20": (512, 301, 20, False),
            "small_k4_dead": (512, 333, 4, True),
            "bench": (800768, 100000, 20, False)}


def _p1_inputs(dev, case, seed=0):
    cap, n_pre, k, dead = P1_CASES[case]
    means, rots, variables, fg, alive = PM.edge_graph(seed, cap, n_pre, k,
                                                      dead_nan=dead)
    return (means, rots, variables, fg, alive,
            [means.to(dev), rots.to(dev),
             {key: v.to(dev) for key, v in variables.items()}, fg.to(dev),
             alive.to(dev)])


def _p1_terms(fn, means, rots, variables, fg):
    m = means.clone().requires_grad_(True)
    r = rots.clone().requires_grad_(True)
    out = fn(m, r, variables, fg)
    total = sum(g * out[k] for g, k in zip(P1_UPSTREAM, P1_TERMS))
    dm, dr = torch.autograd.grad(total, [m, r])
    return torch.stack([out[k].detach() for k in P1_TERMS]), dm, dr


def _assert_p1_close(got, want, alive, what):
    losses, dm, dr = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                      for x in got)
    wl, wdm, wdr = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                    for x in want)
    np.testing.assert_allclose(losses, wl, rtol=1e-5, atol=0, err_msg=what)
    a = np.asarray(alive.cpu())[:, None]
    for name, g, w in (("means", dm, wdm), ("rots", dr, wdr)):
        g, w = np.where(a, g, 0.0), np.where(a, w, 0.0)
        err = np.abs(g - w)
        assert (err <= 1e-5 * np.abs(w).max() + 1e-5 * np.abs(w)).all(), \
            (what, name, float(err.max()), float(np.abs(w).max()))


@pytest.mark.parametrize("case", sorted(P1_CASES))
def test_cuda_physics_matches_plain(cuda_device, case):
    """P1's losses and gradients against the plain edge terms on the card
    and, on the small graphs, against the numpy model of its passes; the
    kernel's gradient rows past the prefix exactly 0, one forward and one
    backward launch a call."""
    means, rots, variables, fg, alive, dev_in = _p1_inputs(cuda_device,
                                                           case)
    before = (P1.edge_losses_cuda.launches, P1.edge_grads_cuda.launches)
    got = _p1_terms(P1.edge_losses_cuda, *dev_in[:4])
    torch.cuda.synchronize()
    assert (P1.edge_losses_cuda.launches,
            P1.edge_grads_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = _p1_terms(L.edge_losses_torch, *dev_in[:4])
    _assert_p1_close(got, want, alive, "vs plain")
    n_dst = variables["edge_row_ptr"].shape[0] - 1
    assert not got[1][n_dst:].any() and not got[2][n_dst:].any()
    if case != "bench":
        ml, _, mdm, mdr = PM.p1_model(means, rots, variables, fg,
                                      P1_UPSTREAM)
        _assert_p1_close(got, (ml, mdm, mdr), alive, "vs model")


def test_cuda_physics_counts_its_runs_in_a_graph(cuda_device):
    """P1's forward and backward captured in one CUDA graph: each replay
    runs both (their device counters), the host counts see the capture
    once, and every replay's output is bitwise the eager one."""
    *_, dev_in = _p1_inputs(cuda_device, "small_k20")
    means, rots, variables, fg, _ = dev_in
    m = means.clone().requires_grad_(True)
    r = rots.clone().requires_grad_(True)

    def run():
        out = P1.edge_losses_cuda(m, r, variables, fg)
        total = sum(g * out[k] for g, k in zip(P1_UPSTREAM, P1_TERMS))
        dm, dr = torch.autograd.grad(total, [m, r])
        return torch.stack([out[k] for k in P1_TERMS]).detach(), dm, dr

    want = run()
    launches.zero(P1.edge_losses_cuda)
    launches.zero(P1.edge_grads_cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for fn in (P1.edge_losses_cuda, P1.edge_grads_cuda):
        assert fn.launches == 2
        assert launches.runs(fn) == 4


def _p1_world(dev, num_cams=3):
    """A t = 1 state of a small synthetic scene on the card (the port's own
    t = 0 -> t = 1 transition: kNN graph, foreground prefix, extrapolation)
    and its `num_cams` cameras."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    scene = synthetic.make_gt_scene(n_fg=50, n_bg=90, seed=3)
    data, w2c, _ = synthetic.make_dataset(scene, 2, num_cams=num_cams, w=64,
                                          h=48, f=55.0, device=dev)
    pt = synthetic.init_point_cloud(scene, noise=0.05)
    cfg = TrainConfig(num_timesteps=2, capacity=512, num_knn=8,
                      raster=RasterSettings(chunk=64, max_per_tile=512,
                                            max_tiles_per_gaussian=64,
                                            pairs_per_gaussian=16))
    params, variables = G.init_params(pt, w2c, capacity=512, device=dev)
    opt = optim.init(params)
    params, variables, opt, _ = G.compact_with_optimizer(params, variables,
                                                         opt)
    params, variables, opt = T.initialize_post_first_timestep(
        params, variables, cfg, opt)
    params, variables, opt = T.initialize_per_timestep(params, variables,
                                                       opt)
    lrs = {key: torch.tensor(1e-3, device=dev) for key in params}
    return (params, opt, variables), data[1], cfg, lrs


def test_cuda_train_step_and_window_run_p1(cuda_device):
    """A t = 1 train step on the card routes its edge terms through P1 (one
    forward and one backward launch) and its render's backward sum through
    U1 (one launch), and a training window of 4 steps (a CUDA graph of the
    step, replayed) runs P1 and U1 once a step on the device
    and gives bitwise the same state on a second call from the same
    start."""
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    state, frames, cfg, lrs = _p1_world(cuda_device)
    rcfg = T.raster_config(cfg)
    step = T.make_train_step(cfg, rcfg)
    before = (P1.edge_losses_cuda.launches, P1.edge_grads_cuda.launches,
              U.unsort_sum_cuda.launches)
    _, _, _, m = step(*state, frames[0], lrs, False)
    torch.cuda.synchronize()
    assert (P1.edge_losses_cuda.launches, P1.edge_grads_cuda.launches,
            U.unsort_sum_cuda.launches) == (before[0] + 1, before[1] + 1,
                                            before[2] + 1)
    assert float(m["loss_rigid"]) > 0 and np.isfinite(float(m["loss"]))

    sel = torch.tensor([0, 2, 1, 0])
    scan = T.make_train_scan(cfg, rcfg, step)
    stack = T.stack_timestep_data(frames)
    outs = []
    for _ in range(2):
        for fn in (P1.edge_losses_cuda, P1.edge_grads_cuda,
                   U.unsort_sum_cuda):
            launches.zero(fn)
        p, o, v, _ = scan(*state, stack, sel, lrs, False)
        torch.cuda.synchronize()
        assert launches.runs(P1.edge_losses_cuda) == 4
        assert launches.runs(P1.edge_grads_cuda) == 4
        assert launches.runs(U.unsort_sum_cuda) == 4
        outs.append((p, o))
    assert scan.window.stats["replays"] > 0
    (p1, o1), (p2, o2) = outs
    for key in p1:
        assert torch.equal(p1[key], p2[key]), key
        assert torch.equal(o1.mu[key], o2.mu[key]), key
        assert torch.equal(o1.nu[key], o2.nu[key]), key


def _ego_world(dev):
    """The t = 1 state of `_p1_world` with 5 cameras as the ego + static
    trainer's: camera 0 the ego frame (turned by -90 degrees, the bottom
    right triangle masked, colour row 4), 1-4 the static rig (flat depth
    ground truth); the ego step on that rig, its window, the ego frames'
    stack."""
    from dynamic3dgaussians_tpu_torch.train import ego_trainer as TE
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    state, frames, cfg, lrs = _p1_world(dev, num_cams=5)
    h, w = frames[0]["im"].shape[:2]
    y = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    x = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    ego = [dict(camera=frames[0]["camera"], cam_id=4,
                im=torch.rot90(frames[0]["im"], k=-1, dims=(0, 1)),
                mask=((y[:, None] + x[None, :]) <= 1.5).float())]
    rig = TE.StaticRig([dict(camera=f["camera"], im=f["im"], cam_id=f["cam_id"],
                             gt_depth=torch.full((h, w), 4.0, device=dev))
                        for f in frames[1:]])
    rcfg = T.raster_config(cfg)
    step = TE.make_ego_step(cfg, rcfg, rot90_ego=True, rig=rig)
    scan = T.make_train_scan(cfg, rcfg, step)
    return state, ego, T.stack_timestep_data(ego), step, scan, lrs


EGO_STEPS = 6


def test_cuda_ego_window_replays_its_eager_steps(cuda_device):
    """The ego + static step (one ego and four static renders) captured in
    a CUDA graph with no host read (a host read inside the capture raises)
    and replayed: a window of EGO_STEPS steps gives bitwise the state and
    the losses of the same steps run eagerly, and a second window from the
    same start, all replays, the same again."""
    state, ego, stack, step, scan, lrs = _ego_world(cuda_device)
    eager, losses = state, []
    for _ in range(EGO_STEPS):
        *eager, m = step(*eager, ego[0], lrs, False)
        losses.append(m["loss"])
    sel = torch.zeros(EGO_STEPS, dtype=torch.int64)
    for n in range(2):
        p, o, v, _ = scan(*state, stack, sel, lrs, False)
        torch.cuda.synchronize()
        st = scan.window.stats
        assert (st["captures"], st["replays"], st["redos"]) == \
            (1, (EGO_STEPS - 2) + n * EGO_STEPS, 0)
        assert torch.equal(scan.window.last_steps["loss"],
                           torch.stack(losses))
        for key in p:
            assert torch.equal(p[key], eager[0][key]), key
            assert torch.equal(o.mu[key], eager[1].mu[key]), key
            assert torch.equal(o.nu[key], eager[1].nu[key]), key
        for key in ("means2D_gradient_accum", "denom", "max_2D_radius"):
            assert torch.equal(v[key], eager[2][key]), key
    assert float(losses[0]) > 0 and np.isfinite(float(losses[-1]))


def test_cuda_ego_window_runs_each_kernel_once_a_render(cuda_device):
    """In a replayed ego window the device run counters see K1, K2, E1 and
    U1 five times a step (the ego render and four static ones) and P1's
    forward and backward once a step; the host counts see no launch."""
    state, ego, stack, _, scan, lrs = _ego_world(cuda_device)
    sel = torch.zeros(EGO_STEPS, dtype=torch.int64)
    scan(*state, stack, sel, lrs, False)                  # captures
    per_render = (K1.composite_tiles, K2.composite_tiles_bwd,
                  E1.emit_pairs_cuda, U.unsort_sum_cuda)
    per_step = (P1.edge_losses_cuda, P1.edge_grads_cuda)
    for fn in per_render + per_step:
        launches.zero(fn)
    hosts = [fn.launches for fn in per_render + per_step]
    scan(*state, stack, sel, lrs, False)                  # replays only
    torch.cuda.synchronize()
    assert scan.window.stats["captures"] == 1
    for fn in per_render:
        assert launches.runs(fn) == 5 * EGO_STEPS, fn.__name__
    for fn in per_step:
        assert launches.runs(fn) == EGO_STEPS, fn.__name__
    assert [fn.launches for fn in per_render + per_step] == hosts


def test_cuda_train_ego_in_windows_is_its_eager_run(cuda_device, monkeypatch):
    """`train_ego` with steps_per_call 4 on the card, its windows a
    captured CUDA graph of the ego step replayed, over a t = 0 and a t = 1
    timestep: bitwise the parameters of the same run one step a call."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.train import ego_trainer as TE
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    scene = synthetic.make_gt_scene(n_fg=50, n_bg=90, seed=3)
    data, w2c, _ = synthetic.make_dataset(scene, 2, num_cams=5, w=64, h=48,
                                          f=55.0, device=cuda_device)
    pt = synthetic.init_point_cloud(scene, noise=0.05)
    ego = [[dict(camera=fr[0]["camera"], cam_id=fr[0]["cam_id"],
                 im=torch.rot90(fr[0]["im"], k=-1, dims=(0, 1)))]
           for fr in data]
    stat = [[dict(camera=f["camera"], im=f["im"], cam_id=f["cam_id"],
                  gt_depth=torch.full(f["im"].shape[:2], 4.0,
                                      device=cuda_device))
             for f in fr[1:]] for fr in data]
    scans = []
    make_scan = TE.make_train_scan

    def kept(*a, **kw):
        scans.append(make_scan(*a, **kw))
        return scans[-1]
    monkeypatch.setattr(TE, "make_train_scan", kept)
    runs = []
    for steps_per_call in (1, 4):
        cfg = TrainConfig(
            num_timesteps=2, iters_first_timestep=9, iters_per_timestep=13,
            capacity=512, num_knn=8, densify_start=1000, densify_end=0,
            report_every=6, steps_per_call=steps_per_call,
            raster=RasterSettings(chunk=64, max_per_tile=512,
                                  max_tiles_per_gaussian=64,
                                  pairs_per_gaussian=16))
        runs.append(TE.train_ego(ego, stat, cfg, pt, w2c, rot90_ego=True,
                                 device=cuda_device)[1])
    (scan,) = scans
    assert scan.window.stats["captures"] == 2
    assert scan.window.stats["replays"] > 0
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
