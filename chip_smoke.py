#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dynamic3dgaussians_tpu_torch/csrc/`,
holds each kernel against its plain PyTorch version at the shapes the main
paths give it (K1 forward and K2 backward on two full-width tables, the
bench view and a stopping table on which most tiles stop early, at CV 8
and 40, K2 twice for a bitwise repeat; K3 the speed-of-light probe at the
bench shape, one walk and card-wide, and on a table whose alphas span
[1/255, 0.99]), counts the cells and (warp, record)
pairs the tile kernels walk, find live and keep after their footprint
cull, holds the kernel path's render gradients against the frozen golden
fixtures, drives the three main paths at full width -- `cli visualize` on
a 200k-gaussian, 3-timestep checkpoint at 640x360; `cli train` over 3
timesteps of a 200k scene seen by 4 cameras at 640x360 (30 steps at t = 0,
10 at each later one), timing its steps and the PSNR of every view before
and after each timestep; and the probe's entry point `tools/bench_sol.py`
-- and checks that each went through its kernels. Prints one JSON object
per phase; the last line is `{"ok": true, "device": {...}}`. Any failure
propagates and exits non-zero, as does a machine without CUDA. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Tolerances of kernel vs plain version, both float32 on the card. The
# alpha chain is computed identically (no FMA contraction in the kernel);
# the rest differs only in summation order (sequential vs cumsum/bmm). The
# margin covers a tile whose stop test lands on the other side of the
# 1e-4 threshold: one extra chunk adds at most T < 1e-4 per unit value.
ATOL_CHAN = 1e-4     # channel and alpha rows
ATOL_DEPTH = 1e-3    # depth row (values ~ z up to ~8)
ATOL_LOGT = 1e-3     # log2 transmittance
NACT_EQUAL_MIN = 0.999
# K2 against its plain version, per gradient row: |kernel - plain| <=
# RTOL_BWD |plain| + ROW_ATOL_BWD * (the row's largest |plain|). The kernel
# sums a tile's 256 pixels by warp (a reduce-scatter) then over warps, each
# pixel's suffix sequentially, and divides by 1 - alpha within 2 ulp; the
# plain version uses torch.sum and cumsum: float32 sums of up to 256 x
# (records walked) terms, reassociated.
RTOL_BWD = 1e-3
ROW_ATOL_BWD = 1e-4
# kernel-path render gradients against the frozen fixtures: the CPU row of
# tests/fixtures/TOLERANCES.md, |g - fixture| <= rel * max(|fixture|, 1)
REL_GOLDEN = 1e-2
# K3 against its plain version. The scalar of each walk (the sum of its two
# parts): relative error. The same cell pipeline, the scan and the sums over
# 256 pixels in another order (compute variants); sums of 4096 values per
# block (dma_only).
RTOL_K3 = {"compute_only": 1e-5, "stream_compute": 1e-5, "dma_only": 1e-6}
# Each part on its own, |kernel - plain| <= rtol |plain| + atol. The acc
# part (~10^2 against a log2T part of ~10^7 at the bench shape) is held
# relative to its own size; its atol (about 3e-6 of the sum of |acc| terms
# of a walk of this table, ~300) covers a walk whose acc sum cancels. The
# value corner of dma_only (a sum of ~2e6 values uniform in [-1, 1]) gets
# an atol for the same reason. A kernel that drops the acc update or gets
# w wrong (cum for cum - l, no log2T) moves the acc part by 24 % or more.
K3_PART_TOL = {
    "compute_only": {"acc": (1e-5, 1e-3), "log2T": (1e-5, 0.0)},
    "stream_compute": {"acc": (1e-5, 1e-3), "log2T": (1e-5, 0.0)},
    "dma_only": {"geometry_corner": (1e-6, 0.0),
                 "value_corner": (1e-6, 1e-2)}}

W, H, F = 640, 360, 500.0
N_GAUSS = 200_000
TILE = 16
CHUNK = 128


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_scene(seed=0, n=N_GAUSS, scales=(0.004, 0.015), opac=(0.5, 0.99)):
    """The JAX bench's scene statistics (bench.py): small, mostly opaque.
    `stop_scene` draws larger, more opaque splats from the same seed."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(*opac, (n,)).astype(np.float32)
    scales = rng.uniform(*scales, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = (rng.uniform(0, 1, (n,)) > 0.5).astype(np.float32)
    seg_colors = np.stack([seg, np.zeros_like(seg), 1.0 - seg], -1)
    feats = rng.uniform(0, 1, (n, 32)).astype(np.float32)
    return dict(means=means, colors=colors, opac=opac, scales=scales,
                quats=quats, seg_colors=seg_colors, feats=feats)


# The stopping table: the bench view of the bench scene's draws with splats
# 3-5x larger and opacity 0.9-0.99, K = 16 emission slots (no tile rect
# cut). Most tiles stop before their last chunk and about a third of the
# walked cells pass the gate (bench view: no tile stops, 7 % live).
STOP_SCALES = (0.02, 0.05)
STOP_OPAC = (0.9, 0.99)
STOP_K = 16
STOP_MIN_STOPPED = 0.5     # share of the tiles that stop early, at least
STOP_MIN_LIVE = 0.30       # share of the walked cells that are live


def stop_scene():
    return bench_scene(scales=STOP_SCALES, opac=STOP_OPAC)


def ptxas_summary(report: str):
    """{"raster_fwd_kernel<8>": "0 bytes spill stores, Used 39 registers",
    "sol_compute_kernel<1>": ..., "sol_dma_kernel": ...} from nvcc's
    -Xptxas -v report."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"((?:raster|sol)_[a-z]+_kernel)(?:IL[ib](\d+)E)?", ln)
        if m and "Compiling entry" in ln:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            out[name] = ""
        elif name and ("registers" in ln or "spill stores" in ln):
            part = (re.search(r"Used \d+ registers", ln)
                    or re.search(r"\d+ bytes spill stores", ln)).group(0)
            out[name] = f"{out[name]}, {part}" if out[name] else part
    return out


def cell_counts(rec_t, starts, counts, n_active):
    """Cells (record x pixel) the tile kernels walk on these inputs, those
    among them that pass the 1/255 gate, and the same for (warp, record)
    pairs: the pairs walked (each in-segment record of a processed chunk
    times the tile's warps), those with a live lane, and those the kernels'
    footprint cull keeps (`footprint_boxes` against each warp's pixel
    rectangle, `warp_pixel_map`). A live pair the cull would drop is
    counted in `pairs_live_culled`, which must be 0."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, \
        ALPHA_MAX
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        footprint_boxes, warp_pixel_map)
    p = TILE * TILE
    grid_w = -(-W // TILE)
    s = starts.long()
    c = counts.long()
    nact = n_active.reshape(-1).long()
    shift = s - (s // CHUNK) * CHUNK
    walked = torch.clamp(torch.minimum(c, nact * CHUNK - shift), min=0)
    walked = torch.where(nact > 0, walked, torch.zeros_like(walked))
    walked_cells = int(walked.sum()) * p

    dev = rec_t.device
    n_tiles = s.shape[0]
    # pixels in kernel-thread order: warp i holds positions 32 i .. 32 i + 31
    order = warp_pixel_map(TILE, TILE).to(dev)
    nwarps = p // 32
    tile = torch.arange(n_tiles, device=dev)
    lin = order
    ox = ((tile % grid_w) * TILE).float()
    oy = ((tile // grid_w) * TILE).float()
    px = ox[:, None] + (lin % TILE).float()
    py = oy[:, None] + (lin // TILE).float()
    wpx, wpy = px.reshape(n_tiles, nwarps, 32), py.reshape(n_tiles, nwarps, 32)
    rect = torch.stack([wpx.amin(2), wpx.amax(2), wpy.amin(2),
                        wpy.amax(2)])                       # (4, T, nwarps)
    boxes = footprint_boxes(rec_t)
    live_cells = pairs_live = pairs_kept = pairs_bad = 0
    lane = torch.arange(CHUNK, device=dev)
    base = s - shift
    for k in range(int(nact.max())):
        idx = torch.clamp(base[:, None] + k * CHUNK + lane,
                          max=rec_t.shape[1] - 1)
        g = rec_t[:6, idx]
        ok = ((lane >= (shift - k * CHUNK)[:, None])
              & (lane < (shift + c - k * CHUNK)[:, None])
              & (k < nact)[:, None])                       # (T, G)
        dx = g[0][:, None, :] - px[:, :, None]
        dy = g[1][:, None, :] - py[:, :, None]
        power = torch.clamp(-0.5 * (g[2][:, None] * dx * dx
                                    + g[4][:, None] * dy * dy)
                            - g[3][:, None] * dx * dy, max=0.0)
        alpha = torch.clamp(g[5][:, None] * torch.exp2(power), max=ALPHA_MAX)
        live = (alpha >= ALPHA_EPS) & ok[:, None, :]      # (T, P, G)
        live_cells += int(live.sum())
        live_pair = live.reshape(n_tiles, nwarps, 32, CHUNK).any(2)
        b = boxes[:, idx]                                  # (4, T, G)
        keep = ~((b[1][:, None] < rect[0][..., None])
                 | (b[0][:, None] > rect[1][..., None])
                 | (b[3][:, None] < rect[2][..., None])
                 | (b[2][:, None] > rect[3][..., None])) & ok[:, None, :]
        pairs_live += int(live_pair.sum())
        pairs_kept += int(keep.sum())
        pairs_bad += int((live_pair & ~keep).sum())
        del dx, dy, power, alpha, live
    return dict(walked_cells=walked_cells, live_cells=live_cells,
                pairs_walked=int(walked.sum()) * nwarps,
                pairs_live=pairs_live, pairs_kept=pairs_kept,
                pairs_live_culled=pairs_bad,
                walked_records_max_tile=int(walked.max()),
                walked_records_mean_tile=float(walked.float().mean()))


def bound(flops, bytes_):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    return dict(flops=flops, bytes=bytes_, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def cell_work(cells):
    """Operations the tile walk needs before the live cells' own work, on
    these inputs: each walked record's footprint box (~30 float32
    operations, once per tile), each walked (warp, record) pair's box
    test (4 compares) and, for each pair the test keeps, the alpha chain
    and gate on its 32 cells (16 operations: 2 sub, 5 quad, 5 power incl.
    min, exp2, mul, min, compare; a transcendental counts as one). The
    gate's result is the same on the cells of the pairs the test drops, so
    the data needs no more. `all_cells` is the same work with the chain on
    every walked cell, the bound of earlier versions, kept beside it."""
    nwarps = TILE * TILE // 32
    head = cells["pairs_walked"] // nwarps * 30 + cells["pairs_walked"] * 4
    return dict(kept=head + cells["pairs_kept"] * 32 * 16,
                all_cells=cells["walked_cells"] * 16)


def k1_work(cells, rec_t, n_tiles, n_val):
    """Operations and bytes K1 needs on these inputs (for the bound).

    The tile walk (`cell_work`), then per cell that passes the gate:
    1-alpha, log2, add, exp2, mul, the running-sum add and CV
    multiply-adds, 6 + 2*CV. Bytes: the table read once, the outputs
    written once.
    """
    p = TILE * TILE
    live = cells["live_cells"] * (6 + 2 * n_val)
    walk = cell_work(cells)
    bytes_ = (rec_t.numel() * 4 + 2 * n_tiles * 4
              + n_tiles * p * (n_val + 1) * 4 + n_tiles * 4)
    out = bound(walk["kept"] + live, bytes_)
    out["bound_ms_all_cells"] = bound(walk["all_cells"] + live,
                                      bytes_)["bound_ms"]
    return out


def k2_work(cells, rec_t, n_tiles, n_val):
    """Operations and bytes K2 needs on these inputs (for the bound).

    The tile walk (`cell_work`), then per live cell: 1-alpha, log2, the
    log_t step, exp2, w (5); dw, CV multiply-adds (2 CV); d_alpha and the
    suffix update (5); the clamp and power masks (4); the six geometry
    terms (17); the CV value terms d_acc * w (CV); and one add per term
    into the sums over the tile's pixels (6 + CV): 37 + 4 CV in all.
    Bytes: the table, d_raw, log_t and the three per-tile ints read once,
    d_out written once.
    """
    p = TILE * TILE
    live = cells["live_cells"] * (37 + 4 * n_val)
    walk = cell_work(cells)
    bytes_ = (rec_t.numel() * 4 + n_tiles * p * (n_val + 1) * 4
              + 3 * n_tiles * 4 + rec_t.numel() * 4)
    out = bound(walk["kept"] + live, bytes_)
    out["bound_ms_all_cells"] = bound(walk["all_cells"] + live,
                                      bytes_)["bound_ms"]
    return out


def bench_records(scene, extra_key, device, k=8):
    """The bench view's record table (640x360, f = 500, z = 6) at
    CV = 3 + extra + 2, rounded up to 8, with K = `k` emission slots."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import \
        sorted_records

    w2c = np.eye(4)
    w2c[2, 3] = 6.0
    cam = make_camera(W, H, [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], w2c,
                      device=device)
    t = {k: torch.as_tensor(v, device=device) for k, v in scene.items()}
    with torch.no_grad():
        proj = project(t["means"], t["scales"], t["quats"], cam)
        op = torch.where(proj.valid, t["opac"], torch.zeros_like(t["opac"]))
        chans = torch.cat([t["colors"], t[extra_key]], dim=-1)
        rec_t, starts, counts, drops = sorted_records(
            H, W, proj, chans, op, max_tiles_per_gaussian=k)
    if int(drops) != 0:
        raise AssertionError(f"n_dropped_rect = {int(drops)} on the bench "
                             f"view; the comparison needs a lossless table")
    kw = dict(num_tiles=starts.shape[0], grid_w=-(-W // TILE), tile_h=TILE,
              tile_w=TILE, chunk=CHUNK)
    return rec_t, starts, counts, chans.shape[1], kw


TABLES = {"bench": (bench_scene, 8), "stop": (stop_scene, STOP_K)}


def table_stats(table, rec_t, starts, counts, n_active):
    """`cell_counts` of a table, with the share of tiles that stop before
    their last chunk. Fails if the cull drops a live (warp, record) pair,
    or if the stopping table does not stop or is not live enough."""
    cells = cell_counts(rec_t, starts, counts, n_active)
    s, c = starts.long(), counts.long()
    n_chunks = (s % CHUNK + c + CHUNK - 1) // CHUNK
    nact = n_active.reshape(-1).long()
    stopped = float(((c > 0) & (nact < n_chunks)).float().mean())
    live = cells["live_cells"] / max(cells["walked_cells"], 1)
    stats = dict(cells, stopped_tile_share=stopped, live_cell_share=live)
    if cells["pairs_live_culled"]:
        raise AssertionError(f"the footprint cull drops live (warp, record) "
                             f"pairs on the {table} table: {stats}")
    if table == "stop" and (stopped < STOP_MIN_STOPPED
                            or live < STOP_MIN_LIVE):
        raise AssertionError(f"the stopping table stops {stopped:.3f} of its "
                             f"tiles and has {live:.3f} live cells")
    return stats


def phase_k1(table, extra_key, device, smi):
    """K1 against its plain version at full width on `table` ("bench": the
    bench view; "stop": the stopping table)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        composite_tiles, composite_tiles_torch)
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import cuda_ms

    make, k_slots = TABLES[table]
    rec_t, starts, counts, n_chan, kw = bench_records(make(), extra_key,
                                                      device, k=k_slots)
    n_val = rec_t.shape[0] - 8
    raw_k, logt_k, nact_k = composite_tiles(rec_t, starts, counts, **kw)
    torch.cuda.synchronize()
    raw_p, logt_p, nact_p = composite_tiles_torch(rec_t, starts, counts, **kw)
    torch.cuda.synchronize()
    for name, x in (("raw", raw_k), ("log_t", logt_k)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"K1 {name} has non-finite values")
    chan_rows = [i for i in range(n_val) if i != n_chan]
    err_chan = float((raw_k[..., chan_rows] - raw_p[..., chan_rows]).abs()
                     .max())
    err_depth = float((raw_k[..., n_chan] - raw_p[..., n_chan]).abs().max())
    err_logt = float((logt_k - logt_p).abs().max())
    dn = (nact_k - nact_p).abs().reshape(-1)
    nact_equal = int((dn == 0).sum()) / dn.numel()
    nact_maxdiff = int(dn.max())
    ok = (err_chan <= ATOL_CHAN and err_depth <= ATOL_DEPTH
          and err_logt <= ATOL_LOGT and nact_equal >= NACT_EQUAL_MIN
          and nact_maxdiff <= 1)

    def run_k():
        composite_tiles(rec_t, starts, counts, **kw)

    def run_p():
        composite_tiles_torch(rec_t, starts, counts, **kw)

    ms, _ = cuda_ms(run_k, iters=50, warmup=2)
    plain_ms, _ = cuda_ms(run_p, iters=3)
    cells = table_stats(table, rec_t, starts, counts, nact_k)
    work = dict(cells, **k1_work(cells, rec_t, starts.shape[0], n_val))
    rec = dict(phase="k1_vs_plain", table=table, cv=n_val, extra=extra_key,
               k_slots=k_slots, n_pairs=int(counts.sum()),
               ne_pad=rec_t.shape[1], n_dropped_rect=0, err_chan=err_chan,
               err_depth=err_depth, err_logt=err_logt,
               n_active_equal=nact_equal, n_active_maxdiff=nact_maxdiff,
               tol=dict(chan=ATOL_CHAN, depth=ATOL_DEPTH, log_t=ATOL_LOGT,
                        n_active_equal=NACT_EQUAL_MIN),
               ms=ms, plain_ms=plain_ms,
               ns_per_walked_cell=ms * 1e6 / cells["walked_cells"],
               card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def phase_k2(table, extra_key, device, smi):
    """K2 against its plain version at full width on `table`, on K1's real
    outputs and a seeded cotangent; a second launch must give bitwise the
    same d_out."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import (
        composite_tiles_bwd, composite_tiles_bwd_torch)
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import cuda_ms

    make, k_slots = TABLES[table]
    rec_t, starts, counts, _, kw = bench_records(make(), extra_key, device,
                                                 k=k_slots)
    n_val = rec_t.shape[0] - 8
    raw, log_t, n_active = composite_tiles(rec_t, starts, counts, **kw)
    d_raw = torch.as_tensor(np.random.RandomState(3).normal(
        size=tuple(raw.shape)).astype(np.float32), device=device)
    args = (rec_t, starts, counts, n_active.reshape(-1), log_t, d_raw)
    out_k = composite_tiles_bwd(*args, **kw)
    out_k2 = composite_tiles_bwd(*args, **kw)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(out_k, out_k2))
    del out_k2
    out_p = composite_tiles_bwd_torch(*args, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError("K2 output has non-finite values")
    n_live = int(counts.sum())           # segments are back to back from 0
    rows = list(range(6)) + list(range(8, 8 + n_val))
    k, p = out_k[rows, :n_live], out_p[rows, :n_live]
    scale = p.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    excess = ((k - p).abs() - RTOL_BWD * p.abs() - ROW_ATOL_BWD * scale)
    err_abs = float((k - p).abs().max())
    err_row = float(((k - p).abs() / scale).max())
    outside = max(float(out_k[6:8].abs().max()),
                  float(out_k[:, n_live:].abs().max()))
    ok = float(excess.max()) <= 0.0 and outside == 0.0 and repeat_equal

    def run_k():
        composite_tiles_bwd(*args, **kw)

    def run_p():
        composite_tiles_bwd_torch(*args, **kw)

    ms, _ = cuda_ms(run_k, iters=20, warmup=2)
    plain_ms, _ = cuda_ms(run_p, iters=2)
    cells = table_stats(table, rec_t, starts, counts, n_active)
    work = dict(cells, **k2_work(cells, rec_t, starts.shape[0], n_val))
    rec = dict(phase="k2_vs_plain", table=table, cv=n_val, extra=extra_key,
               k_slots=k_slots, n_pairs=n_live, ne_pad=rec_t.shape[1],
               err_abs=err_abs, err_rel_to_row_max=err_row,
               outside_segments_max=outside, repeat_bitwise_equal=repeat_equal,
               grad_row_max=[float(x) for x in scale.reshape(-1)[:6]],
               tol=dict(rtol=RTOL_BWD, row_atol=ROW_ATOL_BWD),
               ms=ms, plain_ms=plain_ms,
               ns_per_walked_cell=ms * 1e6 / cells["walked_cells"],
               card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version or with "
                             f"itself: {rec}")
    return rec


def phase_grad_golden(device):
    """The kernel path's render gradients against the frozen fixtures."""
    import glob

    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import \
        composite_tiles_bwd
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    paths = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures",
                                          "golden_render_*.npz")))
    if len(paths) != 3:
        raise AssertionError(f"expected 3 golden fixtures, found {paths}")
    errs = {}
    for path in paths:
        fx = dict(np.load(path))
        w, h, f = int(fx["w"]), int(fx["h"]), float(fx["f"])
        cam = make_camera(w, h, [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                          fx["w2c"], device=device)
        cfg = RasterConfig(tile_h=16, tile_w=16, chunk=128,
                           max_tiles_per_gaussian=int(fx["k_cap"]))
        ts = [torch.tensor(fx[k], device=device, requires_grad=True)
              for k in ("means", "colors", "opac", "scales", "quats")]
        kw = {}
        if "extra_in" in fx:
            kw["extra_channels"] = torch.as_tensor(fx["extra_in"],
                                                   device=device)
        before = composite_tiles_bwd.launches
        out = render(cam, *ts, method="cuda", config=cfg, device=device,
                     **kw)
        loss = (torch.sum(out.rgb * torch.as_tensor(fx["ct_rgb"],
                                                    device=device))
                + torch.sum(out.depth * torch.as_tensor(fx["ct_depth"],
                                                        device=device)))
        if out.extra is not None:
            loss = loss + torch.sum(out.extra * 0.1)
        grads = torch.autograd.grad(loss, ts)
        torch.cuda.synchronize()
        if composite_tiles_bwd.launches != before + 1:
            raise AssertionError("the gradient did not go through K2")
        name = os.path.basename(path)[len("golden_render_"):-4]
        errs[name] = {}
        for key, g in zip(("d_means", "d_colors", "d_opac", "d_scales",
                           "d_quats"), grads):
            ref = fx[key]
            g = g.cpu().numpy()
            errs[name][key] = float(np.max(np.abs(g - ref)
                                           / np.maximum(np.abs(ref), 1.0)))
        errs[name]["n_dropped_rect"] = int(out.n_dropped_rect)
    rec = dict(phase="grad_vs_golden", rel_err=errs, tol=REL_GOLDEN)
    emit(rec)
    bad = [(n, k) for n, e in errs.items() for k, v in e.items()
           if (k == "n_dropped_rect" and v) or (k != "n_dropped_rect"
                                                 and v > REL_GOLDEN)]
    if bad:
        raise AssertionError(f"kernel-path gradients off the fixtures: {bad}")


def phase_oracle(device):
    """Small scene: the kernel path against the O(N*H*W) oracle."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    rng = np.random.RandomState(1)
    n, w, h, f = 400, 128, 96, 80.0
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, (n,)).astype(np.float32)
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = make_camera(w, h, [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], w2c,
                      device=device)
    args = [torch.as_tensor(a) for a in (means, colors, opac, scales, quats)]
    with torch.no_grad():
        out = render(cam, *args, method="cuda", device=device)
        ref = render(cam, *args, method="reference", device=device)
    err = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
           for k in ("rgb", "alpha", "depth")}
    rec = dict(phase="oracle", n=n, w=w, h=h, err=err,
               n_dropped_rect=int(out.n_dropped_rect),
               tol=dict(rgb=2e-4, alpha=2e-4, depth=2e-3))
    emit(rec)
    if not (int(out.n_dropped_rect) == 0 and err["rgb"] <= 2e-4
            and err["alpha"] <= 2e-4 and err["depth"] <= 2e-3):
        raise AssertionError(f"kernel path disagrees with the oracle: {rec}")


def phase_main_path(scene, device, smi):
    """`cli visualize` on a 3-timestep 200k checkpoint, 4 frames."""
    import torch
    from dynamic3dgaussians_tpu_torch import cli
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import \
        composite_tiles_bwd
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import sol_probe
    from dynamic3dgaussians_tpu_torch.viz.export import (load_params,
                                                         save_params)
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame)
    rng = np.random.RandomState(2)
    o = scene["opac"]
    t0 = {"means3D": scene["means"], "rgb_colors": scene["colors"],
          "seg_colors": scene["seg_colors"],
          "unnorm_rotations": scene["quats"],
          "logit_opacities": np.log(o / (1.0 - o))[:, None],
          "log_scales": np.log(scene["scales"]),
          "cam_m": np.zeros((5, 3), np.float32),
          "cam_c": np.zeros((5, 3), np.float32)}
    steps = [t0]
    for _ in range(2):   # small per-timestep drift of the means
        prev = steps[-1]
        steps.append({"means3D": (prev["means3D"] + rng.normal(
            0, 0.01, prev["means3D"].shape)).astype(np.float32),
            "rgb_colors": t0["rgb_colors"],
            "unnorm_rotations": t0["unnorm_rotations"]})
    n_frames, radius = 4, 6.0
    with tempfile.TemporaryDirectory() as tmp:
        path = save_params(steps, tmp)
        gif = os.path.join(tmp, "orbit.gif")
        flags = ["--frames", str(n_frames), "--width", str(W),
                 "--height", str(H), "--focal", str(F),
                 "--radius", str(radius)]
        composite_tiles.launches = 0
        composite_tiles_bwd.launches = 0
        sol_probe.launches = 0
        t_start = time.perf_counter()
        cli.main(["visualize", "--params", path, "--out", gif] + flags)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t_start
        launches = {"raster_fwd": composite_tiles.launches,
                    "raster_bwd": composite_tiles_bwd.launches,
                    "sol_probe": sol_probe.launches}
        gif_bytes = os.path.getsize(gif)
        stacked = load_params(path)
    if launches["raster_fwd"] != n_frames or launches["raster_bwd"] or \
            launches["sol_probe"]:
        raise AssertionError(f"cli visualize launched K1 / K2 / K3 "
                             f"{launches} times for {n_frames} frames")

    center = stacked["means3D"].reshape(-1, 3).mean(0)
    cams = orbit_cameras(center, radius, -1.0, n_frames, W, H, F,
                         device=device)
    frame_ms, drops = [], []
    outs = []
    for i, cam in enumerate(cams):
        pt = params_at_t(stacked, i % stacked["means3D"].shape[0])
        render_frame(pt, cam, device=device)            # warm
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        out = render_frame(pt, cam, device=device)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t_s) * 1e3)
        drops.append(int(out.n_dropped_rect))
        outs.append(out)
    for i, out in enumerate(outs):
        if tuple(out.rgb.shape) != (H, W, 3) or not bool(
                torch.isfinite(out.rgb).all()):
            raise AssertionError(f"frame {i}: bad rgb {tuple(out.rgb.shape)}")
        if float(out.alpha.mean()) < 0.05 or float(out.rgb.std()) < 1e-3:
            raise AssertionError(f"frame {i} is blank")
    if any(drops):
        raise AssertionError(f"n_dropped_rect per frame {drops}")

    ref = render_frame(params_at_t(stacked, 0), cams[0], method="torch",
                       device=device)
    out = outs[0]
    err = dict(
        rgb=float((out.rgb - ref.rgb).abs().max()),
        alpha=float((out.alpha - ref.alpha).abs().max()),
        extra=float((out.extra - ref.extra).abs().max()),
        depth=float((out.depth - ref.depth).abs().max()))
    rec = dict(phase="main_path", cmd="cli visualize " + " ".join(flags),
               n_gaussians=int(stacked["means3D"].shape[1]),
               timesteps=int(stacked["means3D"].shape[0]),
               frames=n_frames, launches=launches, cli_s=cli_s,
               gif_bytes=gif_bytes, frame_ms=frame_ms,
               frame_ms_mean=float(np.mean(frame_ms)),
               n_dropped_rect=drops, err_vs_torch_frame0=err,
               alpha_mean=[float(o.alpha.mean()) for o in outs], card=smi)
    emit(rec)
    if not (err["rgb"] <= ATOL_CHAN and err["alpha"] <= ATOL_CHAN
            and err["extra"] <= ATOL_CHAN and err["depth"] <= ATOL_DEPTH):
        raise AssertionError(f"frame 0 kernel vs torch path: {err}")
    return rec


TRAIN_STEPS = 30
TRAIN_T = 3
TRAIN_STEPS_LATER = 10
REPORT_EVERY = 5
TRAIN_CAMS = 4
# the cameras orbit the bench cube [-2, 2]^3 at the bench view's distance
# (z = 6, as `main_path` orbits at radius 6)
TRAIN_RADIUS = 6.0
# emission slots of the PSNR renders over every view, 4x the trainer's
# largest K, so that no gaussian's tile rect is cut at orbit radius 6
EVAL_K = 256
PHYSICS = ("rigid", "rot", "iso", "floor", "bg", "soft_col_cons")


def views_psnr(params, alive, frames, device):
    """PSNR of every camera of the layout, rendered as the train step
    renders them (the kernel path on the card, the camera's colour
    correction), and the tile rects these renders cut."""
    import torch
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    from dynamic3dgaussians_tpu_torch.train import losses as L
    out_psnr, cut = [], 0
    with torch.no_grad():
        if alive is not None:
            # dead capacity rows would count as cut rects (ROADMAP.md §3)
            params = G.rows_of(params, lambda v: v[alive])
        act = G.activated(params)
        for fr in frames:
            out = render(fr["camera"], act["means3d"], act["colors"],
                         act["opacity"], act["scales"], act["rotations"],
                         config=RasterConfig(max_tiles_per_gaussian=EVAL_K),
                         device=device)
            cut += int(out.n_dropped_rect)
            c = int(fr["cam_id"])
            im = L.apply_cam_correction(out.rgb, params["cam_m"][c],
                                        params["cam_c"][c])
            out_psnr.append(float(L.psnr(torch.clamp(im, 0, 1), fr["im"])))
    return out_psnr, cut


def train_bench(scene, device, tmp, radius=TRAIN_RADIUS, method=None):
    """Write the bench scene as a 3-timestep, 4-camera 640x360
    reference layout on an orbit of `radius` (the foreground, the rows of
    seg 1, moves rigidly over the timesteps) and run `cli train
    --time_steps` on it: 30 steps at t = 0 with densify passes at i = 10
    and 20, 10 steps at each later t, reports every 5, `raster.method` =
    `method` when given. The kernels' launch counts are set to 0 just
    before the command and read just after. Returns what the run logged,
    with the PSNR of every view before and after each timestep: before t =
    0 from the initial state, before t > 0 from the output of t - 1 at t's
    views."""
    import torch
    from dynamic3dgaussians_tpu_torch import cli
    from dynamic3dgaussians_tpu_torch.convert import params_from_jax
    from dynamic3dgaussians_tpu_torch.data import dataset as D
    from dynamic3dgaussians_tpu_torch.data.synthetic import \
        write_reference_layout
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import \
        composite_tiles_bwd
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import sol_probe
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import params_at_t

    seg = scene["seg_colors"][:, 0]
    fg_first = np.argsort(-seg, kind="stable")    # the rows that move
    gt = dict(means=scene["means"], colors=scene["colors"],
              opac=scene["opac"], scales=scene["scales"],
              quats=scene["quats"], seg=seg)
    gt = {k: v[fg_first] for k, v in gt.items()}
    gt["n_fg"] = int(seg.sum())
    over = {"densify_start": 10, "densify_every": 10,
            "report_every": REPORT_EVERY}
    if method:
        over["raster"] = {"method": method}
    seq = f"bench_r{radius:g}_{method or 'default'}"
    t0 = time.perf_counter()
    write_reference_layout(tmp, seq, num_t=TRAIN_T, num_cams=TRAIN_CAMS,
                           w=W, h=H, f=F, scene=gt, radius=radius,
                           device=device)
    layout_s = time.perf_counter() - t0
    cfg_path = os.path.join(tmp, f"{seq}.json")
    with open(cfg_path, "w") as fh:
        json.dump(over, fh)
    # the default --timesteps: TRAIN_T
    flags = ["--iters_first", str(TRAIN_STEPS), "--iters_per_t",
             str(TRAIN_STEPS_LATER), "--time_steps"]
    argv = (["train", "--data_root", tmp, "--seq", seq, "--exp", "smoke",
             "--output", os.path.join(tmp, "out"), "--device", str(device),
             "--config_json", cfg_path] + flags)
    composite_tiles.launches = 0
    composite_tiles_bwd.launches = 0
    sol_probe.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"raster_fwd": composite_tiles.launches,
                "raster_bwd": composite_tiles_bwd.launches,
                "sol_probe": sol_probe.launches}
    run = os.path.join(tmp, "out", "smoke", seq)
    path = os.path.join(run, "params.npz")
    if not os.path.exists(path):
        raise AssertionError("cli train wrote no params.npz")
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(x) for x in fh]

    # the PSNR of every view before and after each timestep
    md = D.load_meta(tmp, seq)
    pt_cld = D.load_init_point_cloud(tmp, seq)
    stacked = load_params(path)
    per_t = []
    for t in range(TRAIN_T):
        frames = D.load_timestep(tmp, seq, md, t, device=device)
        if t == 0:
            p0, v0 = G.init_params(pt_cld, D.scene_w2c_stack(md),
                                   device=device)
            psnr_before, cut_before = views_psnr(p0, v0["alive"], frames,
                                                 device)
        else:
            psnr_before, cut_before = views_psnr(params_from_jax(
                params_at_t(stacked, t - 1), device), None, frames, device)
        psnr_after, cut_after = views_psnr(params_from_jax(
            params_at_t(stacked, t), device), None, frames, device)
        pre = f"t{t}/"
        step_ms = [(r["step"], int(r[pre + "time/k"]),
                    r[pre + "time/step_ms"])
                   for r in rows if pre + "time/step_ms" in r]
        by_k = {}
        for _, k, ms in step_ms:
            by_k.setdefault(k, []).append(ms)
        per_t.append(dict(
            t=t, steps=TRAIN_STEPS if t == 0 else TRAIN_STEPS_LATER,
            reports=[dict(i=r["step"], loss=r[pre + "loss"],
                          psnr=r[pre + "psnr"],
                          n_dropped_rect=r[pre + "n_dropped_rect"],
                          **{k: r[f"{pre}loss_{k}"] for k in PHYSICS
                             if f"{pre}loss_{k}" in r})
                     for r in rows if pre + "loss" in r],
            psnr_views_before=psnr_before, psnr_views_after=psnr_after,
            psnr_views_mean_before=float(np.mean(psnr_before)),
            psnr_views_mean_after=float(np.mean(psnr_after)),
            psnr_views_cut_rects=[cut_before, cut_after], step_ms=step_ms,
            step_ms_median_by_k={str(k): float(np.median(v))
                                 for k, v in sorted(by_k.items())},
            steps_by_k={str(k): len(v) for k, v in sorted(by_k.items())},
            final_k=step_ms[-1][1] if step_ms else None))
    return dict(
        cmd="cli train " + " ".join(flags),
        radius=radius, method=method or "auto", config=over,
        n_gaussians=int(pt_cld.shape[0]), cameras=TRAIN_CAMS, w=W, h=H,
        launches=launches,
        densify=[dict(i=r["step"], n_alive=r["t0/densify/n_alive"],
                      n_cloned=r["t0/densify/n_cloned"],
                      n_split=r["t0/densify/n_split"],
                      n_pruned=r["t0/densify/n_pruned"])
                 for r in rows if "t0/densify/n_alive" in r],
        grow_tiles=[dict(t=t, i=r["step"],
                         k=r[f"t{t}/grow_tiles/max_tiles_per_gaussian"])
                    for t in range(TRAIN_T) for r in rows
                    if f"t{t}/grow_tiles/max_tiles_per_gaussian" in r],
        graph=[dict(knn_s=r["t0/graph/knn_s"], rcm_s=r["t0/graph/rcm_s"])
               for r in rows if "t0/graph/knn_s" in r],
        n_out=int(stacked["means3D"].shape[1]),
        out_timesteps=int(stacked["means3D"].shape[0]), cli_s=cli_s,
        layout_s=layout_s, timesteps=per_t)


def phase_train_main_path(scene, device, smi):
    """`cli train` over 3 timesteps of the bench scene (see
    `train_bench`). Its step time per timestep is the median of the steps
    the run took at the K it ended with, from the run's own per-step log;
    the first step of each timestep is not timed."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = train_bench(scene, device, tmp)
    per_t = rec["timesteps"]
    medians = [ts["step_ms_median_by_k"].get(str(ts["final_k"]))
               for ts in per_t]
    rec = dict(phase="train_main_path", step_ms_median=medians,
               step_ms_total=sum(x[2] for ts in per_t for x in ts["step_ms"]),
               card=smi, **rec)
    emit(rec)
    launches, densify = rec["launches"], rec["densify"]
    if rec["out_timesteps"] != TRAIN_T or len(per_t) != TRAIN_T:
        raise AssertionError(f"params.npz holds {rec['out_timesteps']} "
                             f"timesteps, not {TRAIN_T}")
    for ts, median in zip(per_t, medians):
        t = ts["t"]
        # t = 0 reports the loss alone, t > 0 the physics terms as well
        keys = ["loss"] + (list(PHYSICS) if t else [])
        vals = [[r[k] for k in keys] for r in ts["reports"]
                if all(k in r for k in keys)]
        if len(vals) != ts["steps"] // REPORT_EVERY or \
                not np.isfinite(vals).all():
            raise AssertionError(f"t = {t}: {keys} per report: "
                                 f"{ts['reports']}")
        if any(ts["psnr_views_cut_rects"]):
            raise AssertionError(f"t = {t}: the PSNR renders cut tile "
                                 f"rects: {ts['psnr_views_cut_rects']}")
        if not (ts["psnr_views_mean_after"] > ts["psnr_views_mean_before"]):
            raise AssertionError(
                f"t = {t}: PSNR over every view did not rise above "
                f"{'the initial state' if t == 0 else 'the output of t - 1'}"
                f": {ts['psnr_views_before']} -> {ts['psnr_views_after']}")
        if len(ts["step_ms"]) != ts["steps"] - 1 or median is None:
            raise AssertionError(f"t = {t}: step times {ts['step_ms']}")
    total_steps = sum(ts["steps"] for ts in per_t)
    if launches["raster_bwd"] != total_steps:
        raise AssertionError(f"K2 launched {launches['raster_bwd']} times in "
                             f"{total_steps} steps")
    if launches["raster_fwd"] < total_steps or launches["sol_probe"]:
        raise AssertionError(f"cli train launched K1 / K3 {launches} times "
                             f"in {total_steps} steps")
    if len(densify) != 2 or not rec["graph"] or \
            rec["n_out"] != densify[-1]["n_alive"]:
        raise AssertionError(f"densify / graph / output rows: {rec}")
    return rec


def k3_errors(k, p, kind):
    """K3's parts `k` (B, 2) or (2,) against the plain version's `p`: per
    part the largest absolute and relative error and whether every walk is
    within `K3_PART_TOL`; for the scalar (the parts' sum) the same against
    `RTOL_K3`. Returns (errors, the names of the checks that failed)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import PARTS, total
    errs, bad = {}, []
    for i, name in enumerate(PARTS[kind]):
        rtol, atol = K3_PART_TOL[kind][name]
        kp, pp = k[..., i].double(), p[..., i].double()
        diff = (kp - pp).abs()
        excess = diff - (rtol * pp.abs() + atol)
        errs[name] = dict(err_abs=float(diff.max()),
                          err_rel=float((diff / pp.abs().clamp(min=1e-30))
                                        .max()),
                          value=float(kp.reshape(-1)[0]),
                          value_plain=float(pp.reshape(-1)[0]))
        if float(excess.max()) > 0 or not bool(torch.isfinite(kp).all()):
            bad.append(name)
    kt, pt = total(k).double(), total(p).double()
    diff = (kt - pt).abs()
    errs["scalar"] = dict(err_abs=float(diff.max()),
                          err_rel=float((diff / pt.abs()).max()),
                          value=float(kt.reshape(-1)[0]),
                          value_plain=float(pt.reshape(-1)[0]))
    if errs["scalar"]["err_rel"] > RTOL_K3[kind]:
        bad.append("scalar")
    return errs, bad


# blocks per walk of the wide-alpha table at one walk per SM (so that the
# plain version's time stays a few seconds)
WIDE_BLOCKS = 64


def phase_k3(device, smi):
    """K3 against its plain version in every variant on four tables: at the
    bench shape (n_chunks 2143) one walk (the reference's table) and
    card-wide (B walks, 4 per SM, each with its own slice of a table of B x
    35.1 MB, far past the 50 MB L2); and the wide-alpha table, where a live
    cell's alpha spans [1/255, 0.99], at the bench shape's one walk and at
    one walk per SM of `WIDE_BLOCKS` blocks. Each walk's two parts are held
    on their own (`K3_PART_TOL`) and their sum as the reference's scalar
    (`RTOL_K3`). Kernel times from CUDA events, the plain version's from
    one call; bounds as in `phase_k1`, and beside them the SFU floor at the
    card's maximum SM clock."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import (
        KINDS, sol_probe, sol_probe_torch)
    from dynamic3dgaussians_tpu_torch.tools import bench_sol as B

    rec_np, _ = B.probe_inputs(small=False)
    n_chunks = rec_np.shape[1] // B.CHUNK
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = B.max_sm_clock_hz()
    walks = B.WALKS_PER_SM * sms
    tables = {"one_walk": torch.as_tensor(rec_np, device=device),
              "card_wide": B.card_table(walks, n_chunks, device),
              "wide_alpha_one_walk": B.wide_alpha_table(
                  1, n_chunks, device, seed=1)[0],
              "wide_alpha_per_sm": B.wide_alpha_table(
                  sms, WIDE_BLOCKS, device, seed=2)}
    out = dict(phase="k3_vs_plain", n_chunks=n_chunks, walks=walks,
               table_bytes_card_wide=tables["card_wide"].numel() * 4,
               sm_clock_max_mhz=clock / 1e6,
               tol=dict(scalar_rtol=RTOL_K3, parts=K3_PART_TOL), card=smi)
    bad = []
    for kind in KINDS:
        for scope, rec in tables.items():
            k = sol_probe(rec, kind)
            plain_ms, p = B.cuda_ms(lambda: sol_probe_torch(rec, kind),
                                    iters=1, warmup=0)
            errs, failed = k3_errors(k, p, kind)
            n_walks = rec.shape[0] if rec.dim() == 3 else 1
            w = B.work(kind, n_walks, rec.shape[-1] // B.CHUNK, sms, clock)
            ms, _ = B.cuda_ms(lambda: sol_probe(rec, kind),
                              iters=3 if scope == "card_wide" else 5,
                              warmup=0)
            out[f"{kind}/{scope}"] = dict(
                err_abs=float((k - p).abs().max()), errors=errs, ms=ms,
                plain_ms=plain_ms, ns_per_cell=ms * 1e6 / w["cells"],
                GB_s=w["table_bytes"] / ms / 1e6,
                bound_share=w["bound_ms"] / ms, walks=n_walks, **w)
            bad += [(kind, scope, name) for name in failed]
    del tables
    torch.cuda.empty_cache()
    emit(out)
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version: {bad}")
    return out


def phase_probe_main_path(k3, device, smi):
    """The probe's entry point as a user runs it (`python -m
    dynamic3dgaussians_tpu_torch.tools.bench_sol`), the launch counts set
    to 0 just before and read just after. Each variant's one-walk scalar
    and its two parts are held against the plain version's from
    `phase_k3`."""
    import contextlib
    import io

    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import \
        composite_tiles_bwd
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import (KINDS,
                                                                 sol_probe)
    from dynamic3dgaussians_tpu_torch.tools import bench_sol

    buf = io.StringIO()
    composite_tiles.launches = 0
    composite_tiles_bwd.launches = 0
    sol_probe.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_sol.main([])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"raster_fwd": composite_tiles.launches,
                "raster_bwd": composite_tiles_bwd.launches,
                "sol_probe": sol_probe.launches}
    lines = [x for x in buf.getvalue().splitlines()
             if x.startswith("SOL_RESULT ")]
    result = json.loads(lines[-1][len("SOL_RESULT "):]) if lines else {}
    rec = dict(phase="probe_main_path",
               cmd="python -m dynamic3dgaussians_tpu_torch.tools.bench_sol",
               rc=rc, cli_s=cli_s,
               launches=launches, result=result, card=smi)
    emit(rec)
    # per variant: the one-walk value, a warm-up and the timed calls, then
    # the same on the card-wide table
    want = len(KINDS) * 2 * (2 + bench_sol.ITERS)
    if rc != 0 or launches["sol_probe"] != want or launches["raster_fwd"] \
            or launches["raster_bwd"]:
        raise AssertionError(f"the probe returned {rc} and launched "
                             f"{launches}, not K3 {want} times")
    for kind in KINDS:
        line = result.get(kind, {})
        errs = k3[f"{kind}/one_walk"]["errors"]
        ref = errs["scalar"]["value_plain"]
        ok = (np.isfinite(line.get("value", np.nan))
              and line.get("card_wide", {}).get("finite") is True
              and abs(line["value"] - ref) <= RTOL_K3[kind] * abs(ref))
        for name, (rtol, atol) in K3_PART_TOL[kind].items():
            want = errs[name]["value_plain"]
            got = line.get("parts", {}).get(name, np.nan)
            ok = ok and abs(got - want) <= rtol * abs(want) + atol
        if not ok:
            raise AssertionError(f"probe line {kind}: {line}")
    return rec


def floor_rec(k1, k2, k3, train_launches, smi):
    """ns per walked cell of K1 and K2 at the bench view against K3's
    card-wide floor for the same cell pipeline, and each kernel's gap to
    that floor (its time less its walked cells at the floor's rate) times
    its launches in the `cli train` run."""
    rec = dict(phase="floor", card=smi, cv=8)
    for kind in ("compute_only", "stream_compute"):
        rec[f"k3_{kind}_ns_per_cell"] = k3[f"{kind}/card_wide"]["ns_per_cell"]
    fl = rec["k3_stream_compute_ns_per_cell"]
    for name, r, kern in (("k1", k1, "raster_fwd"), ("k2", k2, "raster_bwd")):
        rec[f"{name}_ns_per_walked_cell"] = r["ms"] * 1e6 / r["walked_cells"]
        rec[f"{name}_ns_per_live_cell"] = r["ms"] * 1e6 / r["live_cells"]
        rec[f"{name}_over_floor"] = rec[f"{name}_ns_per_walked_cell"] / fl
        floor_ms = r["walked_cells"] * fl * 1e-6
        rec[f"{name}_floor_ms"] = floor_ms
        rec[f"{name}_gap_ms"] = r["ms"] - floor_ms
        rec[f"{name}_train_launches"] = train_launches[kern]
        rec[f"{name}_train_gap_ms"] = (r["ms"] - floor_ms) * \
            train_launches[kern]
    emit(rec)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # before anything is printed: without the package beside it, the script
    # fails here and prints no result
    sys.path.insert(0, REPO)
    from dynamic3dgaussians_tpu_torch import _build

    from dynamic3dgaussians_tpu_torch.tools.bench_sol import smi_line

    device = torch.device("cuda")
    smi = smi_line()
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    t0 = time.perf_counter()
    lib_path, report = _build.build()
    _build.load_library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=os.path.relpath(lib_path, REPO),
              fresh=bool(report), ptxas=ptxas_summary(report)))

    k1, k2 = {}, {}
    for table in TABLES:
        for extra_key in ("seg_colors", "feats"):
            rec = phase_k1(table, extra_key, device, smi)
            k1[table, rec["cv"]] = rec
    for table in TABLES:
        for extra_key in ("seg_colors", "feats"):
            rec = phase_k2(table, extra_key, device, smi)
            k2[table, rec["cv"]] = rec
    scene = bench_scene()
    k3 = phase_k3(device, smi)
    phase_oracle(device)
    phase_grad_golden(device)
    view_rec = phase_main_path(scene, device, smi)
    train_rec = phase_train_main_path(scene, device, smi)
    probe_rec = phase_probe_main_path(k3, device, smi)
    b1, b2 = k1["bench", 8], k2["bench", 8]
    floor_rec(b1, b2, k3, train_rec["launches"], smi)

    # both render paths pass RGB + 3 seg channels: CV = 8
    paths = (("visualize", view_rec), ("train", train_rec),
             ("probe", probe_rec))
    by_path = {name: {p: r["launches"][name] for p, r in paths}
               for name in ("raster_fwd", "raster_bwd", "sol_probe")}
    wide = k3["stream_compute/card_wide"]
    emit({"kernels": [
        dict(name="raster_fwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_fwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py:419",
             launches=train_rec["launches"]["raster_fwd"],
             launches_by_path=by_path["raster_fwd"],
             max_abs_err=max(b1["err_chan"], b1["err_depth"]),
             ms=b1["ms"], plain_ms=b1["plain_ms"],
             bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
             library_ms=None),
        dict(name="raster_bwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_bwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_bwd.py:271",
             launches=train_rec["launches"]["raster_bwd"],
             launches_by_path=by_path["raster_bwd"],
             max_abs_err=b2["err_abs"], ms=b2["ms"],
             plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=None),
        # the card-wide stream_compute call: every block streamed and run
        # through the cell pipeline, B walks
        dict(name="sol_probe", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/sol_probe.cu",
             replaces="tools/bench_vpu_sol.py:129",
             launches=probe_rec["launches"]["sol_probe"],
             launches_by_path=by_path["sol_probe"],
             max_abs_err=wide["err_abs"],
             max_rel_err={n: e["err_rel"] for n, e in wide["errors"].items()},
             ms=wide["ms"], plain_ms=wide["plain_ms"],
             bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
             library_ms=None)]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
