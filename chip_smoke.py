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
fixtures, drives the main paths at full width -- `cli visualize` on
a 200k-gaussian, 3-timestep checkpoint at 640x360; `cli train
--checkpoint_every 15` over 3 timesteps of a 200k scene seen by 4 cameras
at 640x360 (30 steps at t = 0, 10 at each later one, the images streamed
by the native FileLoader), timing its steps and the PSNR of every view
before and after each timestep; `cli train --resume` from its final
checkpoint (bitwise its last timestep) and from its step 45 (mid t = 2);
`cli evaluate` and `cli evaluate-suite` on its params.npz (K1 once per
view, each view's pixels, PSNR and SSIM held against the plain path); pixel
tracking of 256 foreground pixels (one K1 launch, against the plain path
and the layout's known motion); the serving path -- cached-order playback
at the bench view (a key frame, then cached frames at small camera steps:
K1 once per frame, none in the key frame's sort; a fresh cache against the
exact render, a stale one by PSNR, the plain K1 on its table; key, cached
and exact frame times) and `cli visualize --resort-every 8`, and the
viewer of `cli view` over the trained params.npz (HTTP page, meta and
frames in every mode, the playback caches it builds, the network GUI
reached by its client and by the browser bridge); the Feature-3DGS
trainer on the bench cameras written as a COLMAP model of the 200k
points, SH degree 3 and 32 feature channels (K1 and K2 once per
iteration at CV 40; the trained model's record table and render through
the kernels against the plain path; PLY save and reload, capture and
restore); the ego + static trainer over 3 timesteps (the ego render and
the 4 static ones each step); the motion-basis trainer (`motion_main_path`:
`train_motion` from the k-means and from the Procrustes init and
`train_motion_windowed` on a 6-frame layout of the 4 bench cameras, a
fused init cloud of 200,000 points and 10 bases, K1 and K2 once per
step; background rows pinned, the views' PSNR rising, each basis the
Procrustes run starts from replaying the true motion, K1 and K2 against
their plain versions on a motion step's record table, a step's loss and
gradients and `render_flow` through the kernels against the plain path,
2D tracks lifted through K1 depth renders); `parallel/`
(`parallel_main_path`: camera data-parallel training in both reduce modes
on the bench training's 4 cameras at 800,768 rows, the tile-stripe render
of the bench view padded to 640x384 and the depth-slab render, forward
and gradients, in four gloo ranks sharing the card and in one NCCL rank,
each rank held against the single-process path and launching K1 and K2);
the plain "tiled"
render method against the kernel path (image and gradients) with its drop
counters at the bench view; the approximate kNN at the scene's ~100k
foreground points; the probe's entry point `tools/bench_sol.py`; and
the multi-step training window (`window_main_path`: 10 steps of the bench
training as one `make_train_scan` window, a CUDA graph of the step
replayed, at t = 0 and at t > 0 with K = 64, bitwise the eager steps; and
`dynamic_run --steps_per_call 25` through `train()`'s window loop, bitwise
its unwindowed run) -- and checks that each went through its kernels: K1
and K2 count their runs on the device too, so that the runs replayed from
a CUDA graph, which the host does not launch, are counted. Prints one
JSON object per phase; the last line is `{"ok": true, "device": {...}}`.
Any failure propagates and exits non-zero, as does a machine without
CUDA. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
# a render's gradients through the kernels against the plain path, both on
# the card, |kernel - plain| <= rel * max(|plain|, 1): the CPU one-step
# tests' limit (tests/test_torch_feature_trainer.py); sums in other orders
REL_RENDER_GRAD = 1e-3
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


def launch_counts():
    """The kernels' wrappers K1, K2, K3; each adds one to its `launches`
    where it launches its kernel, and nowhere else. K1 and K2 also count
    each run of their kernel on the device, CUDA graph replays included
    (`ops/cuda/launches.py`, `read_runs`)."""
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import \
        composite_tiles_bwd
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import sol_probe
    return (composite_tiles, composite_tiles_bwd, sol_probe)


def zero_launches():
    from dynamic3dgaussians_tpu_torch.ops.cuda import launches
    fwd, bwd, sol = launch_counts()
    launches.zero(fwd)
    launches.zero(bwd)
    sol.launches = 0


def read_launches():
    fwd, bwd, sol = launch_counts()
    return {"raster_fwd": fwd.launches, "raster_bwd": bwd.launches,
            "sol_probe": sol.launches}


def read_runs():
    """K1's and K2's runs counted by the kernels on the device since
    `zero_launches` (a device sync)."""
    from dynamic3dgaussians_tpu_torch.ops.cuda import launches
    fwd, bwd, _ = launch_counts()
    return {"raster_fwd": launches.runs(fwd),
            "raster_bwd": launches.runs(bwd)}


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


def bench_camera(device, dx=0.0):
    """The bench view (640x360, f = 500, z = 6), shifted by dx along x."""
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    w2c = np.eye(4)
    w2c[2, 3] = 6.0
    w2c[0, 3] = dx
    return make_camera(W, H, [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], w2c,
                       device=device)


def bench_records(scene, extra_key, device, k=8):
    """The bench view's record table (640x360, f = 500, z = 6) at
    CV = 3 + extra + 2, rounded up to 8, with K = `k` emission slots."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import \
        sorted_records

    cam = bench_camera(device)
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


def k1_against_plain(rec_t, starts, counts, n_chan, kw):
    """K1 against its plain version on one record table: the channel and
    alpha rows, the depth row (`n_chan`), log2 T and the chunks walked per
    tile, under the K1 tolerances. Returns (errors with "ok" and the
    tolerances, the kernel's chunks walked)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        composite_tiles, composite_tiles_torch)
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
    return dict(err_chan=err_chan, err_depth=err_depth, err_logt=err_logt,
                n_active_equal=nact_equal, n_active_maxdiff=nact_maxdiff,
                tol=dict(chan=ATOL_CHAN, depth=ATOL_DEPTH, log_t=ATOL_LOGT,
                         n_active_equal=NACT_EQUAL_MIN), ok=ok), nact_k


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
    errs, nact_k = k1_against_plain(rec_t, starts, counts, n_chan, kw)
    ok = errs.pop("ok")

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
               ne_pad=rec_t.shape[1], n_dropped_rect=0, **errs,
               ms=ms, plain_ms=plain_ms,
               ns_per_walked_cell=ms * 1e6 / cells["walked_cells"],
               card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def k2_against_plain(rec_t, starts, counts, kw, device):
    """K2 against its plain version on one record table, on K1's real
    outputs and a seeded cotangent, under the row rule; a second launch
    must give bitwise the same table. Returns (errors with "ok" and the
    tolerances, K2's launch arguments)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import (
        composite_tiles_bwd, composite_tiles_bwd_torch)
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles
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
    outside = max(float(out_k[6:8].abs().max()),
                  float(out_k[:, n_live:].abs().max()))
    return dict(err_abs=float((k - p).abs().max()),
                err_rel_to_row_max=float(((k - p).abs() / scale).max()),
                outside_segments_max=outside,
                repeat_bitwise_equal=repeat_equal,
                grad_row_max=[float(x) for x in scale.reshape(-1)[:6]],
                tol=dict(rtol=RTOL_BWD, row_atol=ROW_ATOL_BWD),
                ok=(float(excess.max()) <= 0.0 and outside == 0.0
                    and repeat_equal)), args


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
    errs, args = k2_against_plain(rec_t, starts, counts, kw, device)
    ok = errs.pop("ok")
    n_active, n_live = args[3], int(counts.sum())

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
               **errs, ms=ms, plain_ms=plain_ms,
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


MAIN_FRAMES, MAIN_RADIUS = 4, 6.0
MAIN_FLAGS = ["--frames", str(MAIN_FRAMES), "--width", str(W), "--height",
              str(H), "--focal", str(F), "--radius", str(MAIN_RADIUS)]


def main_checkpoint(scene, out_dir):
    """The bench scene as a 3-timestep params.npz under `out_dir` (small
    per-timestep drift of the means); returns its path."""
    from dynamic3dgaussians_tpu_torch.viz.export import save_params
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
    for _ in range(2):
        prev = steps[-1]
        steps.append({"means3D": (prev["means3D"] + rng.normal(
            0, 0.01, prev["means3D"].shape)).astype(np.float32),
            "rgb_colors": t0["rgb_colors"],
            "unnorm_rotations": t0["unnorm_rotations"]})
    return save_params(steps, out_dir)


def run_visualize(path, gif, extra_flags=()):
    """`cli visualize` of `path` into `gif` with the launch counts set to 0
    just before and read just after: (seconds, launches, gif bytes)."""
    import torch
    from dynamic3dgaussians_tpu_torch import cli
    zero_launches()
    t_start = time.perf_counter()
    cli.main(["visualize", "--params", path, "--out", gif] + MAIN_FLAGS
             + list(extra_flags))
    torch.cuda.synchronize()
    return (time.perf_counter() - t_start, read_launches(),
            os.path.getsize(gif))


def phase_main_path(scene, device, smi):
    """`cli visualize` on a 3-timestep 200k checkpoint, 4 frames."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame)
    n_frames, radius, flags = MAIN_FRAMES, MAIN_RADIUS, MAIN_FLAGS
    with tempfile.TemporaryDirectory() as tmp:
        path = main_checkpoint(scene, tmp)
        cli_s, launches, gif_bytes = run_visualize(
            path, os.path.join(tmp, "orbit.gif"))
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


def bench_gt(scene):
    """The bench scene as the synthetic layouts' ground truth: its
    foreground (the rows of seg 1, which move over the timesteps) first."""
    seg = scene["seg_colors"][:, 0]
    fg_first = np.argsort(-seg, kind="stable")
    gt = dict(means=scene["means"], colors=scene["colors"],
              opac=scene["opac"], scales=scene["scales"],
              quats=scene["quats"], seg=seg)
    gt = {k: v[fg_first] for k, v in gt.items()}
    gt["n_fg"] = int(seg.sum())
    return gt


def train_bench(scene, device, tmp, radius=TRAIN_RADIUS, method=None,
                checkpoint_every=0):
    """Write the bench scene as a 3-timestep, 4-camera 640x360
    reference layout on an orbit of `radius` (the foreground, the rows of
    seg 1, moves rigidly over the timesteps) and run `cli train
    --time_steps` on it: 30 steps at t = 0 with densify passes at i = 10
    and 20, 10 steps at each later t, reports every 5, `raster.method` =
    `method` when given, a checkpoint every `checkpoint_every` global
    steps when given (those steps are left out of the step-time medians
    and listed as `save_steps`). The kernels' launch
    counts are set to 0 just
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
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import params_at_t

    gt = bench_gt(scene)
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
    if checkpoint_every:
        flags += ["--checkpoint_every", str(checkpoint_every)]
    argv = (["train", "--data_root", tmp, "--seq", seq, "--exp", "smoke",
             "--output", os.path.join(tmp, "out"), "--device", str(device),
             "--config_json", cfg_path] + flags)
    zero_launches()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
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
        # the global step count after step i of timestep t
        first = 0 if t == 0 else TRAIN_STEPS + (t - 1) * TRAIN_STEPS_LATER
        save_steps = [i for i, _, _ in step_ms if checkpoint_every and
                      (first + i + 1) % checkpoint_every == 0]
        by_k = {}
        for i, k, ms in step_ms:
            if i not in save_steps:
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
            save_steps=save_steps,
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
        layout_s=layout_s, timesteps=per_t, data_root=tmp, seq=seq,
        run_dir=run, argv=argv)


def phase_train_main_path(scene, device, smi, tmp):
    """`cli train --checkpoint_every 15` over 3 timesteps of the bench
    scene (see `train_bench`) in `tmp`, whose layout, outputs and
    checkpoints the later phases read. Its step time per timestep is the
    median of the steps the run took at the K it ended with, from the
    run's own per-step log; the first step of each timestep is not timed,
    and the three steps that end in a checkpoint save are left out
    (`ckpt_main_path` reports the saves' seconds)."""
    with checkpoint_calls() as calls:
        rec = train_bench(scene, device, tmp, checkpoint_every=CKPT_EVERY)
    rec["checkpoint_calls"] = calls
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


# Checkpoints: `train_main_path` saves every 15 global steps of its
# 30 + 10 + 10, at 15, 30 and 45, and at the end at 50 + 1.
CKPT_EVERY = 15
CKPT_SAVED = [15, 30, 45, 51]
CKPT_MID = 45                       # t = 2, i = 4
# evaluation: the kernel path's per-view metrics against the plain path's
EVAL_PSNR_TOL_DB = 0.01
EVAL_SSIM_TOL = 1e-4
# tracking: 256 foreground pixels of camera 0, kernel against plain path
TRACK_QUERIES = 256
TRACK_TOL_PX = 1e-3
PCK_RATIO = 0.05
KNN_K = 20
# the approximate 20-NN's recall at the bench scene's foreground: 0.724 on
# the card; a mis-sized candidate window or a dropped grid falls below
KNN_RECALL_MIN = 0.65


@contextlib.contextmanager
def checkpoint_calls():
    """Records each CheckpointManager save and load while active: (what,
    step, seconds), the device idle at the start of each call, so that a
    save's seconds are its own and not the pending step's."""
    import torch
    from dynamic3dgaussians_tpu_torch.train.checkpoint import \
        CheckpointManager as M
    calls = []
    save, load = M.save, M.load

    def timed_save(mgr, step, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(mgr, step, *a, **kw)
        calls.append(("save", int(step), time.perf_counter() - t0))
        return out

    def timed_load(mgr, step=None, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(mgr, step, device)
        torch.cuda.synchronize()
        calls.append(("load", None if out is None else out[0],
                      time.perf_counter() - t0))
        return out

    M.save, M.load = timed_save, timed_load
    try:
        yield calls
    finally:
        M.save, M.load = save, load


def copy_run(src_root, dst_root, keep_steps):
    """A copy of the output tree `src_root` whose ckpt directory holds only
    `keep_steps`; the checkpoint files are hard links (the manager replaces
    files, never writes into one), everything else is copied."""
    import shutil

    def ignore(d, names):
        return [n for n in names if n.endswith(".pt")
                and n not in {f"step_{s}.pt" for s in keep_steps}]

    def copy(s, d):
        return os.link(s, d) if s.endswith(".pt") else shutil.copy2(s, d)
    shutil.copytree(src_root, dst_root, ignore=ignore, copy_function=copy)


def resume_run(train_rec, out_root, device, load_final=False):
    """`cli train --resume` of `train_main_path`'s command into `out_root`
    (a copy of its output tree): its launches and seconds, its run dir,
    its checkpoint calls, the metrics rows it appended and, with
    `load_final`, its final checkpoint (step, params, opt, vars,
    cursor)."""
    import torch
    from dynamic3dgaussians_tpu_torch import cli
    from dynamic3dgaussians_tpu_torch.train.checkpoint import \
        CheckpointManager
    argv = list(train_rec["argv"])
    argv[argv.index("--output") + 1] = out_root
    run = os.path.join(out_root, "smoke", train_rec["seq"])
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        n_rows = len(fh.readlines())
    with checkpoint_calls() as calls:
        zero_launches()
        t0 = time.perf_counter()
        cli.main(argv + ["--resume"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(x) for x in fh.readlines()[n_rows:]]
    final = (CheckpointManager(os.path.join(run, "ckpt")).load(
        device=device) if load_final else None)
    return dict(launches=launches, seconds=seconds, run=run, calls=calls,
                final=final, rows=rows)


def phase_ckpt_main_path(train_rec, device, smi):
    """Checkpoints and resume on `train_main_path`'s run: the steps it
    saved (with the native FileLoader streaming the layout's images), the
    seconds of each save and load and the bytes of one checkpoint at the
    800,768-row capacity; a resume from the final checkpoint (no step runs:
    its params.npz is the uninterrupted run's last timestep, bitwise); and
    a resume from a copy holding only step 45 (t = 2, i = 4), which must
    finish with finite losses and an all-view PSNR after t = 2 at least
    the uninterrupted run's before t = 2."""
    import torch
    from dynamic3dgaussians_tpu_torch import native
    from dynamic3dgaussians_tpu_torch.data import dataset as D
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    if not native.available():
        raise AssertionError("the native library did not build: cli train "
                             "read the layout without the FileLoader")
    run = train_rec["run_dir"]
    out_root = os.path.dirname(os.path.dirname(run))
    calls = train_rec["checkpoint_calls"]
    saved = [s for what, s, _ in calls if what == "save"]
    save_s = [x for what, _, x in calls if what == "save"]
    ckpt_dir = os.path.join(run, "ckpt")
    on_disk = sorted(int(n[5:-3]) for n in os.listdir(ckpt_dir)
                     if n.startswith("step_") and n.endswith(".pt"))
    ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir,
                                              f"step_{CKPT_MID}.pt"))
    full = load_params(os.path.join(run, "params.npz"))

    # resume from the final checkpoint: no step runs
    copy_run(out_root, out_root + "_final", [CKPT_SAVED[-1]])
    fin = resume_run(train_rec, out_root + "_final", device)
    res = load_params(os.path.join(fin["run"], "params.npz"))
    shared = sorted(set(res) & set(full))
    bitwise = {k: bool(res[k].shape[0] == 1
                       and np.array_equal(res[k][0], full[k][-1]))
               for k in shared}

    # resume from step 45, mid t = 2
    copy_run(out_root, out_root + "_mid", [CKPT_MID])
    mid = resume_run(train_rec, out_root + "_mid", device, load_final=True)
    step, params, _, variables, cursor = mid["final"]
    md = D.load_meta(train_rec["data_root"], train_rec["seq"])
    frames = D.load_timestep(train_rec["data_root"], train_rec["seq"], md,
                             TRAIN_T - 1, device=device)
    psnr_mid, cut = views_psnr(params, variables["alive"], frames, device)
    before = train_rec["timesteps"][TRAIN_T - 1]
    reports = [dict(i=r["step"], **{k: r[f"t{TRAIN_T - 1}/{k}"]
                                    for k in ["loss"] + [f"loss_{p}"
                                                         for p in PHYSICS]})
               for r in mid["rows"] if f"t{TRAIN_T - 1}/loss" in r]
    rows = int(variables["alive"].shape[0])
    del params, variables, mid["final"]
    torch.cuda.empty_cache()
    rec = dict(
        phase="ckpt_main_path", native_loader=native.available(),
        checkpoint_every=CKPT_EVERY, saved_steps=saved,
        steps_on_disk=on_disk, save_s=save_s,
        load_s=[x for what, _, x in fin["calls"] + mid["calls"]
                if what == "load"],
        checkpoint_bytes=ckpt_bytes, rows=rows,
        resume_final=dict(seconds=fin["seconds"], launches=fin["launches"],
                          restored=[s for w, s, _ in fin["calls"]
                                    if w == "load"],
                          timesteps=int(res["means3D"].shape[0]),
                          bitwise_equal=bitwise),
        resume_mid=dict(seconds=mid["seconds"], launches=mid["launches"],
                        restored_step=CKPT_MID, final_step=step,
                        cursor=cursor, reports=reports,
                        psnr_views_after=psnr_mid,
                        psnr_views_mean_after=float(np.mean(psnr_mid)),
                        psnr_views_cut_rects=cut,
                        uninterrupted_psnr_views_mean_before=before[
                            "psnr_views_mean_before"],
                        uninterrupted_psnr_views_mean_after=before[
                            "psnr_views_mean_after"]),
        card=smi)
    emit(rec)
    # the steps after the restored one: the rest of t = 2
    later = TRAIN_STEPS + (TRAIN_T - 1) * TRAIN_STEPS_LATER - CKPT_MID
    checks = {
        "saved steps": saved == CKPT_SAVED and on_disk == CKPT_SAVED[1:],
        "final resume bitwise": len(shared) >= 3 and all(bitwise.values()),
        "final resume ran no step": fin["launches"]["raster_bwd"] == 0,
        "mid resume steps": mid["launches"]["raster_bwd"] == later
        and cursor == {"t": TRAIN_T - 1, "i": TRAIN_STEPS_LATER}
        and step == CKPT_SAVED[-1],
        "mid resume losses finite": bool(reports) and np.isfinite(
            [list(r.values()) for r in reports]).all(),
        "mid resume PSNR": rec["resume_mid"]["psnr_views_mean_after"]
        >= before["psnr_views_mean_before"] and cut == 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"checkpoint / resume checks failed: {bad}")
    return rec


def phase_evaluate_main_path(train_rec, device, smi):
    """`cli evaluate --max_timesteps 3 --max_cams 4` on `train_main_path`'s
    params.npz and layout, then `cli evaluate-suite` with two pairs of it,
    each with the launch counts set to 0 just before and read just after:
    K1 once per view (12, and 24), K2 and K3 never. Every view is rendered
    once more through the kernel and through the plain version on the
    card: their rgb, alpha and exact depth must agree per pixel within the
    oracle phase's tolerances, and the CLI's per-view PSNR and SSIM must
    agree with the plain render's within 0.01 dB and 1e-4 (the quantized
    key's depth against the exact one is reported for t = 0, camera 0). ms
    per view: the CLI's wall time over its views, and the kernel render's
    own."""
    import contextlib
    import io

    import torch
    from dynamic3dgaussians_tpu_torch import cli
    from dynamic3dgaussians_tpu_torch.data import dataset as D
    from dynamic3dgaussians_tpu_torch.eval import metrics as M
    from dynamic3dgaussians_tpu_torch.eval import suite as S
    from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame)
    root, seq = train_rec["data_root"], train_rec["seq"]
    params_path = os.path.join(train_rec["run_dir"], "params.npz")
    common = ["--data_root", root, "--max_timesteps", str(TRAIN_T),
              "--max_cams", str(TRAIN_CAMS), "--device", str(device)]
    out_json = os.path.join(root, "evaluate.json")
    suite_json = os.path.join(root, "evaluate_suite.json")
    runs = {}
    for name, argv in (
            ("evaluate", ["evaluate", "--params", params_path, "--seq", seq,
                          "--out", out_json]),
            ("evaluate_suite", ["evaluate-suite", "--pairs",
                                f"{seq}={params_path},{seq}={params_path}",
                                "--out", suite_json])):
        buf = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + common)
        torch.cuda.synchronize()
        runs[name] = dict(seconds=time.perf_counter() - t0,
                          launches=read_launches(),
                          printed=buf.getvalue().strip().splitlines())
    with open(out_json) as fh:
        out = json.load(fh)
    with open(suite_json) as fh:
        suite = json.load(fh)
    n_views = len(out["rows"])
    summary = json.loads(runs["evaluate"]["printed"][-1])
    suite_line = json.loads(runs["evaluate_suite"]["printed"][-1])

    stacked = load_params(params_path)
    cli_rows = {(r["t"], r["cam"]): r for r in out["rows"]}
    md = D.load_meta(root, seq)
    render_ms = []
    pixel_err = {"rgb": 0.0, "alpha": 0.0, "depth": 0.0}
    d_psnr, d_ssim, depth_err = [], [], {}
    for t in range(TRAIN_T):
        frames = D.load_timestep(root, seq, md, t, device=device)
        pt = params_at_t(stacked, t)
        for f in frames[:TRAIN_CAMS]:
            render_frame(pt, f["camera"], config=S.EVAL_RASTER,
                         device=device)                       # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_k = render_frame(pt, f["camera"], config=S.EVAL_RASTER,
                                 device=device)
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
            out_p = render_frame(pt, f["camera"], config=S.EVAL_RASTER,
                                 method="torch", device=device)
            for key in pixel_err:
                pixel_err[key] = max(pixel_err[key], float(
                    (getattr(out_k, key) - getattr(out_p, key)).abs().max()))
            rgb_p = torch.clamp(out_p.rgb, 0, 1)
            row = cli_rows[(t, int(f["cam_id"]))]
            d_psnr.append(abs(row["psnr"]
                              - float(M.masked_psnr(rgb_p, f["im"]))))
            d_ssim.append(abs(row["ssim"]
                              - float(M.masked_ssim(rgb_p, f["im"]))))
            if t == 0 and int(f["cam_id"]) == 0:
                out_q = render_frame(pt, f["camera"], config=RasterConfig(
                    depth_mode="quantized"), device=device)
                depth_err = dict(quantized_vs_exact=float(
                    (out_q.depth - out_k.depth).abs().max()))
    rec = dict(phase="evaluate_main_path",
               cmd="cli evaluate " + " ".join(common[2:-2]),
               n_views=n_views, summary=summary, suite_mean=suite_line,
               suite_scenes=list(suite["scenes"]),
               launches=runs["evaluate"]["launches"],
               launches_suite=runs["evaluate_suite"]["launches"],
               cli_s=runs["evaluate"]["seconds"],
               cli_ms_per_view=runs["evaluate"]["seconds"] * 1e3 / n_views,
               suite_s=runs["evaluate_suite"]["seconds"],
               render_ms_per_view=render_ms,
               render_ms_per_view_median=float(np.median(render_ms)),
               psnr_views=[r["psnr"] for r in out["rows"]],
               psnr_kernel_vs_plain_max=max(d_psnr),
               ssim_kernel_vs_plain_max=max(d_ssim),
               pixel_err_kernel_vs_plain=pixel_err, depth_err=depth_err,
               tol=dict(psnr_db=EVAL_PSNR_TOL_DB, ssim=EVAL_SSIM_TOL,
                        rgb=ATOL_CHAN, alpha=ATOL_CHAN, depth=ATOL_DEPTH),
               card=smi)
    emit(rec)
    want = TRAIN_T * TRAIN_CAMS
    checks = {
        "views": n_views == want and summary["n_views"] == want,
        "evaluate launches": runs["evaluate"]["launches"] == {
            "raster_fwd": want, "raster_bwd": 0, "sol_probe": 0},
        "suite launches": runs["evaluate_suite"]["launches"] == {
            "raster_fwd": 2 * want, "raster_bwd": 0, "sol_probe": 0},
        "suite": suite_line["n_scenes"] == 2 and set(suite) == {
            "scenes", "mean", "rows"},
        "finite": np.isfinite([summary["psnr"], summary["ssim"]]).all(),
        "psnr vs plain": max(d_psnr) <= EVAL_PSNR_TOL_DB,
        "ssim vs plain": max(d_ssim) <= EVAL_SSIM_TOL,
        "pixels vs plain": (pixel_err["rgb"] <= ATOL_CHAN
                            and pixel_err["alpha"] <= ATOL_CHAN
                            and pixel_err["depth"] <= ATOL_DEPTH),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"evaluation checks failed: {bad}")
    return rec


def phase_tracking(train_rec, device, smi):
    """`track_pixels` on `train_main_path`'s params.npz from camera 0 with
    256 foreground pixels of its t = 0 image (one K1 launch, the counts
    set to 0 just before and read just after): finite tracks, the kernel
    path within 1e-3 px of the plain path, and the PCK@0.05 against the
    layout's known rigid foreground motion (`synthetic.animate`) applied to
    the lifted queries, beside the PCK of tracks that stay put."""
    import torch
    from dynamic3dgaussians_tpu_torch.data import dataset as D
    from dynamic3dgaussians_tpu_torch.data.synthetic import animate
    from dynamic3dgaussians_tpu_torch.eval.metrics import pck
    from dynamic3dgaussians_tpu_torch.eval.tracking import (
        project_tracks, track_pixels, unproject_queries)
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame)
    root, seq = train_rec["data_root"], train_rec["seq"]
    stacked = load_params(os.path.join(train_rec["run_dir"], "params.npz"))
    md = D.load_meta(root, seq)
    frame = D.load_timestep(root, seq, md, 0, device=device)[0]
    cam = frame["camera"]
    fg = np.flatnonzero(frame["seg"][..., 0].cpu().numpy().reshape(-1)
                        > 0.5)
    pick = np.random.RandomState(4).choice(fg, TRACK_QUERIES, replace=False)
    px = np.stack([pick % W + 0.5, pick // W + 0.5], -1).astype(np.float32)
    track_pixels(stacked, cam, px, device=device)             # warm
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks = track_pixels(stacked, cam, px, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    plain = track_pixels(stacked, cam, px, method="torch", device=device)
    err = float((tracks - plain).abs().max())
    with torch.no_grad():
        out = render_frame(params_at_t(stacked, 0), cam, device=device)
        q3 = unproject_queries(torch.as_tensor(px, device=device), out.depth,
                               out.alpha, cam)
        q3_np = q3.cpu().numpy().astype(np.float32)
        gt = np.stack([animate({"means": q3_np, "n_fg": len(q3_np)}, t,
                               TRAIN_T) for t in range(TRAIN_T)])
        gt_px = project_tracks(torch.as_tensor(gt, device=device), cam)
        pck_t = [float(pck(tracks[t], gt_px[t], (W, H), ratio=PCK_RATIO))
                 for t in range(TRAIN_T)]
        # the same score for tracks that do not move: what the trained
        # motion adds to it
        still = torch.as_tensor(px, device=device)
        pck_still = [float(pck(still, gt_px[t], (W, H), ratio=PCK_RATIO))
                     for t in range(TRAIN_T)]
        moved = float((gt_px[-1] - gt_px[0]).norm(dim=-1).mean())
        tracked = float((tracks[-1] - tracks[0]).norm(dim=-1).mean())
        alpha_q = out.alpha.reshape(-1)[torch.as_tensor(pick,
                                                         device=device)]
    rec = dict(phase="tracking", queries=TRACK_QUERIES, camera=0,
               timesteps=int(tracks.shape[0]), launches=launches, ms=ms,
               max_abs_err_vs_plain_px=err, tol_px=TRACK_TOL_PX,
               pck_ratio=PCK_RATIO, pck_by_t=pck_t,
               pck_later_mean=float(np.mean(pck_t[1:])),
               pck_still_by_t=pck_still,
               gt_motion_px_mean=moved, track_motion_px_mean=tracked,
               query_alpha_min=float(alpha_q.min()), card=smi)
    emit(rec)
    checks = {
        "launches": launches == {"raster_fwd": 1, "raster_bwd": 0,
                                 "sol_probe": 0},
        "shape": tuple(tracks.shape) == (TRAIN_T, TRACK_QUERIES, 2),
        "finite": bool(torch.isfinite(tracks).all()),
        "kernel vs plain": err <= TRACK_TOL_PX,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tracking checks failed: {bad}")
    return rec


def phase_knn_approx(scene, device, smi):
    """`knn_approx` and exact `knn` (20 neighbours) over the bench scene's
    foreground points (seg 1, ~100k): seconds of each (one warm call
    before), and the recall of the approximate neighbours against the
    exact ones, which must be at least `KNN_RECALL_MIN`. Every approximate
    neighbour is a valid point, and the j-th approximate distance is never
    below the j-th exact one."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.knn import knn, knn_approx
    pts = torch.as_tensor(scene["means"][scene["seg_colors"][:, 0] > 0.5],
                          device=device)
    n = int(pts.shape[0])
    times = {}
    out = {}
    for name, fn in (("approx", knn_approx), ("exact", knn)):
        fn(pts[:4096], KNN_K)                                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(pts, KNN_K)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    (ad, ai), (ed, ei) = out["approx"], out["exact"]
    found = ai >= 0
    hits = ((ai[:, :, None] == ei[:, None, :]).any(-1) & found)
    recall = float(hits.sum()) / float((ei >= 0).sum())
    below = float((ed - ad).clamp(min=0).max())
    rec = dict(phase="knn_approx", n_points=n, k=KNN_K,
               approx_s=times["approx"], exact_s=times["exact"],
               speedup=times["exact"] / times["approx"], recall=recall,
               recall_min=KNN_RECALL_MIN,
               found_share=float(found.float().mean()),
               approx_below_exact_max=below, card=smi)
    emit(rec)
    # the exact distances cancel |a|^2 + |b|^2 - 2 a.b terms up to ~12
    if not (KNN_RECALL_MIN <= recall <= 1.0 and bool(found.all())
            and below <= 1e-4 and bool(torch.isfinite(ad).all())):
        raise AssertionError(f"knn_approx checks failed: {rec}")
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
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import KINDS
    from dynamic3dgaussians_tpu_torch.tools import bench_sol

    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_sol.main([])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
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


# Cached-order playback (`playback_main_path`), the viewer's case: one key
# frame at the bench view, then cached frames at small camera steps at one
# timestep. A fresh cache differs from the exact render in two ways, held
# apart. (1) The f16 transport of the conic, opacity and channel rows:
# held against K1 on the same records in the same order in float32, at
# tests/test_playback.py's bounds (one 8-bit quantum; depth 2e-2 + 1e-3
# relative). f16 opacity can move a record's alpha across the 1/255 gate,
# which adds or drops up to 1/255 of weight at that pixel: there
# (`gate_flips`) the bounds grow by 1/255 (depth: 1/255 of PB_Z_MAX,
# beyond the farthest point of the bench cube at z = 6). (2) The order:
# the cache's float-bits key orders depth only to 2^-13 relative at this
# grid (21 key bits), the exact render's affine key to 2^-21 of the depth
# range, so near-equal depths in a tile may composite in another order
# (ROADMAP.md §3). The order itself is checked exactly: the cache's
# segments equal the exact render's, each tile holds the same gaussian
# ids, and the float-bits key never decreases along the cached order.
# Alpha does not depend on the order and is held at (1)'s bound against
# the exact render; rgb also by PSNR against the exact render at the stale
# cache's bound, > 45 dB, as is a cache 0.01 of a unit stale.
PB_FRAMES = 8
PB_STEP = 0.0025
PB_STALE_SHIFT = 0.01
PB_REPS = 7
PB_QUANTUM = 3.9e-3
PB_ATOL_DEPTH, PB_RTOL_DEPTH = 2e-2, 1e-3
PB_STALE_PSNR_MIN = 45.0
PB_RESORT = 8
PB_Z_MAX = 10.0


def psnr(a, b) -> float:
    mse = float(((a - b) ** 2).mean())
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def host_ms(fn, reps):
    """ms of each of `reps` calls of `fn` after one untimed call, the
    device idle before each and waited for after it."""
    import torch
    fn()
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def gate_flips(rec_a, rec_b, starts, counts):
    """(tiles, pixels) bool: the pixels at which some in-segment record
    passes the 1/255 gate in one of two tables of the same records and not
    in the other (every chunk of a tile, as if none stopped)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, \
        ALPHA_MAX
    grid_w = -(-W // TILE)
    dev = rec_a.device
    s, c = starts.long(), counts.long()
    shift = s % CHUNK
    base = s - shift
    n_chunks = (shift + c + CHUNK - 1) // CHUNK
    tile = torch.arange(s.shape[0], device=dev)
    lin = torch.arange(TILE * TILE, device=dev)
    px = ((tile % grid_w) * TILE).float()[:, None] + (lin % TILE).float()
    py = ((tile // grid_w) * TILE).float()[:, None] + (lin // TILE).float()
    lane = torch.arange(CHUNK, device=dev)
    flip = torch.zeros_like(px, dtype=torch.bool)

    def passes(rec, idx, ok):
        g = rec[:6, torch.clamp(idx, max=rec.shape[1] - 1)]
        dx = g[0][:, None, :] - px[:, :, None]
        dy = g[1][:, None, :] - py[:, :, None]
        power = torch.clamp(-0.5 * (g[2][:, None] * dx * dx
                                    + g[4][:, None] * dy * dy)
                            - g[3][:, None] * dx * dy, max=0.0)
        alpha = torch.clamp(g[5][:, None] * torch.exp2(power), max=ALPHA_MAX)
        return (alpha >= ALPHA_EPS) & ok[:, None, :]

    for k in range(int(n_chunks.max())):
        idx = base[:, None] + k * CHUNK + lane
        ok = ((lane >= (shift - k * CHUNK)[:, None])
              & (lane < (shift + c - k * CHUNK)[:, None]))
        flip |= (passes(rec_a, idx, ok) != passes(rec_b, idx, ok)).any(-1)
    return flip


def raw_errors(k, p, n_chan):
    """K1's outputs (raw, log_t, n_active) against its plain version's, as
    `phase_k1` holds them."""
    raw_k, logt_k, nact_k = k
    raw_p, logt_p, nact_p = p
    n_val = raw_k.shape[-1]
    rows = [i for i in range(n_val) if i != n_chan]
    dn = (nact_k - nact_p).abs().reshape(-1)
    err = dict(chan=float((raw_k[..., rows] - raw_p[..., rows]).abs().max()),
               depth=float((raw_k[..., n_chan] - raw_p[..., n_chan]).abs()
                           .max()),
               log_t=float((logt_k - logt_p).abs().max()),
               n_active_equal=int((dn == 0).sum()) / dn.numel(),
               n_active_maxdiff=int(dn.max()))
    err["ok"] = (err["chan"] <= ATOL_CHAN and err["depth"] <= ATOL_DEPTH
                 and err["log_t"] <= ATOL_LOGT
                 and err["n_active_equal"] >= NACT_EQUAL_MIN
                 and err["n_active_maxdiff"] <= 1)
    return err


def phase_playback_main_path(scene, device, smi):
    """Cached-order playback at the bench view (200k gaussians, RGB + 3 seg
    channels, CV 8): `build_cache` at a key frame, then `render_playback`
    at 8 cameras 0.0025 apart along x, the launch counts set to 0 just
    before and read just after (K1 once per frame, none in build_cache).
    The cache's order against the exact render's emission and sort; frame
    0 (a fresh cache) against the exact kernel render; a cache 0.01 stale
    by PSNR; the last frame's record table through K1 against K1's plain
    version on the card at K1's tolerances, with the footprint cull's
    `pairs_live_culled` = 0. Medians
    of 7 timed calls: a key frame (build_cache + render_playback), a
    cached frame, the exact frame (`render`, method cuda), on tensors on
    the card. Then `cli visualize --resort-every 8` on `main_path`'s
    checkpoint: a timestep per frame, so every frame is a key frame, K1
    once per frame."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        composite_tiles, composite_tiles_torch)
    from dynamic3dgaussians_tpu_torch.ops.playback import (
        build_cache, playback_records, render_playback)
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (
        _untile, depth_key_bits, emit as emit_pairs, fuse_tile_depth_key,
        prepare_records, record_columns)

    t = {k: torch.as_tensor(v, device=device) for k, v in scene.items()}
    args = (t["means"], t["colors"], t["opac"], t["scales"], t["quats"])
    geom = (t["means"], t["opac"], t["scales"], t["quats"])
    seg = t["seg_colors"]
    cams = [bench_camera(device, PB_STEP * i) for i in range(PB_FRAMES)]

    def cached(cam, cache, **kw):
        return render_playback(cam, *args, cache, extra_channels=seg,
                               device=device, **kw)

    def exact(cam):
        with torch.no_grad():
            return render(cam, *args, extra_channels=seg, method="cuda",
                          device=device)

    zero_launches()
    cache = build_cache(cams[0], *geom, device=device)
    torch.cuda.synchronize()
    build_launches = read_launches()
    outs = [cached(cam, cache) for cam in cams]
    torch.cuda.synchronize()
    launches = read_launches()

    fresh, ref = outs[0], exact(cams[0])
    kw = dict(num_tiles=cache.starts.shape[0], grid_w=-(-W // TILE),
              tile_h=TILE, tile_w=TILE, chunk=CHUNK)
    with torch.no_grad():
        proj = project(t["means"], t["scales"], t["quats"], cams[0])
        op = torch.where(proj.valid, t["opac"], torch.zeros_like(t["opac"]))
        chans = torch.cat([t["colors"], seg], dim=-1)
        rec_pb = playback_records(proj, chans, op, cache, CHUNK)
        table = record_columns(proj, chans, op)
        rec_f32 = torch.zeros_like(rec_pb)
        rec_f32[:, :cache.gidx.shape[0]] = table[:, cache.gidx.long()]
        # the exact render's emission and sort at the key frame's camera
        cfg = RasterConfig()
        num_tiles = cache.starts.shape[0]
        tile_key, gid, _ = emit_pairs(
            H, W, proj, op, tile_h=TILE, tile_w=TILE,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            exact_cull=cfg.exact_cull, enum_cap=cfg.emit_enum_cap)
        _, ex_starts, ex_counts, ex_slots = prepare_records(
            tile_key, gid, table, n_chan=chans.shape[1], num_tiles=num_tiles,
            chunk=CHUNK, bits_z=depth_key_bits(num_tiles),
            depth_mode=cfg.depth_mode)
        ex_gidx = gid[ex_slots].long()
        tiles = torch.arange(num_tiles, device=device)
        pair_tile = torch.repeat_interleave(tiles, cache.counts.long())
        pb_key = fuse_tile_depth_key(pair_tile.to(torch.int32),
                                     proj.depth[cache.gidx.long()],
                                     depth_key_bits(num_tiles))
        same_segments = bool(torch.equal(cache.starts, ex_starts)
                             and torch.equal(cache.counts, ex_counts))
        n = t["means"].shape[0]
        same_ids = same_segments and bool(torch.equal(
            torch.sort(pair_tile * n + cache.gidx.long())[0],
            torch.sort(torch.repeat_interleave(tiles, ex_counts.long()) * n
                       + ex_gidx)[0]))
        order = dict(
            n_live=int(cache.gidx.shape[0]), n_live_exact=int(ex_gidx.shape[0]),
            same_segments=same_segments, same_ids_per_tile=same_ids,
            key_nondecreasing=bool((pb_key[1:] >= pb_key[:-1]).all()),
            pairs_in_exact_order=float(
                (cache.gidx.long() == ex_gidx).float().mean())
            if cache.gidx.shape[0] == ex_gidx.shape[0] else None)
    flip = gate_flips(rec_pb, rec_f32, cache.starts, cache.counts)
    allow = flip.float() * ALPHA_EPS
    raw_pb = composite_tiles(rec_pb, cache.starts, cache.counts, **kw)[0]
    raw_f32 = composite_tiles(rec_f32, cache.starts, cache.counts, **kw)[0]
    n_chan = chans.shape[1]
    grid = (-(-H // TILE), -(-W // TILE), TILE, TILE, H, W)
    f32_rgb = _untile(raw_f32[..., :3], *grid, 3)
    f32_alpha = _untile(raw_f32[..., n_chan + 1, None], *grid, 1)[..., 0]
    f32_order_vs_exact = dict(
        rgb=float((f32_rgb - ref.rgb).abs().max()),
        alpha=float((f32_alpha - ref.alpha).abs().max()),
        psnr_rgb=psnr(f32_rgb, ref.rgb))
    e = (raw_pb - raw_f32).abs()
    e_chan = torch.cat([e[..., :n_chan], e[..., n_chan + 1:n_chan + 2]],
                       -1).amax(-1)
    depth_bound = (PB_ATOL_DEPTH + PB_RTOL_DEPTH * raw_f32[..., n_chan].abs()
                   + allow * PB_Z_MAX)
    e_alpha = (fresh.alpha - ref.alpha).abs()
    flip_img = _untile(flip[..., None], -(-H // TILE), -(-W // TILE), TILE,
                       TILE, H, W, 1)[..., 0]
    err_fresh = dict(
        f16_chan=float(e_chan.max()),
        f16_chan_no_flip=float(torch.where(flip, 0.0, e_chan).max()),
        f16_depth=float(e[..., n_chan].max()),
        alpha_vs_exact=float(e_alpha.max()),
        rgb_vs_exact=float((fresh.rgb - ref.rgb).abs().max()),
        extra_vs_exact=float((fresh.extra - ref.extra).abs().max()),
        depth_vs_exact=float((fresh.depth - ref.depth).abs().max()),
        psnr_rgb_vs_exact=psnr(fresh.rgb, ref.rgb),
        psnr_extra_vs_exact=psnr(fresh.extra, ref.extra))
    excess = dict(
        f16_chan=float((e_chan - PB_QUANTUM - allow).max()),
        f16_depth=float((e[..., n_chan] - depth_bound).max()),
        alpha_vs_exact=float((e_alpha - PB_QUANTUM
                              - flip_img.float() * ALPHA_EPS).max()))
    psnr_cached = [psnr(o.rgb, exact(cam).rgb)
                   for o, cam in zip(outs, cams)]
    stale_cam = bench_camera(device, PB_STALE_SHIFT)
    psnr_stale = psnr(cached(stale_cam, cache).rgb, exact(stale_cam).rgb)

    with torch.no_grad():
        proj = project(t["means"], t["scales"], t["quats"], cams[-1])
        op = torch.where(proj.valid, t["opac"], torch.zeros_like(t["opac"]))
        rec_t = playback_records(proj, chans, op, cache, CHUNK)
    k_out = composite_tiles(rec_t, cache.starts, cache.counts, **kw)
    p_out = composite_tiles_torch(rec_t, cache.starts, cache.counts, **kw)
    err_k1 = raw_errors(k_out, p_out, chans.shape[1])
    cells = table_stats("playback", rec_t, cache.starts, cache.counts,
                        k_out[2])

    key_ms = host_ms(lambda i=0: cached(
        cams[0], build_cache(cams[0], *geom, device=device)), PB_REPS)
    build_ms = host_ms(lambda i=0: build_cache(cams[0], *geom,
                                               device=device), PB_REPS)
    cached_ms = host_ms(lambda i=0: cached(cams[1 + i % (PB_FRAMES - 1)],
                                           cache), PB_REPS)
    exact_ms = host_ms(lambda i=0: exact(cams[1 + i % (PB_FRAMES - 1)]),
                       PB_REPS)

    with tempfile.TemporaryDirectory() as tmp:
        path = main_checkpoint(scene, tmp)
        vis_s, vis_launches, _ = run_visualize(
            path, os.path.join(tmp, "orbit.gif"),
            ["--resort-every", str(PB_RESORT)])

    rec = dict(
        phase="playback_main_path", n_gaussians=N_GAUSS, cv=rec_t.shape[0] - 8,
        frames=PB_FRAMES, step=PB_STEP, n_live=int(cache.gidx.shape[0]),
        ne_pad=rec_t.shape[1], n_dropped_rect=int(cache.n_dropped_rect),
        build_cache_launches=build_launches, launches=launches,
        order=order, f32_order_vs_exact=f32_order_vs_exact,
        err_fresh_vs_exact=err_fresh, bound_excess=excess,
        gate_flip_pixels=int(flip.sum()),
        psnr_cached_vs_exact=psnr_cached, psnr_stale=psnr_stale,
        stale_shift=PB_STALE_SHIFT, k1_vs_plain=err_k1, cells=cells,
        key_frame_ms=key_ms, key_frame_ms_median=float(np.median(key_ms)),
        build_cache_ms_median=float(np.median(build_ms)),
        cached_frame_ms=cached_ms,
        cached_frame_ms_median=float(np.median(cached_ms)),
        exact_frame_ms=exact_ms,
        exact_frame_ms_median=float(np.median(exact_ms)),
        visualize=dict(cmd="cli visualize --resort-every "
                       f"{PB_RESORT} " + " ".join(MAIN_FLAGS),
                       seconds=vis_s, launches=vis_launches),
        tol=dict(quantum=PB_QUANTUM, depth=(PB_ATOL_DEPTH, PB_RTOL_DEPTH),
                 gate_flip=ALPHA_EPS, gate_flip_depth=ALPHA_EPS * PB_Z_MAX,
                 stale_psnr_db=PB_STALE_PSNR_MIN, k1_chan=ATOL_CHAN,
                 k1_depth=ATOL_DEPTH),
        card=smi)
    emit(rec)
    none = {"raster_fwd": 0, "raster_bwd": 0, "sol_probe": 0}
    checks = {
        "build_cache launches nothing": build_launches == none,
        "K1 once per frame": launches == dict(none, raster_fwd=PB_FRAMES),
        "cache segments equal the exact render's": same_segments,
        "same gaussian ids per tile": same_ids,
        "cached order sorted by the float-bits key":
            order["key_nondecreasing"],
        "fresh cache: f16 transport and alpha": max(excess.values()) <= 0.0,
        "fresh cache vs exact: PSNR": min(
            err_fresh["psnr_rgb_vs_exact"],
            err_fresh["psnr_extra_vs_exact"]) > PB_STALE_PSNR_MIN,
        "stale cache PSNR": psnr_stale > PB_STALE_PSNR_MIN,
        "K1 vs plain on the playback table": err_k1["ok"],
        "finite": bool(all(torch.isfinite(o.rgb).all() for o in outs)),
        "no drops": int(cache.n_dropped_rect) == 0,
        "visualize K1 once per frame": vis_launches == dict(
            none, raster_fwd=MAIN_FRAMES),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"playback checks failed: {bad}")
    return rec


# The viewer (`view_main_path`): `cli train`'s params.npz served by
# `make_server` on port 0; 12 requests 0.003 rad apart at one timestep
# (cached frames), then a jump of 1.5 rad (a rebuild). A served JPEG is
# held against the frame of a second CheckpointSource given the same
# requests: its mean error at most the JPEG's own on that frame plus a
# quarter level. That source's rgb frames of the steps and the jump are
# held against the exact render at the same camera by PSNR: those whose
# request built a cache at the playback bound (PB_STALE_PSNR_MIN); the
# others, through a cache up to 7 steps old, are reported. The refresh
# rule (8 frames, or a move of 5 % of the radius) is the reference's, and
# on the trained scene it lets a cached frame fall to ~30 dB (PERF.md). The network GUI's reply (raw RGB bytes) against a local
# render of the camera as sent: mean at most 0.05 levels.
VIEW_STEPS = 12
VIEW_STEP = 0.003
VIEW_JUMP = 1.5
VIEW_JPEG_MARGIN = 0.25
GUI_REQUESTS = 5
BRIDGE_REQUESTS = 3
GUI_MEAN_LEVELS = 0.05
SOCKET_TIMEOUT = 60.0


def _http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=SOCKET_TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _decode_jpeg(body):
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(body)))


@contextlib.contextmanager
def http_server(source):
    """`make_server(source)` on port 0, served on a daemon thread; yields
    its base URL and shuts it down on exit."""
    import threading
    from dynamic3dgaussians_tpu_torch.viz.live_viewer import make_server
    srv = make_server(source, port=0, w=W, h=H, f=F)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=SOCKET_TIMEOUT)


def phase_view_main_path(train_rec, device, smi):
    """`cli view`'s server over `train_main_path`'s params.npz: `/`,
    `/meta`, `/frame` in the modes rgb, depth, seg and centers with the
    trajectory overlay, a run of small steps at one timestep and a jump
    (the playback caches built, the LRU's size and ms per request); then a
    `NetworkGUI` serving K1 renders, reached by `GuiClient` (round-trip
    ms) and by the browser bridge of `serve_live` (`GuiClientSource`
    behind `make_server`). The launch counts are set to 0 before the
    first request and read after the last: K1 once per rendered request.
    The comparisons come after."""
    import threading
    from urllib.parse import urlencode

    import torch
    from dynamic3dgaussians_tpu_torch.utils.image_utils import \
        render_net_image
    from dynamic3dgaussians_tpu_torch.viz import live_viewer as lv
    from dynamic3dgaussians_tpu_torch.viz.network_gui import NetworkGUI
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import (params_at_t,
                                                         render_frame,
                                                         to_uint8)
    stacked = load_params(os.path.join(train_rec["run_dir"], "params.npz"))
    src = lv.CheckpointSource(stacked, device=device)
    if not src.use_playback:
        raise AssertionError("CheckpointSource on cuda did not take playback")
    r = src.radius
    queries = [dict(az=0.7, el=0.3, r=r, t=0, mode=m, traj=1)
               for m in ("rgb", "depth", "seg", "centers")]
    queries += [dict(az=0.7 + VIEW_STEP * (i + 1), el=0.3, r=r, t=1,
                     mode="rgb", traj=0) for i in range(VIEW_STEPS)]
    queries += [dict(az=0.7 + VIEW_STEP * VIEW_STEPS + VIEW_JUMP, el=0.3,
                     r=r, t=1, mode="rgb", traj=0)]
    pt = params_at_t(stacked, 0)

    def gui_render(cam, mode, scaling_modifier):
        return render_net_image(render_frame(pt, cam, device=device), mode,
                                fx=float(cam.fx), fy=float(cam.fy))

    def gui_cam(i):
        return lv.orbit_camera(src.center, 0.7 + 0.01 * i, 0.3, r, W, H, F,
                               device=device)

    served, http, gui_ms, bridge = [], [], [], []
    zero_launches()
    with http_server(src) as base:
        status_page = _http_get(base + "/")[:2]
        meta = json.loads(_http_get(base + "/meta")[2])
        for q in queries:
            t0 = time.perf_counter()
            status, ctype, body = _http_get(base + "/frame?" + urlencode(q))
            http.append(dict(q=q, ms=(time.perf_counter() - t0) * 1e3,
                             status=status, ctype=ctype, body=body,
                             builds=src.cache_builds, lru=len(src._pb)))
    gui = NetworkGUI(port=0, timeout=SOCKET_TIMEOUT, device=device)
    stop = threading.Event()

    def gui_loop():
        while not stop.is_set():
            if gui.poll(gui_render) is not None:
                served.append(1)
            else:
                time.sleep(0.001)

    th = threading.Thread(target=gui_loop, daemon=True)
    th.start()
    try:
        client = lv.GuiClient(port=gui.port, timeout=SOCKET_TIMEOUT)
        try:
            gui_imgs = []
            for i in range(GUI_REQUESTS):
                t0 = time.perf_counter()
                img, _ = client.request(gui_cam(i), render_mode="RGB")
                gui_ms.append((time.perf_counter() - t0) * 1e3)
                gui_imgs.append(img)
        finally:
            client.close()
        bsrc = lv.GuiClientSource("127.0.0.1", gui.port, center=src.center,
                                  radius=r, device=device)
        try:
            with http_server(bsrc) as base:
                for i in range(BRIDGE_REQUESTS):
                    q = dict(az=0.7 + 0.01 * i, el=0.3, r=r, mode="rgb")
                    t0 = time.perf_counter()
                    _, ctype, body = _http_get(base + "/frame?"
                                               + urlencode(q))
                    bridge.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                       ctype=ctype, body=body))
        finally:
            bsrc.client.close()
    finally:
        stop.set()
        th.join(timeout=2 * SOCKET_TIMEOUT)
        gui.close()
    torch.cuda.synchronize()
    launches = read_launches()

    # the comparisons: a twin source given the same requests
    twin = lv.CheckpointSource(stacked, device=device)
    frame_err = []
    for h in http:
        q = h["q"]
        cam = lv.orbit_camera(twin.center, q["az"], q["el"], q["r"], W, H, F,
                              device=device)
        built = twin.cache_builds
        want = twin.frame(cam, q["t"], q["mode"], q["traj"] == 1).astype(
            np.float64)
        built = twin.cache_builds > built
        got = _decode_jpeg(h["body"])
        own = _decode_jpeg(lv._encode_jpeg(want.astype(np.uint8)))
        frame_err.append(dict(mode=q["mode"], shape=list(got.shape),
                              mean=float(np.abs(got - want).mean()),
                              jpeg_mean=float(np.abs(own - want).mean()),
                              equal=bool(np.array_equal(got, own))))
        if q["mode"] == "rgb" and q["traj"] == 0:
            exact = to_uint8(render_frame(params_at_t(stacked, q["t"]), cam,
                                          device=device).rgb)
            frame_err[-1].update(
                psnr_vs_exact=psnr(want / 255.0, exact / 255.0),
                cache_built=bool(built))
    gui_err = []
    for i, img in enumerate(gui_imgs):
        want = to_uint8(render_frame(pt, gui_cam(i), device=device).rgb)
        d = np.abs(img.astype(np.float64) - want)
        gui_err.append(dict(mean=float(d.mean()), max=float(d.max())))
    bridge_err = []
    for i, b in enumerate(bridge):
        want = to_uint8(render_frame(pt, gui_cam(i), device=device).rgb)
        own = _decode_jpeg(lv._encode_jpeg(want))
        got = _decode_jpeg(b["body"])
        bridge_err.append(dict(
            mean=float(np.abs(got - want.astype(np.float64)).mean()),
            jpeg_mean=float(np.abs(own - want.astype(np.float64)).mean())))

    rendered = sum(h["q"]["mode"] != "centers" for h in http)
    steps = http[4:4 + VIEW_STEPS]
    rec = dict(
        phase="view_main_path", n_gaussians=int(stacked["means3D"].shape[1]),
        timesteps=src.num_t, meta=meta, page=list(status_page),
        requests=len(http), launches=launches,
        cache_builds=[h["builds"] for h in http],
        lru_size=[h["lru"] for h in http],
        ms_per_request=[h["ms"] for h in http],
        ms_first_per_mode={h["q"]["mode"]: h["ms"] for h in http[:4]},
        ms_steps_median=float(np.median([h["ms"] for h in steps])),
        ms_jump=http[-1]["ms"], frame_err=frame_err,
        psnr_vs_exact=[e["psnr_vs_exact"] for e in frame_err
                       if "psnr_vs_exact" in e],
        gui_round_trip_ms=gui_ms,
        gui_round_trip_ms_median=float(np.median(gui_ms)),
        gui_err=gui_err, gui_served=len(served),
        bridge_ms=[b["ms"] for b in bridge], bridge_err=bridge_err,
        tol=dict(jpeg_margin_levels=VIEW_JPEG_MARGIN,
                 gui_mean_levels=GUI_MEAN_LEVELS,
                 playback_psnr_db=PB_STALE_PSNR_MIN),
        card=smi)
    emit(rec)
    none = {"raster_fwd": 0, "raster_bwd": 0, "sol_probe": 0}
    builds = [h["builds"] for h in http]
    checks = {
        "page and meta": status_page == (200, "text/html")
        and meta["num_timesteps"] == src.num_t,
        "frames": all(h["status"] == 200 and h["ctype"] == "image/jpeg"
                      for h in http)
        and all(e["shape"] == [H, W, 3] for e in frame_err),
        "K1 once per render": launches == dict(
            none, raster_fwd=rendered + GUI_REQUESTS + BRIDGE_REQUESTS),
        "cached frames": builds[-2] - builds[4] < VIEW_STEPS,
        "jump rebuilds": builds[-1] == builds[-2] + 1,
        "lru": max(h["lru"] for h in http) <= 4,
        "jpeg vs source": all(e["mean"] <= e["jpeg_mean"] + VIEW_JPEG_MARGIN
                              for e in frame_err),
        "key frames vs exact": all(
            e["psnr_vs_exact"] > PB_STALE_PSNR_MIN
            for e in frame_err if e.get("cache_built"))
        and sum(bool(e.get("cache_built")) for e in frame_err)
        == builds[-1] - builds[3],
        "gui served": len(served) == GUI_REQUESTS + BRIDGE_REQUESTS,
        "gui vs local": all(e["mean"] <= GUI_MEAN_LEVELS for e in gui_err),
        "bridge": all(b["ctype"] == "image/jpeg" for b in bridge)
        and all(e["mean"] <= e["jpeg_mean"] + VIEW_JPEG_MARGIN
                for e in bridge_err),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"viewer checks failed: {bad}")
    return rec


# The "tiled" method (plain PyTorch) against the kernel path: on the first
# 20,000 gaussians of the bench scene at the bench view, where its drop
# counters read 0, at the oracle phase's tolerances (neither the oracle nor
# the tiled path stops a tile early); the gradients of a seeded cotangent
# at the golden fixtures' rel 1e-2 of max(|g|, 1). At the full bench view
# only its counters and times are reported.
TILED_N = 20_000
TILED_REPS = 3


def phase_tiled(scene, device, smi):
    """One frame and one gradient of `render(method="tiled")` against the
    kernel path (depth_mode "exact": the tiled path composites exact
    depth), and the tiled path's drop counters and time at the bench
    view."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    cam = bench_camera(device)
    exact = RasterConfig(depth_mode="exact")
    keys = ("means", "colors", "opac", "scales", "quats")
    counters = ("n_dropped_capacity", "n_dropped_rect",
                "n_dropped_tile_overflow")
    rng = np.random.RandomState(11)
    ct_rgb = torch.as_tensor(rng.normal(size=(H, W, 3)).astype(np.float32),
                             device=device)
    ct_depth = torch.as_tensor(rng.normal(size=(H, W)).astype(np.float32),
                               device=device)

    def run(method, n, grad):
        ts = [torch.tensor(scene[k][:n], device=device, requires_grad=grad)
              for k in keys]
        seg = torch.as_tensor(scene["seg_colors"][:n], device=device)
        with torch.set_grad_enabled(grad):
            out = render(cam, *ts, extra_channels=seg, method=method,
                         config=exact if method == "cuda" else None,
                         device=device)
        if not grad:
            return out, None
        loss = (torch.sum(out.rgb * ct_rgb)
                + torch.sum(out.depth * ct_depth))
        return out, torch.autograd.grad(loss, ts)

    out_t, g_t = run("tiled", TILED_N, True)
    out_k, g_k = run("cuda", TILED_N, True)
    err = {k: float((getattr(out_t, k) - getattr(out_k, k)).abs().max())
           for k in ("rgb", "alpha", "extra", "depth")}
    grad_err = {k: float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                for k, a, b in zip(keys, g_t, g_k)}
    small = {c: int(getattr(out_t, c)) for c in counters}
    del g_t, g_k
    with torch.no_grad():
        full, _ = run("tiled", N_GAUSS, False)
        bench = {c: int(getattr(full, c)) for c in counters}
        del full
        tiled_ms = host_ms(lambda i=0: run("tiled", N_GAUSS, False),
                           TILED_REPS)
        kernel_ms = host_ms(lambda i=0: run("cuda", N_GAUSS, False),
                            TILED_REPS)
    rec = dict(phase="tiled", n_compare=TILED_N, counters_compare=small,
               n_dropped_rect_kernel=int(out_k.n_dropped_rect),
               err_vs_kernel=err, grad_rel_err=grad_err,
               counters_bench=bench, tiled_ms=tiled_ms,
               tiled_ms_median=float(np.median(tiled_ms)),
               kernel_path_ms=kernel_ms,
               kernel_path_ms_median=float(np.median(kernel_ms)),
               tol=dict(rgb=2e-4, alpha=2e-4, extra=2e-4, depth=2e-3,
                        grad_rel=REL_GOLDEN),
               card=smi)
    emit(rec)
    ok = (not any(small.values()) and int(out_k.n_dropped_rect) == 0
          and err["rgb"] <= 2e-4 and err["alpha"] <= 2e-4
          and err["extra"] <= 2e-4 and err["depth"] <= 2e-3
          and max(grad_err.values()) <= REL_GOLDEN)
    if not ok:
        raise AssertionError(f"the tiled path disagrees with the kernel "
                             f"path: {rec}")
    return rec


# The Feature-3DGS trainer's path: the bench training layout's 4 cameras at
# 640x360 as a COLMAP model of the bench scene's 200,000 points, into a
# GaussianModel of SH degree 3 with 32 semantic channels: value rows
# 3 + 32 + depth + 1 = 37, padded to CV 40.
FEAT_SH = 3
FEAT_DIM = 32
FEAT_CV = 40
FEAT_HW = (25, 45)          # ViT-S/14's patch grid of a 360x640 frame
FEAT_PATCH = 14
FEAT_VIT_DIM = 384          # ViT-S/14's token width: the decoder's target
FEAT_CROP = 224
FEAT_STEPS = 30
FEAT_DEC_STEPS = 10
FEAT_SCHEDULE = dict(densify_from=10, densify_every=10, densify_until=25,
                     opacity_reset_every=25, sh_increase_every=10)
FEAT_RESET_AT = 25          # the trainer resets only up to densify_until
FEAT_RESET_OPACITY = 0.01
# The ego trainer's path: 3 timesteps, an ego camera of 2 frames per
# timestep (its GT turned by -90 degrees, a triangular mask) and the 4
# bench cameras as the static rig; every step renders the ego frame and
# the 4 static views.
EGO_T = 3
EGO_FRAMES = 2
EGO_CAM_ID = 4              # the fifth colour-correction slot of the table
EGO_STEPS = 30
EGO_STEPS_LATER = 10
EGO_RENDERS = 1 + TRAIN_CAMS
EGO_LOSSES = ("loss", "loss_im", "loss_stat_im", "loss_depth")


def write_colmap_model(root, cams, points, colors):
    """A COLMAP binary model under root/sparse/0: one PINHOLE camera (the
    bench intrinsics), one image `view{i}.png` per camera of `cams`, and
    the points with their 8-bit colours and empty tracks."""
    import struct
    from dynamic3dgaussians_tpu_torch.utils.pose_utils import \
        quat_from_matrix
    d = os.path.join(root, "sparse", "0")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, W, H))
        fh.write(struct.pack("<dddd", F, F, W / 2, H / 2))
    with open(os.path.join(d, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            w2c = cam.w2c.cpu().numpy().astype(np.float64)
            fh.write(struct.pack("<idddddddi", i + 1,
                                 *quat_from_matrix(w2c[:3, :3]),
                                 *w2c[:3, 3], 1))
            fh.write(f"view{i}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    rec = np.zeros(len(points), dtype=[
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track_len", "<u8")])
    rec["id"] = np.arange(1, len(points) + 1)
    rec["xyz"] = points
    rec["rgb"] = np.clip(np.round(colors * 255.0), 0, 255)
    with open(os.path.join(d, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))
        fh.write(rec.tobytes())


def patch_extract_fn(seed=0):
    """A fixed stand-in for ViT-S/14 (no weights ship): per 14x14 patch,
    the mean colour and its square through a seeded (6, 384) random
    projection and tanh."""
    proj = np.random.RandomState(seed).normal(
        size=(6, FEAT_VIT_DIM)).astype(np.float32)

    def extract(crop):
        gh, gw = crop.shape[0] // FEAT_PATCH, crop.shape[1] // FEAT_PATCH
        m = crop[:gh * FEAT_PATCH, :gw * FEAT_PATCH].reshape(
            gh, FEAT_PATCH, gw, FEAT_PATCH, 3).mean((1, 3))
        return np.tanh(np.concatenate([m, m * m], -1) @ proj)
    return extract


@contextlib.contextmanager
def recording_steps(module, log):
    """`module.make_feature_train_step` for the length of the block, its
    step appending, after a synchronize, the time and the scalar terms of
    every iteration to `log`."""
    import torch
    make = module.make_feature_train_step

    def wrapped(*a, **k):
        step = make(*a, **k)

        def rec(*args):
            out = step(*args)
            torch.cuda.synchronize()
            log.append(dict(it=len(log) + 1, time=time.perf_counter(),
                            loss=float(out[0]),
                            **{n: float(v) for n, v in out[1].items()
                               if v.dim() == 0}))
            return out
        return rec
    module.make_feature_train_step = wrapped
    try:
        yield
    finally:
        module.make_feature_train_step = make


def view_losses(args, frames, rcfg, device):
    """The mean over `frames` of the image L1 and the feature L1 (the
    rendered features resized to the GT map) of one render each from the
    render inputs `args`."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train.trainer import resize_feature_map
    l1, fl1 = [], []
    with torch.no_grad():
        for fr in frames:
            out = render(fr["camera"], **args, config=rcfg, device=device)
            l1.append(float(torch.mean(torch.abs(
                torch.clamp(out.rgb, 0, 1) - fr["im"]))))
            gt = fr["gt_feature"]
            fmap = resize_feature_map(out.extra, gt.shape[:2])
            fl1.append(float(torch.mean(torch.abs(fmap - gt))))
    return dict(l1=float(np.mean(l1)), feature_l1=float(np.mean(fl1)))


def step_times(log):
    """ms between consecutive step reports (each read after a
    synchronize): every step but the first."""
    return [(b["it"], (b["time"] - a["time"]) * 1e3)
            for a, b in zip(log, log[1:])]


def model_records(model, cam, k):
    """The record table K1 and K2 see for one render of `model` at `cam`
    (the render's projection, SH colour, semantic channels and opacity),
    with K = `k` emission slots."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.sh import sh_to_color
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import \
        sorted_records
    a = model.render_args()
    with torch.no_grad():
        proj = project(a["means3d"], a["scales"], a["rotations"], cam)
        colors = sh_to_color(a["sh_degree"], a["sh"], a["means3d"],
                             cam.cam_center)
        op = torch.where(proj.valid, a["opacity"],
                         torch.zeros_like(a["opacity"]))
        chans = torch.cat([colors, a["extra_channels"]], dim=-1)
        rec_t, starts, counts, _ = sorted_records(
            H, W, proj, chans, op, max_tiles_per_gaussian=k)
    kw = dict(num_tiles=starts.shape[0], grid_w=-(-W // TILE), tile_h=TILE,
              tile_w=TILE, chunk=CHUNK)
    return rec_t, starts, counts, chans.shape[1], kw


def render_vs_plain(model, cam, rcfg, device):
    """One render of `model` through the kernels (method "cuda") and
    through their plain versions ("torch"): the image rows apart, and the
    gradients of a seeded cotangent w.r.t. every render input, relative to
    max(|g|, 1), beside each input's largest |g|."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    a = model.render_args()
    keys = ("means3d", "opacity", "scales", "rotations", "sh",
            "extra_channels")
    rng = np.random.RandomState(13)
    ct = {name: torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                device=device)
          for name, shape in (("rgb", (H, W, 3)), ("extra", (H, W, FEAT_DIM)),
                              ("depth", (H, W)), ("alpha", (H, W)))}

    def run(method):
        leaves = {k: a[k].detach().clone().requires_grad_(True)
                  for k in keys}
        out = render(cam, leaves["means3d"], torch.zeros_like(a["means3d"]),
                     leaves["opacity"], leaves["scales"], leaves["rotations"],
                     sh=leaves["sh"], sh_degree=a["sh_degree"],
                     extra_channels=leaves["extra_channels"], config=rcfg,
                     method=method, device=device)
        loss = sum(torch.sum(getattr(out, n) * c) for n, c in ct.items())
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return out, dict(zip(keys, grads))

    out_k, g_k = run("cuda")
    out_p, g_p = run("torch")
    err = {n: float((getattr(out_k, n) - getattr(out_p, n)).detach().abs()
                    .max()) for n in ct}
    grad_err = {k: float(((g_k[k] - g_p[k]).abs()
                          / g_p[k].abs().clamp(min=1.0)).max())
                for k in keys}
    grad_max = {k: float(g_p[k].abs().max()) for k in keys}
    ok = (max(err["rgb"], err["extra"], err["alpha"]) <= ATOL_CHAN
          and err["depth"] <= ATOL_DEPTH
          and max(grad_err.values()) <= REL_RENDER_GRAD
          and all(bool(torch.isfinite(g).all()) for g in g_k.values()))
    return dict(err=err, grad_rel_err=grad_err, grad_abs_max=grad_max,
                tol=dict(chan=ATOL_CHAN, depth=ATOL_DEPTH,
                         grad_rel=REL_RENDER_GRAD), ok=ok)


def phase_feature_main_path(scene, device, smi, tmp):
    """The Feature-3DGS trainer at full width: the bench scene's 200,000
    points and the 4 bench cameras written as a COLMAP model and read by
    `scene_from_colmap` into GaussianModel(sh_degree=3, semantic_dim=32)
    (800,768 rows), the port's renders of the bench scene as the images,
    32-channel GT feature maps at 25x45 from `data/features.py` (the
    multi-crop pyramid and the global PCA over `patch_extract_fn`), then
    `training` for 30 iterations (densify at 10 and 20, an opacity reset
    at 25, the SH degree up every 10), then 10 with the decoder up to
    384 channels. K1 and K2 are counted over each run and must launch once
    per iteration; the reset must run once, at 25, and leave no live
    opacity above 0.01. The image and feature L1 over the 4 views must fall
    from the initial model to the model just before the reset. Then one
    render of the trained model: its drop
    counters, its record table (CV 40) through K1 and K2 against their
    plain versions, and the render's image and gradients through the
    kernels against the plain path; `Scene.save` and a reload (means3D
    bitwise) and capture / restore (bitwise)."""
    import warnings

    import torch
    from dynamic3dgaussians_tpu_torch.data import features as FE
    from dynamic3dgaussians_tpu_torch.data.synthetic import (init_point_cloud,
                                                             make_dataset)
    from dynamic3dgaussians_tpu_torch.models.gaussian_model import \
        GaussianModel
    from dynamic3dgaussians_tpu_torch.models.scene import (Scene,
                                                           scene_from_colmap)
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    from dynamic3dgaussians_tpu_torch.train import feature_trainer as FT

    t0 = time.perf_counter()
    gt = bench_gt(scene)
    ds, _, cams = make_dataset(gt, num_t=1, num_cams=TRAIN_CAMS, w=W, h=H,
                               f=F, radius=TRAIN_RADIUS, device=device)
    cloud = init_point_cloud(gt)
    root = os.path.join(tmp, "feature")
    write_colmap_model(root, cams, cloud[:, :3], cloud[:, 3:6])
    model = GaussianModel(sh_degree=FEAT_SH, semantic_dim=FEAT_DIM,
                          device=device)
    sc = scene_from_colmap(root, model, model_path=os.path.join(root, "out"))
    frames = sc.getTrainCameras()
    views = [int(fr["name"][len("view"):-len(".png")]) for fr in frames]
    hosts = [ds[0][v]["im"].cpu().numpy() for v in views]
    extract = patch_extract_fn()
    feat_dir = os.path.join(root, "features")
    FE.extract_sequence(hosts, extract, feat_dir, out_dim=FEAT_DIM,
                        crop_sizes=(FEAT_CROP,), out_hw=FEAT_HW)
    wide = [FE.blend_feature_pyramid(h, extract, (FEAT_CROP,),
                                     out_hw=FEAT_HW) for h in hosts]
    for i, (fr, v) in enumerate(zip(frames, views)):
        fr["im"] = ds[0][v]["im"]
        fr["gt_feature"] = torch.as_tensor(FE.load_feature_map(feat_dir, i),
                                           device=device)
    model.training_setup()
    setup_s = time.perf_counter() - t0
    rcfg = RasterConfig()

    def snapshot():
        return {k: (v.detach().clone() if torch.is_tensor(v) else v)
                for k, v in model.render_args().items()}

    resets, before_reset, log = [], [], []
    reset = model.reset_opacity

    def counted_reset():
        # the renders of the views run after the run, outside its count
        before_reset.append(snapshot())
        reset()
        op = torch.sigmoid(model.params["logit_opacities"][:, 0])
        resets.append(dict(it=len(log), max_live_opacity=float(
            op[model.alive].max())))
    model.reset_opacity = counted_reset

    def run(run_frames, steps, **kw):
        log.clear()
        zero_launches()
        with recording_steps(FT, log):
            _, dec = FT.training(run_frames, model, iterations=steps,
                                 rcfg=rcfg, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
        ms = step_times(log)
        first, last = log[0], log[-1]
        return dec, dict(
            steps=steps, launches=launches, step_ms=ms,
            step_ms_median=float(np.median([x for _, x in ms])),
            first={k: first[k] for k in ("it", "loss", "l1",
                                         "feature_l1")},
            last={k: last[k] for k in ("it", "loss", "l1", "feature_l1")},
            n_points=model.num_points,
            active_sh_degree=model.active_sh_degree)

    n0 = model.num_points
    views_initial = view_losses(snapshot(), frames, rcfg, device)
    _, run1 = run(frames, FEAT_STEPS, **FEAT_SCHEDULE)
    views = dict(initial=views_initial,
                 before_reset=[view_losses(a, frames, rcfg, device)
                               for a in before_reset],
                 after_run=view_losses(snapshot(), frames, rcfg, device))
    del before_reset[:]
    dec_frames = [dict(fr, gt_feature=torch.as_tensor(wide[i],
                                                      device=device))
                  for i, fr in enumerate(frames)]
    dec, run2 = run(dec_frames, FEAT_DEC_STEPS, gt_feature_dim=FEAT_VIT_DIM)

    cam = frames[0]["camera"]
    with torch.no_grad():
        out = render(cam, **model.render_args(), config=rcfg, device=device)
    drops = {c: int(getattr(out, c)) for c in (
        "n_dropped_rect", "n_dropped_capacity", "n_dropped_tile_overflow")}
    rec_t, starts, counts, n_chan, kw = model_records(
        model, cam, rcfg.max_tiles_per_gaussian)
    cv = rec_t.shape[0] - 8
    k1_errs, _ = k1_against_plain(rec_t, starts, counts, n_chan, kw)
    k2_errs, _ = k2_against_plain(rec_t, starts, counts, kw, device)
    del rec_t, starts, counts
    plain = render_vs_plain(model, cam, rcfg, device)

    n = model.num_points
    saved = sc.save(FEAT_STEPS + FEAT_DEC_STEPS)
    back = GaussianModel(sh_degree=FEAT_SH, semantic_dim=FEAT_DIM,
                         device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the splat PLY holds DC only
        Scene(back, model_path=sc.model_path, load_iteration=-1)
    ply_bitwise = bool(torch.equal(back.params["means3D"][:n],
                                   model.params["means3D"][:n]))
    state = model.capture()
    again = GaussianModel(sh_degree=FEAT_SH, semantic_dim=FEAT_DIM,
                          device=device).restore(state)
    tables = (("params", model.params, again.params),
              ("variables", model.variables, again.variables),
              ("opt_mu", model.opt_state.mu, again.opt_state.mu),
              ("opt_nu", model.opt_state.nu, again.opt_state.nu))
    capture_bitwise = all(torch.equal(x[k], y[k]) for _, x, y in tables
                          for k in x)
    rec = dict(phase="feature_main_path", card=smi, w=W, h=H,
               cameras=len(frames), n_points_initial=n0,
               capacity=int(model.alive.shape[0]), sh_degree=FEAT_SH,
               semantic_dim=FEAT_DIM, gt_feature_hw=list(FEAT_HW), cv=cv,
               setup_s=setup_s, runs=[run1, run2], resets=resets,
               views_l1=views,
               launches={k: run1["launches"][k] + run2["launches"][k]
                         for k in run1["launches"]},
               decoder_shape=[list(dec.w1.shape), list(dec.w2.shape)],
               drops_trained_render=drops, k1_vs_plain=k1_errs,
               k2_vs_plain=k2_errs, render_vs_plain=plain,
               ply_dir=os.path.relpath(saved, tmp), ply_rows=n,
               ply_dead_rows=int((~model.alive[:n]).sum()),
               ply_means3d_bitwise=ply_bitwise,
               capture_restore_bitwise=capture_bitwise)
    emit(rec)
    for r in (run1, run2):
        want = dict(raster_fwd=r["steps"], raster_bwd=r["steps"],
                    sol_probe=0)
        if r["launches"] != want:
            raise AssertionError(f"the feature trainer launched "
                                 f"{r['launches']} in {r['steps']} steps")
    if ([r["it"] for r in resets] != [FEAT_RESET_AT]
            or resets[0]["max_live_opacity"] > FEAT_RESET_OPACITY * 1.0001):
        raise AssertionError(f"opacity resets {resets}")
    for key in ("l1", "feature_l1"):
        if not views["before_reset"][0][key] < views["initial"][key]:
            raise AssertionError(f"{key} over the views did not fall: "
                                 f"{views}")
    if cv != FEAT_CV or run1["active_sh_degree"] != FEAT_SH:
        raise AssertionError(f"CV {cv}, SH degree {model.active_sh_degree}")
    if not (k1_errs["ok"] and k2_errs["ok"] and plain["ok"]):
        raise AssertionError(f"the kernels disagree with their plain "
                             f"versions on the trained model: {rec}")
    if not (ply_bitwise and capture_bitwise):
        raise AssertionError(f"save / reload or capture / restore: {rec}")
    return rec


def triangular_mask(h, w, device):
    """(h, w) {0, 1}: 1 but for the bottom-right triangle of half the
    height and width (the rig's corner, masked out of the ego loss)."""
    import torch
    y = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
    x = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
    return ((y[:, None] + x[None, :]) <= 1.5).to(torch.float32)


def gt_views(gt, cams, t, device, num_t=EGO_T):
    """The ground truth of timestep t of `num_t` seen by `cams`: the image
    and the depth (un-premultiplied where alpha > 0.5, else 0)."""
    import torch
    from dynamic3dgaussians_tpu_torch.data.synthetic import animate
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    means = torch.as_tensor(animate(gt, t, num_t), device=device)
    fixed = [torch.as_tensor(gt[k], device=device)
             for k in ("colors", "opac", "scales", "quats")]
    views = []
    with torch.no_grad():
        for cam in cams:
            out = render(cam, means, *fixed,
                         config=RasterConfig(max_tiles_per_gaussian=64),
                         device=device)
            depth = torch.where(out.alpha > 0.5, out.depth /
                                out.alpha.clamp(min=1e-6),
                                torch.zeros_like(out.depth))
            views.append((torch.clamp(out.rgb, 0.0, 1.0), depth))
    return views


def phase_ego_main_path(scene, device, smi):
    """The ego + static trainer at full width: `train_ego` over 3 timesteps
    of the bench scene (its foreground moving), an ego camera of 2 frames
    per timestep moving in from radius 5 to 4 (GT turned by -90 degrees,
    `rot90_ego=True`, the triangular mask), the 4 bench cameras as the
    static rig with GT depth from the port's render; 30 steps at t = 0
    (densify at 10 and 20) and 10 at each later one. K1 and K2 must launch
    5 times per step (the ego render and the 4 static ones). Reports the
    step times per timestep, the loss terms and the static views' PSNR
    before and after each timestep (it must rise at t = 0)."""
    import torch
    from dynamic3dgaussians_tpu_torch.convert import params_from_jax
    from dynamic3dgaussians_tpu_torch.data.synthetic import init_point_cloud
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    from dynamic3dgaussians_tpu_torch.train.ego_trainer import train_ego
    from dynamic3dgaussians_tpu_torch.viz.live_viewer import orbit_camera

    t0 = time.perf_counter()
    gt = bench_gt(scene)
    stat_cams = orbit_cameras(center=(0.0, 0.0, 0.0), radius=TRAIN_RADIUS,
                              height=-1.0, n=TRAIN_CAMS, w=W, h=H, f=F,
                              device=device)
    n_ego = EGO_T * EGO_FRAMES
    ego_cams = [orbit_camera([0.0, 0.0, 0.0], az=0.4 + 0.1 * j, el=0.15,
                             radius=5.0 - j / (n_ego - 1), w=W, h=H, f=F,
                             device=device) for j in range(n_ego)]
    mask = triangular_mask(W, H, device)      # in the turned frame
    ego_ds, stat_ds = [], []
    for t in range(EGO_T):
        stat_ds.append([dict(camera=cam, im=im, gt_depth=depth, cam_id=c)
                        for c, (cam, (im, depth)) in enumerate(zip(
                            stat_cams, gt_views(gt, stat_cams, t, device)))])
        cams_t = ego_cams[t * EGO_FRAMES:(t + 1) * EGO_FRAMES]
        ego_ds.append([dict(camera=cam, im=torch.rot90(im, k=-1, dims=(0, 1)),
                            mask=mask, cam_id=EGO_CAM_ID)
                       for cam, (im, _) in zip(cams_t, gt_views(
                           gt, cams_t, t, device))])
    pt = init_point_cloud(gt)
    w2c = np.stack([c.w2c.cpu().numpy() for c in stat_cams])
    cfg = TrainConfig(num_timesteps=EGO_T, iters_first_timestep=EGO_STEPS,
                      iters_per_timestep=EGO_STEPS_LATER, densify_start=10,
                      densify_every=10, report_every=1)
    setup_s = time.perf_counter() - t0
    log, densify = [], []

    def on_step(t, i, m):
        torch.cuda.synchronize()
        log.append(dict(t=t, it=i, time=time.perf_counter(),
                        **{k: float(v) for k, v in m.items()}))

    zero_launches()
    t0 = time.perf_counter()
    out, _, _ = train_ego(
        ego_ds, stat_ds, cfg, pt, w2c, rot90_ego=True, device=device,
        callbacks={"on_step": on_step, "on_densify": lambda t, i, s:
                   densify.append(dict(i=i, **{k: int(v) for k, v in
                                               s._asdict().items()}))})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()

    p0, v0 = G.init_params(pt, w2c, device=device)
    per_t = []
    for t in range(EGO_T):
        if t == 0:
            before, cut_b = views_psnr(p0, v0["alive"], stat_ds[t], device)
        else:
            before, cut_b = views_psnr(params_from_jax(
                {**out[0], **out[t - 1]}, device), None, stat_ds[t], device)
        after, cut_a = views_psnr(params_from_jax({**out[0], **out[t]},
                                                  device), None,
                                  stat_ds[t], device)
        rows = [r for r in log if r["t"] == t]
        ms = step_times(rows)
        per_t.append(dict(
            t=t, steps=len(rows), step_ms=ms,
            step_ms_median=float(np.median([x for _, x in ms])),
            losses_first={k: v for k, v in rows[0].items()
                          if k.startswith("loss")},
            losses_last={k: v for k, v in rows[-1].items()
                         if k.startswith("loss")},
            views_psnr_before=before, views_psnr_after=after,
            views_psnr_mean_before=float(np.mean(before)),
            views_psnr_mean_after=float(np.mean(after)),
            views_psnr_cut_rects=[cut_b, cut_a]))
    total = len(log)
    rec = dict(phase="ego_main_path", card=smi, w=W, h=H,
               ego_frames_per_t=EGO_FRAMES, static_cameras=TRAIN_CAMS,
               n_gaussians=int(pt.shape[0]), setup_s=setup_s, run_s=run_s,
               steps=total, launches=launches,
               launches_per_step={k: v / total for k, v in launches.items()},
               densify=densify, n_out=int(out[0]["means3D"].shape[0]),
               timesteps=per_t)
    emit(rec)
    want_steps = EGO_STEPS + (EGO_T - 1) * EGO_STEPS_LATER
    want = dict(raster_fwd=EGO_RENDERS * want_steps,
                raster_bwd=EGO_RENDERS * want_steps, sol_probe=0)
    if total != want_steps or launches != want:
        raise AssertionError(f"train_ego launched {launches} in {total} "
                             f"steps; expected {want}")
    for ts in per_t:
        keys = list(EGO_LOSSES) + ([f"loss_{k}" for k in PHYSICS]
                                   if ts["t"] else [])
        rows = [r for r in log if r["t"] == ts["t"]]
        if not all(k in r and np.isfinite(r[k]) for r in rows for k in keys):
            raise AssertionError(f"t = {ts['t']}: loss terms {keys} per "
                                 f"step: {ts}")
        if any(ts["views_psnr_cut_rects"]):
            raise AssertionError(f"t = {ts['t']}: {ts}")
    if not (per_t[0]["views_psnr_mean_after"]
            > per_t[0]["views_psnr_mean_before"]):
        raise AssertionError(f"t = 0: the static views' PSNR did not rise: "
                             f"{per_t[0]}")
    if [d["i"] for d in densify] != [10, 20]:
        raise AssertionError(f"densify at {densify}")
    return rec


MOTION_T = 6
MOTION_BASES = 10
MOTION_STEPS = 40                 # run 1, the k-means init
MOTION_TRACK_STEPS = 20           # run 2, the Procrustes init
MOTION_WINDOW = dict(window_step=3, window=6, iters_per_window=10)
MOTION_WINDOW_STEPS = 20          # anchors 5 and 2
MOTION_REPORT_EVERY = 5
MOTION_TRACKS = 2048
MOTION_QUERIES = (0, 3)
MOTION_DEPTH_STRIDE = 8
MOTION_PSNR_FRAMES = (0, MOTION_T - 1)
# A basis of the Procrustes init replays noise-free rigid tracks up to the
# float32 rounding of the SVD and of sums over ~200 tracks at |x| <= 3.5,
# ~1e-5 world units; 1e-3 leaves that two orders of magnitude and still
# catches a wrong turn (0.001 rad moves a point 3 units out by 3e-3). The
# whole foreground moves as one rigid body, so every basis must replay
# every track: the gate holds the solve, and cannot tell a right cluster
# assignment from a wrong one.
PROCRUSTES_TOL = 1e-3
# the tracker's occlusion flag, stood in for: a track point more than 2 %
# behind the rendered depth at its pixel (or where nothing opaque is
# rendered) is occluded
TRACK_OCC_MARGIN = 1.02


@contextlib.contextmanager
def recording_motion_steps(log, n_pixels):
    """`motion_trainer.make_motion_step` for the length of the block, its
    step appending, after a synchronize, the time, frame, loss and PSNR of
    every step to `log`; yields (a `Throughput` counting the steps' rays
    and gaussians from the start of the first step, the motion bases the
    first step was given)."""
    import torch
    from dynamic3dgaussians_tpu_torch.train import motion_trainer as TM
    from dynamic3dgaussians_tpu_torch.utils.logging import Throughput
    make = TM.make_motion_step
    tput = Throughput()
    start = {}

    def wrapped(*a, **k):
        step = make(*a, **k)

        def rec(params, opt_state, variables, batch, t, lrs):
            if not log:
                start.update(rots=params["motion_rots"].clone(),
                             transls=params["motion_transls"].clone())
                tput.reset()
            out = step(params, opt_state, variables, batch, t, lrs)
            torch.cuda.synchronize()
            log.append(dict(it=len(log) + 1, time=time.perf_counter(),
                            t=int(t), loss=float(out[2]["loss"]),
                            psnr=float(out[2]["psnr"])))
            tput.update(n_pixels, int(variables["alive"].sum()))
            return out
        return rec
    TM.make_motion_step = wrapped
    try:
        yield tput, start
    finally:
        TM.make_motion_step = make


def motion_render_args(params, variables, t):
    """Render inputs of the gaussians posed at frame t."""
    import torch
    from dynamic3dgaussians_tpu_torch.train.motion_trainer import \
        posed_gaussians
    posed = posed_gaussians(params, t)
    op = torch.sigmoid(params["logit_opacities"][:, 0])
    return (posed["means3D"], params["rgb_colors"],
            torch.where(variables["alive"], op, torch.zeros_like(op)),
            torch.exp(params["log_scales"]), posed["rotations"])


def motion_views_psnr(params, variables, dataset, device):
    """PSNR of the 4 views at the frames MOTION_PSNR_FRAMES, the gaussians
    posed there and rendered as the motion step renders them (K = 8)."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train import losses as L
    out_psnr = []
    with torch.no_grad():
        for t in MOTION_PSNR_FRAMES:
            args = motion_render_args(params, variables, t)
            for fr in dataset[t]:
                out = render(fr["camera"], *args, device=device)
                out_psnr.append(float(L.psnr(torch.clamp(out.rgb, 0, 1),
                                             fr["im"])))
    return out_psnr


def lifted_tracks(gt_tracks, cam, depths, tmp):
    """The tracks of `gt_tracks` (N, T, 3) as a 2D tracker exports them
    for camera `cam` -- `{query}_{target}.npy` of (N, 4) [x, y, occ, err]
    for the query frames MOTION_QUERIES, occ from the rendered depth at
    the track's pixel -- lifted back by `tracks_from_sequence` over the
    depth renders `depths` (T, H, W). Returns the share of (track, frame)
    entries it finds visible and their median distance to the truth."""
    from dynamic3dgaussians_tpu_torch.data.tracks import tracks_from_sequence
    w2c = cam.w2c.cpu().numpy().astype(np.float64)
    k = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    names = [str(t) for t in range(MOTION_T)]
    tdir = os.path.join(tmp, "tracks")
    os.makedirs(tdir, exist_ok=True)
    for t in range(MOTION_T):
        pc = gt_tracks[:, t] @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        u = k[0, 0] * pc[:, 0] / z + k[0, 2]
        v = k[1, 1] * pc[:, 1] / z + k[1, 2]
        # the render's pixel j is centred at the pinhole coordinate j + 0.5
        col = np.clip(np.round(u - 0.5).astype(int), 0, W - 1)
        row = np.clip(np.round(v - 0.5).astype(int), 0, H - 1)
        surf = depths[t][row, col]
        occ = (surf <= 0) | (z > TRACK_OCC_MARGIN * surf)
        arr = np.stack([u, v, occ.astype(np.float64), np.zeros_like(u)],
                       -1).astype(np.float32)
        for q in MOTION_QUERIES:
            np.save(os.path.join(tdir, f"{q}_{t}.npy"), arr)
    c2ws = np.repeat(np.linalg.inv(w2c)[None], MOTION_T, 0).astype(np.float32)
    t3d, vis, _ = tracks_from_sequence(
        tdir, names, depths, k.astype(np.float32), c2ws,
        query_stride=MOTION_QUERIES[1] - MOTION_QUERIES[0])
    truth = np.concatenate([gt_tracks] * len(MOTION_QUERIES))
    err = np.linalg.norm(t3d - truth, axis=-1)
    return dict(n=int(t3d.shape[0]), visible_share=float(vis.mean()),
                median_err=float(np.median(err[vis])) if vis.any() else None,
                occluded_share=float(1.0 - vis.mean()))


def procrustes_init_timed(gt_tracks, cfg, device, timers):
    """The Procrustes init on the tracks `gt_tracks` as `init_motion_state`
    runs it (a generator seeded with `cfg.seed`, canonical frame 0), timed
    by `phase_timer`; returns its bases."""
    import torch
    from dynamic3dgaussians_tpu_torch.models import motion_bases as MB
    from dynamic3dgaussians_tpu_torch.utils.logging import phase_timer
    tr = torch.as_tensor(gt_tracks, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    with phase_timer("procrustes", sync=tr, log=timers):
        bases, _, _ = MB.init_motion_params_with_procrustes(
            tr, MOTION_BASES, 0, gen)
        torch.cuda.synchronize()
    return bases


def basis_replay(bases, gt_tracks, device):
    """Each basis's transforms applied to the tracks' canonical (frame 0)
    points: the largest distance to the true tracks over the tracks and
    the frames, per basis."""
    import torch
    from dynamic3dgaussians_tpu_torch.device import no_tf32
    from dynamic3dgaussians_tpu_torch.ops.quat import cont_6d_to_rotmat
    tr = torch.as_tensor(gt_tracks, device=device)
    with no_tf32():
        R = cont_6d_to_rotmat(bases["rots"])                 # (K, F, 3, 3)
        pred = torch.einsum("kfij,nj->knfi", R, tr[:, 0]) \
            + bases["transls"][:, None]
    err = torch.linalg.vector_norm(pred - tr[None], dim=-1)
    return [float(e) for e in err.amax(dim=(1, 2))]


def motion_records(params, variables, t, cam, k):
    """The record table K1 and K2 see in a motion step at frame t: the
    gaussians posed there, RGB and the seg channels, opacity gated by
    `alive` and the projection (as `motion_loss` renders them), with K =
    `k` emission slots."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import \
        sorted_records
    with torch.no_grad():
        means, rgb, op, scales, rots = motion_render_args(params,
                                                          variables, t)
        proj = project(means, scales, rots, cam)
        op = torch.where(proj.valid, op, torch.zeros_like(op))
        chans = torch.cat([rgb, params["seg_colors"]], dim=-1)
        rec_t, starts, counts, _ = sorted_records(
            H, W, proj, chans, op, max_tiles_per_gaussian=k)
    kw = dict(num_tiles=starts.shape[0], grid_w=-(-W // TILE), tile_h=TILE,
              tile_w=TILE, chunk=CHUNK)
    return rec_t, starts, counts, chans.shape[1], kw


def motion_step_vs_plain(params, variables, batch, t, device):
    """One motion step's loss and gradients (every group, the motion
    bases included, before the dead-row gate) through the kernels and
    through their plain versions, on the card: the loss and each group's
    gradients relative to max(|plain|, 1) and relative to the group's own
    largest |plain| (most groups' gradients are far below 1), each
    group's largest |g|, and the largest |g| over the capacity-padding
    rows."""
    import torch
    from dynamic3dgaussians_tpu_torch.train import motion_trainer as TM
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    from dynamic3dgaussians_tpu_torch.train.trainer import raster_config

    def run(method):
        cfg = TrainConfig(raster=RasterSettings(method=method))
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = TM.motion_loss(leaves, batch, variables, t, cfg=cfg,
                                 rcfg=raster_config(cfg))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return float(loss.detach()), {k: (torch.zeros_like(leaves[k])
                                          if g is None
                                 else g) for k, g in zip(leaves, grads)}

    lk, gk = run("cuda")
    lp, gp = run("torch")
    dead = ~variables["alive"]
    rel = {k: float(((gk[k] - gp[k]).abs() / gp[k].abs().clamp(min=1.0))
                    .max()) for k in gk}
    # a group the loss does not reach is zero in both: 0 apart
    rel_group = {k: float((gk[k] - gp[k]).abs().max()
                          / gp[k].abs().max().clamp(min=1e-30)) for k in gk}
    pad = {k: float(gk[k][dead].abs().max()) for k in gk
           if gk[k].shape[:1] == dead.shape and gk[k].dim() >= 1}
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    loss_rel = abs(lk - lp) / max(abs(lp), 1.0)
    ok = finite and loss_rel <= REL_RENDER_GRAD and \
        max(rel.values()) <= REL_RENDER_GRAD and \
        max(rel_group.values()) <= REL_RENDER_GRAD
    return dict(loss=lk, loss_plain=lp, loss_rel_err=loss_rel,
                grad_rel_err=rel, grad_rel_to_group_max=rel_group,
                grad_abs_max={k: float(g.abs().max()) for k, g in gp.items()},
                padding_rows_grad_abs_max=pad, finite=finite,
                tol=REL_RENDER_GRAD, ok=ok)


def flow_vs_plain(params, variables, gt, cam, device):
    """`render_flow` from frame 0 to 1 of the trained gaussians through the
    kernels (launches counted) and through their plain versions, and the
    ground truth's flow (the bench scene's rigid motion, rendered the same
    way): the alpha-weighted flows apart (the composited channels), the
    flows apart where alpha > 0.5, and the trained flow's mean error in
    pixels against the truth where both are covered."""
    import torch
    from dynamic3dgaussians_tpu_torch.data.synthetic import animate
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train.flow import render_flow
    with torch.no_grad():
        a0 = motion_render_args(params, variables, 0)
        a1 = motion_render_args(params, variables, 1)
        zero_launches()
        flow_k = render_flow(cam, a0[0], a1[0], *a0[1:], device=device)
        torch.cuda.synchronize()
        launches = read_launches()
        flow_p = render_flow(cam, a0[0], a1[0], *a0[1:], method="torch",
                             device=device)
        alpha = render(cam, *a0, device=device).alpha
        fixed = [torch.as_tensor(gt[k], device=device)
                 for k in ("colors", "opac", "scales", "quats")]
        g0 = torch.as_tensor(animate(gt, 0, MOTION_T), device=device)
        g1 = torch.as_tensor(animate(gt, 1, MOTION_T), device=device)
        flow_gt = render_flow(cam, g0, g1, *fixed, device=device)
        alpha_gt = render(cam, g0, *fixed, device=device).alpha
    cov = alpha > 0.5
    span = 1.0 + float(flow_p[cov].abs().max())
    err_w = float(((flow_k - flow_p) * alpha[..., None]).abs().max())
    err_cov = float((flow_k - flow_p)[cov].abs().max())
    both = cov & (alpha_gt > 0.5)
    gt_err = torch.linalg.vector_norm(flow_k - flow_gt, dim=-1)[both]
    tol = ATOL_CHAN * span
    return dict(launches=launches, covered_share=float(cov.float().mean()),
                flow_span_px=span - 1.0, err_alpha_weighted=err_w,
                err_covered=err_cov, tol_alpha_weighted=tol,
                tol_covered=2 * tol,
                gt_mean_err_px=float(gt_err.mean()),
                gt_mean_flow_px=float(torch.linalg.vector_norm(
                    flow_gt, dim=-1)[both].mean()),
                finite=bool(torch.isfinite(flow_k).all()),
                ok=err_w <= tol and err_cov <= 2 * tol)


def phase_motion_main_path(scene, device, smi, tmp):
    """The motion-basis trainer at full width: the bench scene's foreground
    moving rigidly over a 6-frame layout of the 4 bench cameras at 640x360
    (`make_dataset`, the orbit of `train_bench`); the init cloud
    `build_init_cloud("fused")` of the bench cloud and the 4 cameras' K1
    depth renders at frame 0 (stride 8), cut to 200,000 points (200,704
    rows); 10 bases. Three runs: `train_motion` from the k-means init (40
    steps), from the Procrustes init on 2,048 foreground points' true
    tracks (20 steps), and `train_motion_windowed` (windows of 6 frames
    every 3, 10 steps each: 20 steps). K1 and K2 must launch once per
    step. Then `render_flow` from frame 0 to 1 of run 1's gaussians (one
    K1 launch) against the plain path and the true flow. Also the same
    tracks as camera 0's 2D tracks for query frames 0 and 3, lifted by
    `tracks_from_sequence` over camera 0's K1 depth renders, and over
    depth renders of the tracked points alone (reported).
    Gates: the launch counts, background rows pinned, the views' PSNR
    rising over run 1, each basis run 2 starts from replaying the true
    motion within PROCRUSTES_TOL, K1 and K2 against their plain versions
    on the trained gaussians' record table at frame 0, a step's loss and
    gradients and `render_flow` through the kernels against the plain
    path, and finite parameters."""
    import torch
    from dynamic3dgaussians_tpu_torch.data.init_clouds import \
        build_init_cloud
    from dynamic3dgaussians_tpu_torch.data.synthetic import (
        animate, init_point_cloud, make_dataset)
    from dynamic3dgaussians_tpu_torch.models import motion_bases as MB
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train import motion_trainer as TM
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    from dynamic3dgaussians_tpu_torch.train.trainer import raster_config
    from dynamic3dgaussians_tpu_torch.utils.logging import phase_timer

    t0 = time.perf_counter()
    gt = bench_gt(scene)
    dataset, w2c, cams = make_dataset(gt, num_t=MOTION_T,
                                      num_cams=TRAIN_CAMS, w=W, h=H, f=F,
                                      radius=TRAIN_RADIUS, device=device)
    views0 = gt_views(gt, cams, 0, device, num_t=MOTION_T)
    k_mat = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    depth_frames = dict(
        depths=[d.cpu().numpy() for _, d in views0],
        rgbs=[im.cpu().numpy() for im, _ in views0],
        ks=[k_mat] * TRAIN_CAMS, w2cs=list(w2c),
        segs=[(fr["seg"][..., 0] > 0.5).float().cpu().numpy()
              for fr in dataset[0]],
        stride=MOTION_DEPTH_STRIDE)
    bench_cloud = init_point_cloud(gt)
    pt = build_init_cloud("fused", pt_cld=bench_cloud,
                          depth_frames=depth_frames, max_points=N_GAUSS,
                          seed=0)
    n_depth_points = sum(int((d > 1e-6).sum()) for d in [
        x[::MOTION_DEPTH_STRIDE, ::MOTION_DEPTH_STRIDE]
        for x in depth_frames["depths"]])
    fg_idx = np.random.RandomState(0).choice(gt["n_fg"], MOTION_TRACKS,
                                             replace=False)
    gt_tracks = np.stack([animate(gt, t, MOTION_T)[fg_idx]
                          for t in range(MOTION_T)], 1).astype(np.float32)
    depths0 = np.stack([gt_views(gt, [cams[0]], t, device,
                                 num_t=MOTION_T)[0][1].cpu().numpy()
                        for t in range(MOTION_T)])
    # the same depth renders of the tracked points alone: the lifting's
    # error where no other splat blends into a track's pixel
    tracked = {k: v[fg_idx] if isinstance(v, np.ndarray) else v
               for k, v in gt.items()}
    tracked["n_fg"] = MOTION_TRACKS
    depths_own = np.stack([gt_views(tracked, [cams[0]], t, device,
                                    num_t=MOTION_T)[0][1].cpu().numpy()
                           for t in range(MOTION_T)])
    cfg = TrainConfig(report_every=MOTION_REPORT_EVERY, seed=0)
    setup_s = time.perf_counter() - t0

    timers = {}
    lifted = lifted_tracks(gt_tracks, cams[0], depths0, tmp)
    lifted_own = lifted_tracks(gt_tracks, cams[0], depths_own,
                               os.path.join(tmp, "own"))
    timed_bases = procrustes_init_timed(gt_tracks, cfg, device, timers)
    params0, vars0 = TM.init_motion_state(pt, w2c, cfg, MOTION_T,
                                          MOTION_BASES, device=device)
    pts = params0["means3D"][:pt.shape[0]]
    gen = torch.Generator(device=device).manual_seed(0)
    with phase_timer("kmeans", sync=pts, log=timers):
        MB.coefs_from_features(pts, MOTION_BASES, gen)
    with phase_timer("nearest_track_map", sync=pts, log=timers):
        TM.nearest_rows(pts, torch.as_tensor(gt_tracks[:, 0],
                                             device=device))
    psnr_init = motion_views_psnr(params0, vars0, dataset, device)

    runs, starts, finite = [], {}, True
    for name, fn, kw in (
            ("kmeans", TM.train_motion, dict(num_iters=MOTION_STEPS)),
            ("procrustes", TM.train_motion,
             dict(num_iters=MOTION_TRACK_STEPS, tracks_3d=gt_tracks)),
            ("windowed", TM.train_motion_windowed, MOTION_WINDOW)):
        log, reports = [], []
        zero_launches()
        with recording_motion_steps(log, W * H) as (tput, start):
            ts = time.perf_counter()
            params, variables = fn(
                dataset, cfg, pt, w2c, num_bases=MOTION_BASES,
                device=device, callbacks={"on_step": lambda a, i, m:
                                          reports.append(i)}, **kw)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - ts
        launches = read_launches()
        starts[name] = start
        ms = [x for _, x in step_times(log)]
        finite &= all(bool(torch.isfinite(v).all()) for v in params.values())
        runs.append(dict(name=name, steps=len(log), run_s=run_s,
                         launches=launches, reports=reports,
                         step_ms_median=float(np.median(ms)),
                         step_ms_min=float(np.min(ms)),
                         frames=[r["t"] for r in log],
                         loss_first=log[0]["loss"], loss_last=log[-1]["loss"],
                         psnr_first=log[0]["psnr"], psnr_last=log[-1]["psnr"],
                         **{k: v for k, v in tput.rates().items()}))
        if name == "kmeans":
            trained, trained_vars = params, variables
    psnr_after = motion_views_psnr(trained, trained_vars, dataset, device)

    bg = trained["label"] <= 0.5
    pinned = all(bool(torch.equal(
        TM.posed_gaussians(trained, t)["means3D"][bg],
        trained["means3D"][bg])) for t in MOTION_PSNR_FRAMES)
    cam = dataset[0][0]["camera"]
    alive = trained_vars["alive"]
    with torch.no_grad():
        args = motion_render_args(trained, trained_vars, 0)
        out = render(cam, *args, device=device)
        # the same render without the dead capacity rows: the live rows'
        # own rect drops, apart from the dead rows' phantom ones
        live = render(cam, *[a[alive] for a in args], device=device)
    drops = dict(n_dropped_rect=int(out.n_dropped_rect),
                 n_dropped_capacity=int(out.n_dropped_capacity),
                 n_dropped_tile_overflow=int(out.n_dropped_tile_overflow),
                 n_dropped_rect_live_rows=int(live.n_dropped_rect))
    # run 2's own initial bases (the one-body motion: every basis, every
    # track), and whether the timed solve gave the same bases
    init = starts["procrustes"]
    replay = basis_replay(init, gt_tracks, device)
    proc = dict(err_per_basis=replay, tol=PROCRUSTES_TOL,
                finite=all(bool(torch.isfinite(v).all())
                           for v in init.values()),
                timed_solve_bitwise=all(torch.equal(timed_bases[k], init[k])
                                        for k in init))
    del timed_bases
    rec_t, starts_t, counts, n_chan, kw = motion_records(
        trained, trained_vars, 0, cam,
        raster_config(cfg).max_tiles_per_gaussian)
    k1_errs, _ = k1_against_plain(rec_t, starts_t, counts, n_chan, kw)
    k2_errs, _ = k2_against_plain(rec_t, starts_t, counts, kw, device)
    table = dict(cv=rec_t.shape[0] - 8, n_pairs=int(counts.sum()),
                 ne_pad=rec_t.shape[1])
    del rec_t, starts_t, counts
    plain = motion_step_vs_plain(trained, trained_vars,
                                 dataset[MOTION_T - 1][1], MOTION_T - 1,
                                 device)
    flow = flow_vs_plain(trained, trained_vars, gt, cam, device)
    total = {k: sum(r["launches"][k] for r in runs) + flow["launches"][k]
             for k in runs[0]["launches"]}
    rec = dict(phase="motion_main_path", card=smi, w=W, h=H,
               frames=MOTION_T, cameras=TRAIN_CAMS, num_bases=MOTION_BASES,
               n_gaussians=int(pt.shape[0]),
               capacity=int(trained_vars["alive"].shape[0]),
               n_depth_points=n_depth_points, setup_s=setup_s,
               init_s=timers, runs=runs, launches=total,
               psnr_views_init=psnr_init, psnr_views_after=psnr_after,
               psnr_views_mean_init=float(np.mean(psnr_init)),
               psnr_views_mean_after=float(np.mean(psnr_after)),
               background_pinned=pinned, drops_trained_render=drops,
               procrustes=proc, lifted_tracks=lifted,
               lifted_tracks_own_depth=lifted_own, record_table=table,
               k1_vs_plain=k1_errs, k2_vs_plain=k2_errs,
               step_vs_plain=plain, flow=flow, finite=finite,
               phase_s=time.perf_counter() - t0)
    emit(rec)
    for r in runs:
        want = dict(raster_fwd=r["steps"], raster_bwd=r["steps"],
                    sol_probe=0)
        if r["launches"] != want:
            raise AssertionError(f"{r['name']}: launched {r['launches']} in "
                                 f"{r['steps']} steps")
    if [r["steps"] for r in runs] != [MOTION_STEPS, MOTION_TRACK_STEPS,
                                      MOTION_WINDOW_STEPS]:
        raise AssertionError(f"steps per run: {runs}")
    if flow["launches"] != dict(raster_fwd=1, raster_bwd=0, sol_probe=0):
        raise AssertionError(f"render_flow launched {flow['launches']}")
    if not pinned:
        raise AssertionError("posed_gaussians moved background rows")
    if not rec["psnr_views_mean_after"] > rec["psnr_views_mean_init"]:
        raise AssertionError(f"the views' PSNR did not rise: {psnr_init} -> "
                             f"{psnr_after}")
    if not (max(proc["err_per_basis"]) <= PROCRUSTES_TOL
            and proc["finite"]):
        raise AssertionError(f"run 2's Procrustes bases do not replay the "
                             f"true motion: {proc}")
    if not (k1_errs["ok"] and k2_errs["ok"]):
        raise AssertionError(f"K1 or K2 disagrees with its plain version on "
                             f"the motion step's table: {k1_errs} {k2_errs}")
    if not plain["ok"]:
        raise AssertionError(f"a motion step through the kernels disagrees "
                             f"with the plain path: {plain}")
    if not (flow["ok"] and flow["finite"]):
        raise AssertionError(f"render_flow through the kernels disagrees "
                             f"with the plain path: {flow}")
    if not finite:
        raise AssertionError("non-finite trained parameters")
    return rec


# The parallel path (`parallel/`) at full width, in two runs: four gloo
# ranks that share the one card (NCCL refuses two ranks on one GPU; gloo
# moves CUDA tensors through the host) and one NCCL rank, so that the same
# entry points also go through real NCCL calls. The four-card NCCL run
# needs a four-card machine.
PAR_RUNS = (("gloo", 4), ("nccl", 1))
PAR_STEPS = 10
PAR_RENDER_REPS = 3
PAR_TIMEOUT_S = 300.0
# The gates: the JAX tests' own bounds (tests/test_parallel.py) after one
# DP step and on the sharded renders at depth_mode "total", where both
# sides composite in the exact front-to-back order. Adam's first step
# moves each element by about lr whatever its gradient's scale, so after
# step 1 Adam's moments are held as well, each group within `moment_rel`
# of its largest |moment|: a gradient K times too large or too small fails
# there. After PAR_STEPS steps a parameter may differ by `lr_steps` lr per
# step (`lr_steps_rot` for unnorm_rotations) plus p_atol, and the loss by
# 1e-4 relative: with Adam's eps of 1e-15 an element whose summed gradient
# is at rounding level moves by +-lr on either side, and the two sides sum
# the cameras' gradients in other orders. Set from the H100 readings in
# PERF.md: unnorm_rotations 0.71 lr apart after 10 steps, every other
# group within 1.7e-3 lr.
PAR_TOL = dict(loss_rtol=1e-5, p_atol=1e-5, p_rtol=1e-4, accum_atol=1e-5,
               ps_atol=2e-5, moment_rel=1e-4, loss_rtol_last=1e-4,
               lr_steps=1e-3, lr_steps_rot=0.25,
               img_atol=2e-4, depth_atol=1e-3, depth_rtol=1e-4,
               grad_rel=1e-3)
PAR_MODES = ("dp_pmean", "dp_psum_scatter", "tile_stripes", "depth_slabs")
PAR_KIND = {"tile_stripes": "tile", "depth_slabs": "depth"}
PAR_NOTE = ("ranks share one card and time-slice it: these times are not "
            "a scaling figure")


def par_spec(scene, device, tmp):
    """What every rank needs, as host values: the bench training's 4
    cameras at 640x360 with their GT images of `bench_gt(scene)` and its
    init cloud; the bench scene and view for the sharded renders, the view
    padded to a multiple of 4 tile rows (640x384: 24 rows, 6 per rank);
    the path of the single-process references."""
    import torch
    from dynamic3dgaussians_tpu_torch.data.synthetic import (
        init_point_cloud, make_dataset)
    from dynamic3dgaussians_tpu_torch.device import resolve_device
    gt = bench_gt(scene)
    with torch.no_grad():
        ds, _, _ = make_dataset(gt, num_t=1, num_cams=TRAIN_CAMS, w=W, h=H,
                                f=F, radius=TRAIN_RADIUS, device=device)
    rows = -(-H // TILE)
    return dict(
        device=str(resolve_device(device)), w=W, h=H, f=F, pad_h=-(-rows // 4) * 4 * TILE,
        steps=PAR_STEPS, reps=PAR_RENDER_REPS, tol=PAR_TOL,
        frames=[dict(im=fr["im"].cpu().numpy(), seg=fr["seg"].cpu().numpy(),
                     w2c=fr["camera"].w2c.cpu().numpy(),
                     cam_id=int(fr["cam_id"])) for fr in ds[0]],
        pt=init_point_cloud(gt),
        scene={k: scene[k] for k in ("means", "colors", "opac", "scales",
                                     "quats")},
        ref_path=os.path.join(tmp, "parallel_ref.pt"))


def par_dp_world(spec, dev):
    """The DP inputs on `dev`: the 4 datapoints and the default
    configuration."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    from dynamic3dgaussians_tpu_torch.train.trainer import raster_config
    w, h, f = spec["w"], spec["h"], spec["f"]
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    frames = [dict(camera=make_camera(w, h, k, fr["w2c"], device=dev),
                   im=torch.as_tensor(fr["im"], device=dev),
                   seg=torch.as_tensor(fr["seg"], device=dev),
                   cam_id=fr["cam_id"]) for fr in spec["frames"]]
    cfg = TrainConfig()
    return frames, cfg, raster_config(cfg)


def par_lrs(cfg, params, variables):
    """The t = 0 learning rates of `train`: means3D's by the scene radius."""
    import torch
    radius = float(variables["scene_radius"])
    return {key: torch.tensor(cfg.lrs.get(key, 0.0) * (
        radius if key == "means3D" else 1.0),
        device=variables["scene_radius"].device) for key in params}


def par_render_setup(spec, kind, dev):
    """(camera, scene tensors, rgb and depth cotangents) of a sharded
    render: the bench view, padded to `pad_h` rows for the tile stripes."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    w, f = spec["w"], spec["f"]
    h = spec["pad_h"] if kind == "tile" else spec["h"]
    w2c = np.eye(4)
    w2c[2, 3] = 6.0
    cam = make_camera(w, h, [[f, 0, w / 2], [0, f, spec["h"] / 2],
                             [0, 0, 1]], w2c, device=dev)
    args = [torch.as_tensor(spec["scene"][key], device=dev)
            for key in ("means", "colors", "opac", "scales", "quats")]
    rng = np.random.RandomState(23)
    ct = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
          for s in ((h, w, 3), (h, w))]
    return cam, args, ct


def par_loss_grads(fn, args, ct):
    """fn's image and the gradient of sum(rgb ct_rgb) + sum(depth ct_depth)
    w.r.t. each of its five inputs."""
    import torch
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*ts)
    loss = torch.sum(out["rgb"] * ct[0]) + torch.sum(out["depth"] * ct[1])
    grads = torch.autograd.grad(loss, ts)
    return {key: out[key].detach() for key in ("rgb", "depth", "alpha")}, \
        list(grads)


def par_reference(spec, device):
    """The initial DP state and the single-process references on the card,
    saved for the ranks: `init_params` of the init cloud (200,000 points,
    capacity 800,768); `make_train_step` on the 4 cameras for PAR_STEPS
    steps (the loss of each, the parameters and the densification
    accumulator after the first and the last, Adam's moments after the
    first); `render` of the bench view
    (padded for the stripes) with its gradients at depth_mode "total" and
    "quantized"."""
    import torch
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                            render)
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train.trainer import make_train_step
    frames, cfg, rcfg = par_dp_world(spec, device)
    params, variables = G.init_params(
        spec["pt"], np.stack([fr["w2c"] for fr in spec["frames"]]),
        device=device)
    ref = {"losses": [], "init": (
        {key: v.cpu() for key, v in params.items()},
        {key: v.cpu() for key, v in variables.items()})}
    lrs = par_lrs(cfg, params, variables)
    step = make_train_step(cfg, rcfg)
    opt = optim.init(params)
    for i in range(1, spec["steps"] + 1):
        params, opt, variables, m = step(params, opt, variables, frames, lrs,
                                         True)
        ref["losses"].append(float(m["loss"]))
        if i in (1, spec["steps"]):
            ref[f"params_{i}"] = {key: v.cpu() for key, v in params.items()}
            ref[f"accum_{i}"] = variables["means2D_gradient_accum"].cpu()
        if i == 1:
            ref["moments_1"] = {f"{m}.{key}": v.cpu() for m in ("mu", "nu")
                                for key, v in getattr(opt, m).items()}
    for kind in ("tile", "depth"):
        cam, args, ct = par_render_setup(spec, kind, device)
        for mode in ("total", "quantized"):
            # the stripes emit without the exact cull (as the reference's
            # tile_shard does): the same pairs as a render without it
            cfg_r = RasterConfig(depth_mode=mode, exact_cull=kind == "depth")

            def fn(*a):
                out = render(cam, *a, config=cfg_r, device=device)
                return {"rgb": out.rgb, "depth": out.depth,
                        "alpha": out.alpha}
            img, grads = par_loss_grads(fn, args, ct)
            ref[kind, mode] = dict(
                {key: v.cpu() for key, v in img.items()},
                grads=[g.cpu() for g in grads])
    torch.save(ref, spec["ref_path"])


def par_tables(spec, device):
    """K1 and K2 against their plain versions on the tables the sharded
    renders give them: each tile stripe's (stripe-local keys and y, the
    off-stripe pairs at the sentinel, no exact cull) and each depth slab's
    (its rows, the padding at zero opacity), at every world size of
    PAR_RUNS and both depth modes, built by the renders' own
    `stripe_table` and `slab_inputs`. Returns {kind: {world: [per mode and
    shard: errors with "ok"]}}."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import (
        prepare_records, sorted_records)
    from dynamic3dgaussians_tpu_torch.parallel.gaussian_shard import \
        slab_inputs
    from dynamic3dgaussians_tpu_torch.parallel.tile_shard import stripe_table
    out = {}
    for kind in ("tile", "depth"):
        cam, args, _ = par_render_setup(spec, kind, device)
        for world in sorted({w for _, w in PAR_RUNS}):
            rows = out.setdefault(kind, {}).setdefault(world, [])
            for mode in ("total", "quantized"):
                cfg = RasterConfig(depth_mode=mode)
                for d in range(world):
                    with torch.no_grad():
                        if kind == "tile":
                            table, key, gid, sp = stripe_table(
                                cam, cfg, world, d, *args)
                            rec_t, starts, counts, _ = prepare_records(
                                key, gid, table, n_chan=sp[0],
                                num_tiles=sp[1], chunk=sp[5], bits_z=sp[6],
                                depth_mode=mode)
                            kw = dict(num_tiles=sp[1], grid_w=sp[2],
                                      tile_h=sp[3], tile_w=sp[4],
                                      chunk=sp[5])
                        else:
                            m, c, o, sc, q = slab_inputs(cam, world, d,
                                                         *args)
                            proj = project(m, sc, q, cam)
                            o = torch.where(proj.valid, o,
                                            torch.zeros_like(o))
                            rec_t, starts, counts, _ = sorted_records(
                                cam.height, cam.width, proj, c, o,
                                tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                                chunk=cfg.chunk,
                                max_tiles_per_gaussian=(
                                    cfg.max_tiles_per_gaussian),
                                fused_key=cfg.fused_key, depth_mode=mode,
                                exact_cull=cfg.exact_cull,
                                enum_cap=cfg.emit_enum_cap)
                            kw = dict(num_tiles=starts.shape[0],
                                      grid_w=-(-cam.width // cfg.tile_w),
                                      tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                                      chunk=cfg.chunk)
                    e1, _ = k1_against_plain(rec_t, starts, counts, 3, kw)
                    e2, _ = k2_against_plain(rec_t, starts, counts, kw,
                                             device)
                    rows.append(dict(mode=mode, shard=d,
                                     n_pairs=int(counts.sum()),
                                     num_tiles=kw["num_tiles"], k1=e1, k2=e2,
                                     ok=e1["ok"] and e2["ok"]))
    return out


def par_ratio(a, b, atol, rtol=0.0) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 within the bound."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def par_dp(spec, reduce, ref, dev, pmean_snaps=None):
    """PAR_STEPS steps of `make_dp_train_step` in this rank, held against
    the single-process reference (and psum_scatter against pmean's
    parameters of the same rank). Returns (record, parameter snapshots)."""
    import torch
    from dynamic3dgaussians_tpu_torch.parallel import camera_dp
    from dynamic3dgaussians_tpu_torch.train import optim
    frames, cfg, rcfg = par_dp_world(spec, dev)
    params, variables = ref["init"]
    lrs = par_lrs(cfg, params, variables)
    tol, steps = spec["tol"], spec["steps"]
    step = camera_dp.make_dp_train_step(cfg, rcfg, reduce=reduce,
                                        device=dev)
    opt = optim.init(params)
    if reduce == "psum_scatter":
        opt = camera_dp.shard_adam_state(opt)
    zero_launches()
    ms, losses, snaps = [], [], {}
    for i in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, variables, m = step(params, opt, variables, frames, lrs,
                                         True)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i in (1, steps):
            snaps[i] = params
            if i == 1:
                accum = variables["means2D_gradient_accum"]
                psnr_1, dropped_1 = float(m["psnr"]), int(m["n_dropped"])
                full = camera_dp.gather_adam_state(opt) \
                    if reduce == "psum_scatter" else opt
                moments = {f"{m_}.{key}": v for m_ in ("mu", "nu")
                           for key, v in getattr(full, m_).items()}
                del full
    launches = read_launches()
    rec = dict(launches=launches, ms=ms, ms_median=float(np.median(ms[1:])),
               losses=losses, psnr_1=psnr_1, n_dropped_1=dropped_1,
               loss_rel_err_1=abs(losses[0] - ref["losses"][0])
               / abs(ref["losses"][0]),
               loss_rel_err_last=abs(losses[-1] - ref["losses"][-1])
               / abs(ref["losses"][-1]),
               accum_err_1=float((accum - ref["accum_1"]).abs().max()))
    # each group's moment apart from the reference's, in units of the
    # group's largest |moment| (0 apart where both are 0)
    rec["moments_rel_err_1"] = {key: float(
        (v - ref["moments_1"][key]).abs().max()
        / ref["moments_1"][key].abs().max().clamp(min=1e-30))
        for key, v in moments.items()}
    last = {key: tol["lr_steps_rot" if key == "unnorm_rotations"
                     else "lr_steps"] * float(lrs[key]) * steps
            + tol["p_atol"] for key in params}
    rec["params_ratio_1"] = {key: par_ratio(
        snaps[1][key], ref["params_1"][key], tol["p_atol"], tol["p_rtol"])
        for key in params}
    rec["params_ratio_last"] = {key: par_ratio(
        snaps[steps][key], ref[f"params_{steps}"][key], last[key])
        for key in params}
    if pmean_snaps is not None:
        rec["vs_pmean_ratio_1"] = {key: par_ratio(
            snaps[1][key], pmean_snaps[1][key], tol["ps_atol"],
            tol["p_rtol"]) for key in params}
        rec["vs_pmean_ratio_last"] = {key: par_ratio(
            snaps[steps][key], pmean_snaps[steps][key], last[key])
            for key in params}
    return rec, snaps


def par_shard(spec, kind, ref, dev):
    """The tile-stripe or depth-slab render of the bench scene in this
    rank, forward and gradient, at depth_mode "total" (held against the
    single-process render) and "quantized" (reported), and its forward
    time."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
    from dynamic3dgaussians_tpu_torch.parallel.gaussian_shard import \
        make_depth_sharded_render
    from dynamic3dgaussians_tpu_torch.parallel.tile_shard import \
        make_tile_sharded_render
    cam, args, ct = par_render_setup(spec, kind, dev)
    tol = spec["tol"]
    rec = {}
    for mode in ("total", "quantized"):
        cfg = RasterConfig(depth_mode=mode)
        fn = (make_tile_sharded_render(cam, config=cfg, device=dev)
              if kind == "tile" else
              make_depth_sharded_render(cam, config=cfg, device=dev))
        zero_launches()
        img, grads = par_loss_grads(fn, args, ct)
        torch.cuda.synchronize()
        launches = read_launches()
        want = ref[kind, mode]
        r = dict(launches=launches,
                 rgb_err=float((img["rgb"] - want["rgb"]).abs().max()),
                 alpha_err=float((img["alpha"] - want["alpha"]).abs().max()),
                 depth_err=float((img["depth"] - want["depth"]).abs().max()),
                 depth_ratio=par_ratio(img["depth"], want["depth"],
                                       tol["depth_atol"], tol["depth_rtol"]),
                 rgb_psnr=psnr(img["rgb"].clamp(0, 1),
                               want["rgb"].clamp(0, 1)),
                 grad_rel_err={key: float((g - gw).abs().max()
                                          / gw.abs().max().clamp(min=1e-30))
                               for key, g, gw in zip(
                                   ("means", "colors", "opac", "scales",
                                    "quats"), grads, want["grads"])})
        with torch.no_grad():
            r["ms"] = host_ms(lambda i=0: fn(*args), spec["reps"])
        r["ms_median"] = float(np.median(r["ms"]))
        rec[mode] = r
    return rec


def _parallel_rank(rank, world, spec):
    """One rank of `parallel_main_path`: camera DP in both reduce modes,
    the tile stripes and the depth slabs, each against the references."""
    import torch
    from dynamic3dgaussians_tpu_torch.parallel import collectives as C
    clock = {"entry": time.time()}
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # written by this script's parent process
    ref = torch.load(spec["ref_path"], map_location=dev, weights_only=False)
    clock["ref_loaded"] = time.time()
    out = dict(rank=rank, collectives=C.implementation(), clock=clock)
    out["dp_pmean"], snaps = par_dp(spec, "pmean", ref, dev)
    clock["dp_pmean"] = time.time()
    out["dp_psum_scatter"], _ = par_dp(spec, "psum_scatter", ref, dev,
                                       pmean_snaps=snaps)
    clock["dp_psum_scatter"] = time.time()
    out["tile_stripes"] = par_shard(spec, "tile", ref, dev)
    clock["tile_stripes"] = time.time()
    out["depth_slabs"] = par_shard(spec, "depth", ref, dev)
    clock["depth_slabs"] = time.time()
    return out


def par_failures(mode, r, spec, world):
    """The gates one rank's record of `mode` fails in a run of `world`
    ranks. K1 and K2 launch exactly once per camera and step in DP, and
    once per sharded render and gradient."""
    tol, steps, bad = spec["tol"], spec["steps"], []
    if mode.startswith("dp_"):
        need = steps * len(spec["frames"]) // world
        checks = [("loss_rel_err_1", r["loss_rel_err_1"] <= tol["loss_rtol"]),
                  ("moments_rel_err_1", max(r["moments_rel_err_1"].values())
                   <= tol["moment_rel"]),
                  ("loss_rel_err_last",
                   r["loss_rel_err_last"] <= tol["loss_rtol_last"]),
                  ("accum_err_1", r["accum_err_1"] <= tol["accum_atol"]),
                  ("losses_finite", bool(np.isfinite(r["losses"]).all()))]
        for key in ("params_ratio_1", "params_ratio_last",
                    "vs_pmean_ratio_1", "vs_pmean_ratio_last"):
            if key in r:
                checks.append((key, max(r[key].values()) <= 1.0))
        launches = [r["launches"]]
    else:
        need = 1
        t = r["total"]
        checks = [("rgb_err", t["rgb_err"] <= tol["img_atol"]),
                  ("alpha_err", t["alpha_err"] <= tol["img_atol"]),
                  ("depth_ratio", t["depth_ratio"] <= 1.0),
                  ("grad_rel_err",
                   max(t["grad_rel_err"].values()) <= tol["grad_rel"])]
        launches = [r["total"]["launches"], r["quantized"]["launches"]]
    for la in launches:
        checks.append(("launches", la["raster_fwd"] == need
                       and la["raster_bwd"] == need))
    bad += [name for name, ok in checks if not ok]
    return bad


def phase_parallel_main_path(scene, device, smi):
    """`parallel/` at full width: `make_dp_train_step` on the bench
    training's 4 cameras at 640x360 (200,000 points, capacity 800,768, one
    camera per gloo rank, K = 8, t = 0), PAR_STEPS steps in each reduce
    mode; `make_tile_sharded_render` on the bench view padded to 640x384;
    `make_depth_sharded_render` on the bench view (50,000 gaussians per
    gloo rank); each forward and with the gradient of a fixed
    random-cotangent loss, at depth_mode "total" and "quantized". Runs in
    PAR_RUNS (four gloo ranks on the one card, one NCCL rank). Every rank
    is held against the single-process path on the card (`par_reference`)
    and gated by PAR_TOL; K1 and K2 must launch in every rank, in every
    mode. One line per mode and run."""
    import torch
    from dynamic3dgaussians_tpu_torch.parallel import mesh
    totals = {"raster_fwd": 0, "raster_bwd": 0, "sol_probe": 0}
    with tempfile.TemporaryDirectory() as tmp:
        spec = par_spec(scene, device, tmp)
        t0 = time.perf_counter()
        par_reference(spec, device)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tables = par_tables(spec, device)
        tables_s = time.perf_counter() - t0
        failures, recs = [], []
        torch.cuda.empty_cache()
        for backend, world in PAR_RUNS:
            t0, wall0 = time.perf_counter(), time.time()
            ranks = mesh.spawn(_parallel_rank, world, backend,
                               timeout_s=PAR_TIMEOUT_S, args=(spec,))
            run_s = time.perf_counter() - t0
            # seconds from the spawn to each rank's milestones
            clocks = [{key: t - wall0 for key, t in r["clock"].items()}
                      for r in ranks]
            for mode in PAR_MODES:
                per = [r[mode] for r in ranks]
                bad = {r["rank"]: par_failures(mode, r[mode], spec, world)
                       for r in ranks}
                bad = {k: v for k, v in bad.items() if v}
                extra = {}
                if not mode.startswith("dp_"):
                    # K1 and K2 on this mode's own tables, in the parent
                    rows = tables[PAR_KIND[mode]][world]
                    extra = dict(kernels_vs_plain=rows,
                                 kernels_vs_plain_s=tables_s)
                    if not all(t["ok"] for t in rows):
                        bad["tables"] = [(t["mode"], t["shard"])
                                         for t in rows if not t["ok"]]
                rec = dict(phase="parallel_main_path", mode=mode,
                           backend=backend, world=world,
                           collectives=ranks[0]["collectives"],
                           ranks=per, run_s=run_s, reference_s=ref_s,
                           rank_clock_s=clocks,
                           steps=spec["steps"] if mode.startswith("dp_")
                           else None, tol=PAR_TOL, note=PAR_NOTE,
                           failures=bad, card=smi, **extra)
                emit(rec)
                recs.append(rec)
                if bad:
                    failures.append((backend, world, mode, bad))
                for r in per:
                    for la in ([r["launches"]] if mode.startswith("dp_")
                               else [r["total"]["launches"],
                                     r["quantized"]["launches"]]):
                        for key in totals:
                            totals[key] += la[key]
    if failures:
        raise AssertionError(f"parallel_main_path failed: {failures}")
    return dict(launches=totals, records=recs)


# The long-run tools (`dynamic3dgaussians_tpu_torch/tools/`) at their full
# widths, the depth cut: dynamic_run over 3 timesteps of 300 + 60 + 60
# steps (of the reference run's 50 timesteps of 1,000 + 200), scale_run
# 300 of 3,000 steps, roundtrip_demo 200 + 60 + 60 of 400 + 120 + 120.
LR_DYNAMIC = dict(n=50_000, hw=256, cams=8, k_cap=8, timesteps=3,
                  iters0=300, iters=60)
LR_TRACK = dict(queries=256, knn=8)
LR_SCALE = dict(n=30_000, hw=400, cams=6, k_cap=16, iters=300,
                densify_every=100, min_gain_db=2.0)
LR_ROUNDTRIP = dict(iters=200, iters_later=60)
# the reference's r5 run's window (artifacts/dynamic_run_tpu_r5.json)
LR_WINDOW = 25
# an untrained model scores ~12 dB on these views (the tools' PSNR at step
# 0); the reference's recorded round trip, 400 + 120 + 120 steps, 17.55 dB
# (artifacts/roundtrip_demo.json)
LR_ROUNDTRIP_PSNR_MIN = 15.0


def _flags(d):
    return [x for k, v in d.items() for x in (f"--{k}", str(v))]


def train_records(params, variables, cam, k):
    """The record table K1 and K2 see in a training step at `cam`: the
    activated gaussians (opacity gated by `alive` and the projection), RGB
    and the seg channels, with K = `k` emission slots."""
    import torch
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    from dynamic3dgaussians_tpu_torch.ops.sorted_raster import \
        sorted_records
    with torch.no_grad():
        act = G.activated(params, variables["alive"])
        proj = project(act["means3d"], act["scales"], act["rotations"], cam)
        op = torch.where(proj.valid, act["opacity"],
                         torch.zeros_like(act["opacity"]))
        chans = torch.cat([act["colors"], params["seg_colors"]], dim=-1)
        rec_t, starts, counts, _ = sorted_records(
            cam.height, cam.width, proj, chans, op,
            max_tiles_per_gaussian=k)
    kw = dict(num_tiles=starts.shape[0],
              grid_w=-(-cam.width // TILE), tile_h=TILE, tile_w=TILE,
              chunk=CHUNK)
    return rec_t, starts, counts, chans.shape[1], kw


def longrun_dynamic(device, tmp):
    """`dynamic_run.run` on the card with the smoke's callbacks: each
    step's ms (after a synchronize) and K, each K escalation, and at the
    end of each timestep the rect drops of camera 0 rendered from all rows
    and from the alive rows (`rect_drop_split`, 2 K1 launches), and the
    t = 1 state for the kernels' comparison."""
    import dataclasses

    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.tools import dynamic_run

    d = LR_DYNAMIC
    args = dynamic_run.parse_args(_flags(d) + [
        "--device", str(device), "--out", os.path.join(tmp, "dynamic.json"),
        "--save_params", os.path.join(tmp, "dynamic_params.npz")])
    cfg0 = dynamic_run.build_config(args)
    cam0 = orbit_cameras((0.0, 0.0, 0.0), 4.0, -1.0, d["cams"], d["hw"],
                         d["hw"], d["hw"] * 0.9, device=device)[0]
    st = dict(k=d["k_cap"], last=None, steps=[], grow=[], splits=[],
              t1=None)

    def on_iter(t, i, k):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if st["last"] is not None:
            st["steps"].append((t, k, (now - st["last"]) * 1e3))
        st["last"] = now

    def on_grow_tiles(t, i, new_k):
        st["k"] = new_k
        st["grow"].append(dict(t=t, i=i, k=new_k))

    def on_timestep(t, params, variables):
        cfg = dataclasses.replace(cfg0, raster=dataclasses.replace(
            cfg0.raster, max_tiles_per_gaussian=st["k"]))
        st["splits"].append(dict(t=t, **dynamic_run.rect_drop_split(
            params, variables, {"camera": cam0}, cfg)))
        if t == 1:
            st["t1"] = ({k: v.detach().clone() for k, v in params.items()},
                        {k: v.clone() for k, v in variables.items()},
                        st["k"])
        st["last"] = None            # the first step of a timestep: untimed

    zero_launches()
    t0 = time.perf_counter()
    log = dynamic_run.run(args, callbacks=dict(
        on_iter=on_iter, on_grow_tiles=on_grow_tiles,
        on_timestep=on_timestep))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    by = {}
    for t, k, ms in st["steps"]:
        by.setdefault(f"{'t0' if t == 0 else 'later'}_k{k}", []).append(ms)
    step_ms = {key: dict(n=len(v), median=float(np.median(v)),
                         min=float(np.min(v))) for key, v in by.items()}
    params, variables, k1 = st["t1"]
    rec_t, starts, counts, n_chan, kw = train_records(params, variables,
                                                      cam0, k1)
    k1_errs, _ = k1_against_plain(rec_t, starts, counts, n_chan, kw)
    k2_errs, _ = k2_against_plain(rec_t, starts, counts, kw, device)
    table = dict(t=1, k=k1, cv=rec_t.shape[0] - 8, n_pairs=int(counts.sum()),
                 ne_pad=rec_t.shape[1])
    n_steps = d["iters0"] + (d["timesteps"] - 1) * d["iters"]
    # K1: the dataset's renders (one per timestep and camera), one per
    # step, two per timestep's split; K2: one per step
    want = dict(raster_fwd=d["timesteps"] * d["cams"] + n_steps
                + 2 * d["timesteps"], raster_bwd=n_steps, sol_probe=0)
    return dict(args=vars(args), log=log, run_s=run_s, launches=launches,
                launches_want=want, step_ms=step_ms, grow_tiles=st["grow"],
                rect_split=st["splits"], record_table=table,
                k1_vs_plain=k1_errs, k2_vs_plain=k2_errs)


def longrun_dynamic_window(dyn, device, tmp):
    """`dynamic_run.run` once more at the reference's --steps_per_call
    LR_WINDOW (no callbacks): `train()`'s window loop on the card, its
    windows cut at report steps, K escalations (8 -> 16 -> 32 -> 64 at
    t = 0, one StepWindow kept across them) and the t = 0 -> t > 0
    recapture. Held bitwise against the steps_per_call 1 run `dyn`: the
    saved parameters of every timestep, each report's PSNR and loss and
    each timestep's alive count and final PSNR. K1 and K2 run once per step
    (and K1 once per dataset render), counted by the kernels on the device;
    the wrappers' host counts stay below that (replays launch nothing from
    the host)."""
    import torch
    from dynamic3dgaussians_tpu_torch.tools import dynamic_run

    d = dict(LR_DYNAMIC, steps_per_call=LR_WINDOW)
    args = dynamic_run.parse_args(_flags(d) + [
        "--device", str(device), "--out",
        os.path.join(tmp, "dynamic_w.json"),
        "--save_params", os.path.join(tmp, "dynamic_w_params.npz")])
    zero_launches()
    t0 = time.perf_counter()
    log = dynamic_run.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, runs = read_launches(), read_runs()
    ref = dyn["log"]
    a, b = np.load(ref["params_npz"]), np.load(log["params_npz"])
    not_bitwise = sorted(set(a.files) ^ set(b.files)) + [
        k for k in sorted(set(a.files) & set(b.files))
        if not np.array_equal(a[k], b[k])]

    def per_t(lg):
        return [(p["t"], p["n_alive"], p["final_psnr"])
                for p in lg["per_timestep"]]
    n_steps = d["iters0"] + (d["timesteps"] - 1) * d["iters"]
    want_runs = dict(raster_fwd=d["timesteps"] * d["cams"] + n_steps,
                     raster_bwd=n_steps)
    return dict(args=vars(args), run_s=run_s, launches=launches, runs=runs,
                runs_want=want_runs,
                params_not_bitwise=not_bitwise,
                reports_equal=log["steps"] == ref["steps"],
                per_timestep_equal=per_t(log) == per_t(ref),
                per_timestep=log["per_timestep"])


def longrun_tracking(params_npz, device, tmp):
    """`tracking_eval.run` on dynamic_run's stacked npz, the PCK@0.05 of
    tracks that stay at their t = 0 position through the same rig, and
    how visible the foreground's motion is in the training views (those
    renders come after the tool's launches are read)."""
    import torch
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.eval.metrics import pck
    from dynamic3dgaussians_tpu_torch.eval.tracking import project_tracks
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.tools import tracking_eval

    d = LR_DYNAMIC
    argv = ["--params", params_npz, "--n", str(d["n"]), "--timesteps",
            str(d["timesteps"]), "--cams", str(d["cams"]), "--hw",
            str(d["hw"]), "--device", str(device),
            "--out", os.path.join(tmp, "tracking.json")] + _flags(LR_TRACK)
    zero_launches()
    t0 = time.perf_counter()
    res = tracking_eval.main(argv)
    run_s = time.perf_counter() - t0
    launches = read_launches()
    # the tool's queries, held still
    scene = synthetic.make_gt_scene(n_fg=d["n"] // 2, n_bg=d["n"] // 2,
                                    seed=0)
    qi = np.random.RandomState(123).choice(scene["n_fg"],
                                           LR_TRACK["queries"],
                                           replace=False)
    q = scene["means"][qi].astype(np.float32)
    T = d["timesteps"]
    gt = np.stack([q @ synthetic.rigid_motion(t, T)[0].T
                   + synthetic.rigid_motion(t, T)[1] for t in range(T)])
    still = np.broadcast_to(q, gt.shape)
    cams = orbit_cameras((0.0, 0.0, 0.0), 4.0, -1.0, d["cams"], d["hw"],
                         d["hw"], d["hw"] * 0.9, device=device)
    pck_still = float(np.mean([float(pck(
        project_tracks(torch.as_tensor(np.ascontiguousarray(still),
                                       device=device), c),
        project_tracks(torch.as_tensor(gt, device=device), c),
        (d["hw"], d["hw"]), ratio=0.05)) for c in cams]))
    # how much of the foreground the views show: its pixel share at t = 0
    # (seg) and the share of pixels that change by more than one 8-bit
    # level from the first to the last timestep, per camera
    from dynamic3dgaussians_tpu_torch.tools import dynamic_run
    data, _, _ = dynamic_run.build_data(
        dynamic_run.parse_args(_flags(d)), device)
    fg_share = [float((f["seg"][..., 0] > 0.5).float().mean())
                for f in data[0]]
    moved_share = [float(((a["im"] - b["im"]).abs().amax(-1) > 1 / 255)
                         .float().mean()) for a, b in zip(data[0], data[-1])]
    del data
    return dict(result=res, run_s=run_s, launches=launches,
                pck_still=pck_still, fg_pixel_share=fg_share,
                moved_pixel_share=moved_share)


def longrun_scale(device, tmp):
    """`scale_run.run` on the card; its own --min_gain_db exit is a gate."""
    import torch
    from dynamic3dgaussians_tpu_torch.tools import scale_run
    d = LR_SCALE
    args = scale_run.parse_args(_flags(d) + [
        "--device", str(device), "--out", os.path.join(tmp, "scale.json")])
    zero_launches()
    t0 = time.perf_counter()
    log = scale_run.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    n_reports = len(log["psnr"])
    # K1: the dataset's renders, one per step, two per report's split
    want = dict(raster_fwd=d["cams"] + d["iters"] + 2 * n_reports,
                raster_bwd=d["iters"], sol_probe=0)
    return dict(args=vars(args), log=log, run_s=run_s, launches=launches,
                launches_want=want)


def longrun_roundtrip(device, tmp):
    """`roundtrip_demo.run` at its default size, fewer steps."""
    from dynamic3dgaussians_tpu_torch.tools import roundtrip_demo
    args = roundtrip_demo.parse_args(_flags(LR_ROUNDTRIP) + [
        "--device", str(device), "--out", os.path.join(tmp, "rt"),
        "--artifact", os.path.join(tmp, "roundtrip.json")])
    zero_launches()
    t0 = time.perf_counter()
    summary = roundtrip_demo.run(args)
    run_s = time.perf_counter() - t0
    launches = read_launches()
    T, cams = args.timesteps, args.cams
    n_steps = args.iters + (T - 1) * args.iters_later
    # K1: the layout's renders, one per step and a panel per timestep in
    # cli train, 24 orbit frames, one per view in cli evaluate (at most 4
    # cameras of each timestep)
    want = dict(raster_fwd=T * cams + n_steps + T + 24 + T * min(cams, 4),
                raster_bwd=n_steps, sol_probe=0)
    return dict(args=vars(args), summary=summary, run_s=run_s,
                launches=launches, launches_want=want)


def phase_longrun_main_path(device, smi):
    """The long-run tools on the card at full width, through their
    `run()`: `dynamic_run` (50,000 gaussians, 256x256, 8 cameras, K from
    8; 3 timesteps of 300 + 60 + 60 steps, the stacked npz saved), the
    same `dynamic_run` at --steps_per_call LR_WINDOW
    (`longrun_dynamic_window`), `tracking_eval` on that npz (256
    queries, 8 neighbours), `scale_run` (30,000 gaussians, 400x400, 6
    cameras, K from 16, 300 steps, densify every 100) and
    `roundtrip_demo` (128x96, 6 cameras, 3 timesteps, 200 + 60 + 60
    steps). Each tool's launches are counted alone, with
    the counts set to 0 just before it. Gates: K1 and K2 launch exactly as
    counted (one K2 per step; one K1 per step, per dataset render and per
    extra render); dynamic_run's PSNR rises over t = 0 and is finite at
    every t, and K1 and K2 agree with their plain versions on the record
    table of its t = 1 state; the windowed run bitwise the unwindowed one,
    K1 and K2 run once per step in it (device counts); every tracking
    metric finite, PCK@0.05 above that of tracks held at their t = 0
    position; scale_run's own --min_gain_db exit, at least one densify
    event, capacity never below alive; the round trip's stacked
    params.npz (the tool's own check) and its `cli evaluate` PSNR above
    LR_ROUNDTRIP_PSNR_MIN."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dyn = longrun_dynamic(device, tmp)
        dyn_w = longrun_dynamic_window(dyn, device, tmp)
        track = longrun_tracking(dyn["log"]["params_npz"], device, tmp)
        scale = longrun_scale(device, tmp)
        rt = longrun_roundtrip(device, tmp)
    log, slog = dyn["log"], scale["log"]
    per_t = log["per_timestep"]
    for g in scale["log"]["grow_tiles"]:
        print(f"scale_run grow_tiles: {json.dumps(g)}", flush=True)
    print(f"dynamic_run --steps_per_call {LR_WINDOW}: "
          f"{dyn_w['run_s']:.1f} s (steps_per_call 1, with per-step "
          f"syncs: {dyn['run_s']:.1f} s), "
          f"K1/K2 runs {dyn_w['runs']} (host launches "
          f"{dyn_w['launches']}), params not bitwise: "
          f"{dyn_w['params_not_bitwise']}", flush=True)
    for s in dyn["rect_split"]:
        print(f"dynamic_run t={s['t']} ended at K={s['k']}: rect drops "
              f"{s['all_rows']} ({s['live_rows']} live rows, "
              f"{s['all_rows'] - s['live_rows']} dead rows)", flush=True)
    rec = dict(phase="longrun_main_path", card=smi,
               dynamic=dict({k: v for k, v in dyn.items() if k != "log"},
                            per_timestep=per_t,
                            psnr_first=log["steps"][0]["psnr"],
                            final_alive=log["final_alive"],
                            t_data_s=log["t_data_s"],
                            t_total_s=log["t_total_s"]),
               dynamic_window=dyn_w, tracking=track,
               scale=dict({k: v for k, v in scale.items() if k != "log"},
                          **{k: slog[k] for k in (
                              "psnr", "densify", "grow_tiles", "n_dropped",
                              "n_dropped_rect", "rect_split", "t_data_s",
                              "t_train_s", "it_per_s", "psnr_gain_db",
                              "final_alive", "final_capacity")}),
               roundtrip=rt, phase_s=time.perf_counter() - t0)
    emit(rec)
    launches = {k: dyn["launches"][k] + dyn_w["launches"][k]
                + track["launches"][k] + scale["launches"][k]
                + rt["launches"][k] for k in dyn["launches"]}
    res = track["result"]
    metrics = [v for k, v in res.items()
               if k.startswith(("pck", "px_", "err3d", "ate", "rpe"))]
    caps = [(e["alive"], e["capacity"]) for e in slog["densify"]] + [
        (slog["final_alive"], slog["final_capacity"])]
    checks = {
        "dynamic launches": dyn["launches"] == dyn["launches_want"],
        "dynamic psnr rises over t = 0":
            per_t[0]["final_psnr"] > log["steps"][0]["psnr"],
        "dynamic psnr finite": all(
            p["final_psnr"] is not None and np.isfinite(p["final_psnr"])
            for p in per_t) and len(per_t) == LR_DYNAMIC["timesteps"],
        "dynamic K1 vs plain": dyn["k1_vs_plain"]["ok"],
        "dynamic K2 vs plain": dyn["k2_vs_plain"]["ok"],
        "window run params bitwise": not dyn_w["params_not_bitwise"],
        "window run reports equal": dyn_w["reports_equal"],
        "window run per-timestep equal": dyn_w["per_timestep_equal"],
        "window run K1/K2 runs": dyn_w["runs"] == dyn_w["runs_want"],
        "window run replayed": all(
            0 < dyn_w["launches"][k] < dyn_w["runs"][k]
            for k in ("raster_fwd", "raster_bwd")),
        "tracking launches": track["launches"] == dict(
            raster_fwd=0, raster_bwd=0, sol_probe=0),
        "tracking finite": all(np.isfinite(m) for m in metrics),
        "tracking beats still tracks":
            res["pck_0.05"] > track["pck_still"],
        "scale launches": scale["launches"] == scale["launches_want"],
        "scale densified": len(slog["densify"]) >= 1,
        "scale capacity >= alive": all(a <= c for a, c in caps),
        "roundtrip launches": rt["launches"] == rt["launches_want"],
        "roundtrip psnr": np.isfinite(rt["summary"]["eval"]["mean_psnr"])
        and rt["summary"]["eval"]["mean_psnr"] > LR_ROUNDTRIP_PSNR_MIN,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"longrun_main_path failed: {bad}")
    return dict(launches=launches, runs=dyn_w["runs"], record=rec)


WIN_STEPS = 10
WIN_PROFILE_STEPS = 3
# (name, K emission slots): t = 0 at the default K, t > 0 at K = 64 (where
# every `cli train` run's K escalation ends) with the physics terms
WIN_POINTS = (("t0", 8), ("later", 64))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def profile_calls(fn, n_calls, n_steps=1):
    """torch.profiler summary of n_calls calls of fn (each `n_steps` train
    steps): the device's busy and idle share of the traced span, host
    launches (kernels and graph launches) and synchronising calls per step,
    and the kernels that take most device time. The idle share is None
    when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, -1.0
    for s, e in spans:                  # union of the device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = [e.name for e in events if e.device_type != DeviceType.CUDA]
    per = n_calls * n_steps
    return dict(
        calls=n_calls, steps_per_call=n_steps,
        wall_ms_per_call=wall_ms / n_calls,
        device_events=len(kernels),
        device_busy_ms_per_call=busy_us / 1e3 / n_calls,
        device_window_ms_per_call=window_us / 1e3 / n_calls,
        device_idle_share=(1.0 - busy_us / window_us) if window_us else None,
        kernels_per_call=sum(host.count(n) for n in LAUNCH_CALLS) / n_calls,
        launches_per_step=sum(host.count(n) for n in LAUNCH_CALLS) / per,
        graph_launches_per_step=host.count("cudaGraphLaunch") / per,
        syncs_per_call=sum(host.count(n) for n in SYNC_CALLS) / n_calls,
        top_kernels_ms_per_call=[
            [name[:90], t / 1e3 / n_calls] for name, t in top])


def win_lrs(cfg, params, variables, frozen):
    """`train`'s learning rates: means3D's by the scene radius, the groups
    of `freeze_after_t0` at 0 after t = 0."""
    import torch
    radius = float(variables["scene_radius"])
    return {k: torch.tensor(0.0 if frozen and k in cfg.freeze_after_t0 else
                            cfg.lrs.get(k, 0.0) * (radius if k == "means3D"
                                                   else 1.0),
                            device=variables["scene_radius"].device)
            for k in params}


def win_diff(a, b):
    """The state entries (parameters, Adam's moments and step, variables)
    that are not bitwise equal between two (params, opt, vars) states."""
    import torch
    (pa, oa, va), (pb, ob, vb) = a, b
    pairs = [(f"params.{k}", pa[k], pb[k]) for k in pa]
    pairs += [(f"{m}.{k}", getattr(oa, m)[k], getattr(ob, m)[k])
              for m in ("mu", "nu") for k in oa.mu]
    pairs += [("opt.step", oa.step, ob.step)]
    pairs += [(f"vars.{k}", va[k], vb[k]) for k in va
              if isinstance(va[k], torch.Tensor)]
    return [name for name, x, y in pairs if not torch.equal(x, y)]


def win_tables(params, variables, cam, k, pair_cap):
    """The record table of one step's render at `cam` (RGB + seg, K = `k`)
    in both forms: eager (`prepare_records`) and at the window's pair
    capacity (`prepare_records_static`); the kernels' keyword arguments."""
    import torch
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
    from dynamic3dgaussians_tpu_torch.ops.projection import project
    with torch.no_grad():
        act = G.activated(params, variables["alive"])
        proj = project(act["means3d"], act["scales"], act["rotations"], cam)
        op = torch.where(proj.valid, act["opacity"],
                         torch.zeros_like(act["opacity"]))
        chans = torch.cat([act["colors"], params["seg_colors"]], dim=-1)
        tile_key, gid, _ = SR.emit(cam.height, cam.width, proj, op,
                                   tile_h=TILE, tile_w=TILE,
                                   max_tiles_per_gaussian=k, exact_cull=True,
                                   enum_cap=0)
        table = SR.record_columns(proj, chans, op)
        grid_w = -(-cam.width // TILE)
        num_tiles = -(-cam.height // TILE) * grid_w
        kw = dict(n_chan=chans.shape[1], num_tiles=num_tiles, chunk=CHUNK,
                  bits_z=SR.depth_key_bits(num_tiles),
                  depth_mode="quantized")
        eager = SR.prepare_records(tile_key, gid, table, **kw)
        static = SR.prepare_records_static(tile_key, gid, table,
                                           pair_cap=pair_cap, **kw)
    return eager, static, chans.shape[1], dict(
        num_tiles=num_tiles, grid_w=grid_w, tile_h=TILE, tile_w=TILE,
        chunk=CHUNK)


def win_point(name, k, state, frames, device, smi):
    """One point of `window_main_path`: WIN_STEPS eager steps and the same
    steps as one window, from `state`. Returns (record, the window's end
    state)."""
    import torch
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    is_initial = name == "t0"
    cfg = TrainConfig(num_timesteps=1 if is_initial else 2,
                      raster=RasterSettings(max_tiles_per_gaussian=k))
    rcfg = T.raster_config(cfg)
    step = T.make_train_step(cfg, rcfg)
    params, opt, variables = state
    lrs = win_lrs(cfg, params, variables, frozen=not is_initial)
    sel = np.random.RandomState(11).randint(0, len(frames), WIN_STEPS)
    stack = T.stack_timestep_data(frames)

    def eager(n_steps=WIN_STEPS):
        p, o, v = params, opt, variables
        ms = []
        for c in sel[:n_steps]:
            p, o, v, m = step(p, o, v, frames[int(c)], lrs, is_initial)
            ms.append(m)
        return (p, o, v), ms

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ref, ms = eager()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / WIN_STEPS
    eager_launches = read_launches()
    eager_runs = read_runs()
    losses = torch.stack([m["loss"] for m in ms]).cpu()
    drops = [int(m["n_dropped"]) for m in ms]
    rect = [int(m["n_dropped_rect"]) for m in ms]

    scan = T.make_train_scan(cfg, rcfg, step)
    sel_dev = torch.as_tensor(sel, device=device)

    def window():
        return scan(params, opt, variables, stack, sel_dev, lrs, is_initial)

    torch.cuda.synchronize()
    zero_launches()          # the main path: the window's first call
    t0 = time.perf_counter()
    p, o, v, wm = window()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    runs = read_runs()
    win = scan.window
    steps = win.last_steps
    diff = win_diff(ref, (p, o, v))
    stats_first = dict(win.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, o2, v2, _ = window()           # captured: replays only
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3 / WIN_STEPS
    repeat_diff = win_diff((p, o, v), (p2, o2, v2))
    del p2, o2, v2
    # the eager side traced over WIN_PROFILE_STEPS steps: each traced step
    # costs seconds of the profiler's own processing
    prof_eager = profile_calls(lambda: eager(WIN_PROFILE_STEPS), 1,
                               WIN_PROFILE_STEPS)
    prof_win = profile_calls(window, 1, WIN_STEPS)

    # the first step's table (start state, its camera): the capacity was
    # sized on it, so it holds every live pair
    eager_t, static_t, n_chan, kw = win_tables(
        params, variables, frames[int(sel[0])]["camera"], k, win.pair_cap)
    rec_e, st_e, cn_e, slot_e = eager_t
    rec_s, st_s, cn_s, slot_s, pstats = static_t
    n_live = slot_e.shape[0]
    tables_equal = bool(
        int(pstats[1]) == 0 and int(pstats[0]) == n_live
        and torch.equal(rec_s[:, :n_live], rec_e[:, :n_live])
        and torch.equal(st_s, st_e) and torch.equal(cn_s, cn_e)
        and torch.equal(slot_s[:n_live], slot_e)
        and not bool(rec_s[:, n_live:].any()))
    k1_errs, _ = k1_against_plain(rec_s, st_s, cn_s, n_chan, kw)
    k2_errs, _ = k2_against_plain(rec_s, st_s, cn_s, kw, device)
    rec = dict(
        point=name, k=k, is_initial=is_initial, cams=sel.tolist(),
        rows=int(variables["alive"].shape[0]),
        eager_ms_per_step=eager_ms, window_ms_per_step=window_ms,
        first_window_ms=first_ms, capture_ms=stats_first["capture_ms"],
        pair_cap=stats_first["pair_cap"], max_live=stats_first["max_live"],
        live_per_step=steps["n_live_pairs"].tolist(),
        redos=stats_first["redos"], stats_first=stats_first,
        stats=dict(win.stats), launches=launches, runs=runs,
        eager_launches=eager_launches, eager_runs=eager_runs,
        state_not_bitwise=diff,
        repeat_not_bitwise=repeat_diff,
        loss_bitwise=bool(torch.equal(steps["loss"].cpu(), losses)),
        drops_equal=steps["n_dropped"].tolist() == drops
        and steps["n_dropped_rect"].tolist() == rect
        and int(wm["n_dropped_rect"]) == sum(rect),
        n_dropped_rect=rect, loss=losses.tolist(),
        eager_profile=prof_eager, window_profile=prof_win,
        table=dict(n_pairs=n_live, pair_cap=win.pair_cap,
                   ne_pad=rec_s.shape[1], bitwise_eager=tables_equal),
        k1_vs_plain=k1_errs, k2_vs_plain=k2_errs)
    return rec, (p, o, v)


def phase_window_main_path(scene, device, smi):
    """The multi-step training window (`steps_per_call`) on the bench
    training: the 200k scene's init cloud in an 800,768-row table, 4
    cameras at 640x360. At t = 0 (K = 8) and at t > 0 (K = 64, the kNN
    graph and extrapolation of `train` on the t = 0 window's end state, the
    physics terms on), WIN_STEPS eager `make_train_step` steps and the same
    steps as one `make_train_scan` window (a CUDA graph of the step,
    replayed) from the same state and camera stream. Gates, per point: the
    window's parameters, Adam state, variables, per-step losses and drop
    counts bitwise the eager loop's, and again on a second call of the
    captured window; K1 and K2 run exactly once per step of the window
    (its eager first steps and replays), as the kernels count their runs
    on the device with the counts set to 0 just before its first call,
    while the wrappers' host counts see only the eager steps and the
    capture (a replay launches nothing from the host); the eager loop's
    runs equal its host launches; the window's record table at its pair
    capacity
    bitwise the eager table on the live pairs (zero past them) and K1 / K2
    against their plain versions on it. Reported: pair capacity, largest
    live count, redos, eager and window ms per step (host clock around
    synchronised calls), capture ms, and each side's device idle share and
    host launches per step (`torch.profiler`)."""
    import torch
    from dynamic3dgaussians_tpu_torch.data.synthetic import (
        init_point_cloud, make_dataset)
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    t_start = time.perf_counter()
    gt = bench_gt(scene)
    with torch.no_grad():
        ds, w2c, _ = make_dataset(gt, num_t=2, num_cams=TRAIN_CAMS, w=W, h=H,
                                  f=F, radius=TRAIN_RADIUS, device=device)
    params, variables = G.init_params(init_point_cloud(gt), w2c,
                                      device=device)
    state = (params, optim.init(params), variables)
    torch.cuda.synchronize()
    seconds = dict(setup=time.perf_counter() - t_start)
    points, launches = {}, dict(raster_fwd=0, raster_bwd=0, sol_probe=0)
    runs = dict(raster_fwd=0, raster_bwd=0)
    for name, k in WIN_POINTS:
        t0 = time.perf_counter()
        if name != "t0":
            p, o, v = state
            p, v, o, _ = G.compact_with_optimizer(p, v, o)
            p, v, o = T.initialize_post_first_timestep(p, v, TrainConfig(), o)
            p, v, o = T.initialize_per_timestep(p, v, o)
            state = (p, o, v)
            torch.cuda.synchronize()
            seconds["graph"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        rec, state = win_point(name, k, state, ds[0 if name == "t0" else 1],
                               device, smi)
        seconds[name] = time.perf_counter() - t0
        points[name] = rec
        launches = {key: launches[key] + rec["launches"][key]
                    for key in launches}
        runs = {key: runs[key] + rec["runs"][key] for key in runs}
        print(f"window {name} K={k}: pair_cap {rec['pair_cap']}, largest "
              f"live {rec['max_live']}, redos {rec['redos']}; K1/K2 runs "
              f"{rec['runs']['raster_fwd']}/{rec['runs']['raster_bwd']} "
              f"(host launches {rec['launches']['raster_fwd']}/"
              f"{rec['launches']['raster_bwd']}); eager "
              f"{rec['eager_ms_per_step']:.2f} ms/step (idle "
              f"{rec['eager_profile']['device_idle_share']}), window "
              f"{rec['window_ms_per_step']:.2f} ms/step (idle "
              f"{rec['window_profile']['device_idle_share']}), capture "
              f"{rec['capture_ms']:.1f} ms; {smi}", flush=True)
    out = dict(phase="window_main_path", card=smi, steps=WIN_STEPS,
               points=points, seconds=seconds,
               phase_s=time.perf_counter() - t_start)
    emit(out)
    want_runs = dict(raster_fwd=WIN_STEPS, raster_bwd=WIN_STEPS)
    checks = {}
    for name, rec in points.items():
        st = rec["stats_first"]
        host = st["eager_steps"] + st["captures"]
        checks[f"{name} state bitwise"] = not rec["state_not_bitwise"]
        checks[f"{name} repeat bitwise"] = not rec["repeat_not_bitwise"]
        checks[f"{name} losses bitwise"] = rec["loss_bitwise"]
        checks[f"{name} drops equal"] = rec["drops_equal"]
        checks[f"{name} runs"] = rec["runs"] == want_runs
        checks[f"{name} host launches"] = rec["launches"] == dict(
            raster_fwd=host, raster_bwd=host, sol_probe=0)
        checks[f"{name} eager runs"] = rec["eager_runs"] == want_runs and \
            rec["eager_launches"] == dict(want_runs, sol_probe=0)
        checks[f"{name} static table"] = rec["table"]["bitwise_eager"]
        checks[f"{name} K1 vs plain"] = rec["k1_vs_plain"]["ok"]
        checks[f"{name} K2 vs plain"] = rec["k2_vs_plain"]["ok"]
        checks[f"{name} graph replayed"] = rec["stats_first"]["replays"] > 0
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"window_main_path failed: {bad}")
    return dict(launches=launches, runs=runs, record=out)


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
    pb_rec = phase_playback_main_path(scene, device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        train_rec = phase_train_main_path(scene, device, smi, tmp)
        phase_ckpt_main_path(train_rec, device, smi)
        eval_rec = phase_evaluate_main_path(train_rec, device, smi)
        track_rec = phase_tracking(train_rec, device, smi)
        viewer_rec = phase_view_main_path(train_rec, device, smi)
        feature_rec = phase_feature_main_path(scene, device, smi, tmp)
    ego_rec = phase_ego_main_path(scene, device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        motion_rec = phase_motion_main_path(scene, device, smi, tmp)
    par_rec = phase_parallel_main_path(scene, device, smi)
    longrun_rec = phase_longrun_main_path(device, smi)
    window_rec = phase_window_main_path(scene, device, smi)
    phase_tiled(scene, device, smi)
    phase_knn_approx(scene, device, smi)
    probe_rec = phase_probe_main_path(k3, device, smi)
    b1, b2 = k1["bench", 8], k2["bench", 8]
    floor_rec(b1, b2, k3, train_rec["launches"], smi)

    # the kernels' times below are at CV 8 (RGB + 3 seg channels, the
    # bench view), the table of `cli train`; the feature path runs K1 and
    # K2 at CV 40 (RGB + 32 semantic channels), the ego path at CV 8, 5
    # renders per step, and the motion path at CV 8 (its render_flow too:
    # RGB + 2 displacement channels)
    paths = (("visualize", view_rec), ("train", train_rec),
             ("probe", probe_rec), ("evaluate", eval_rec),
             ("tracking", track_rec), ("playback", pb_rec),
             ("view", viewer_rec), ("feature", feature_rec),
             ("ego", ego_rec), ("motion", motion_rec),
             ("parallel", par_rec), ("longrun", longrun_rec),
             ("window", window_rec))
    by_path = {name: {p: r["launches"][name] for p, r in paths}
               for name in ("raster_fwd", "raster_bwd", "sol_probe")}
    # runs counted by the kernels on the device, replays included, in the
    # paths that replay a CUDA graph of the train step (longrun: its
    # --steps_per_call run)
    runs_by_path = {name: {p: r["runs"][name] for p, r in (
                        ("longrun", longrun_rec), ("window", window_rec))}
                    for name in ("raster_fwd", "raster_bwd")}
    wide = k3["stream_compute/card_wide"]
    emit({"kernels": [
        dict(name="raster_fwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_fwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py:419",
             launches=train_rec["launches"]["raster_fwd"],
             launches_by_path=by_path["raster_fwd"],
             runs_by_path=runs_by_path["raster_fwd"],
             max_abs_err=max(b1["err_chan"], b1["err_depth"]),
             ms=b1["ms"], plain_ms=b1["plain_ms"],
             bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
             library_ms=None),
        dict(name="raster_bwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_bwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_bwd.py:271",
             launches=train_rec["launches"]["raster_bwd"],
             launches_by_path=by_path["raster_bwd"],
             runs_by_path=runs_by_path["raster_bwd"],
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
