#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dynamic3dgaussians_tpu_torch/csrc/`,
holds each kernel against its plain PyTorch version at the shapes the main
paths give it (K1 forward, K2 backward), holds the kernel path's render
gradients against the frozen golden fixtures, drives both main paths at
full width -- `cli visualize` on a 200k-gaussian, 3-timestep checkpoint at
640x360, and `cli train` for 30 steps of the first timestep of a 200k
scene seen by 4 cameras at 640x360, timing its steps and the PSNR of
every view before and after -- and checks that each went through the
kernels. Prints one JSON object per phase; the last line is
`{"ok": true, "device": {...}}`. Any failure propagates and exits non-zero,
as does a machine without CUDA. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
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
# sums a tile's 256 pixels in a shuffle tree and each pixel's suffix
# sequentially; the plain version uses torch.sum and cumsum: float32 sums
# of up to 256 x (records walked) terms, reassociated.
RTOL_BWD = 1e-3
ROW_ATOL_BWD = 1e-4
# kernel-path render gradients against the frozen fixtures: the CPU row of
# tests/fixtures/TOLERANCES.md, |g - fixture| <= rel * max(|fixture|, 1)
REL_GOLDEN = 1e-2

W, H, F = 640, 360, 500.0
N_GAUSS = 200_000
TILE = 16
CHUNK = 128


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bench_scene(seed=0, n=N_GAUSS):
    """The JAX bench's scene statistics (bench.py): small, mostly opaque."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.5, 0.99, (n,)).astype(np.float32)
    scales = rng.uniform(0.004, 0.015, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = (rng.uniform(0, 1, (n,)) > 0.5).astype(np.float32)
    seg_colors = np.stack([seg, np.zeros_like(seg), 1.0 - seg], -1)
    feats = rng.uniform(0, 1, (n, 32)).astype(np.float32)
    return dict(means=means, colors=colors, opac=opac, scales=scales,
                quats=quats, seg_colors=seg_colors, feats=feats)


def ptxas_summary(report: str):
    """{"raster_fwd_kernel<8>": "0 bytes spill stores, Used 39 registers",
    ...} from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"(raster_[a-z]+_kernel)ILi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            name = f"{m.group(1)}<{m.group(2)}>"
            out[name] = ""
        elif name and ("registers" in ln or "spill stores" in ln):
            part = (re.search(r"Used \d+ registers", ln)
                    or re.search(r"\d+ bytes spill stores", ln)).group(0)
            out[name] = f"{out[name]}, {part}" if out[name] else part
    return out


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cell_counts(rec_t, starts, counts, n_active):
    """Cells (record x pixel) the tile kernels walk on these inputs, and
    those among them that pass the 1/255 gate."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, \
        ALPHA_MAX
    p = TILE * TILE
    grid_w = -(-W // TILE)
    s = starts.long()
    c = counts.long()
    nact = n_active.reshape(-1).long()
    shift = s - (s // CHUNK) * CHUNK
    walked = torch.clamp(torch.minimum(c, nact * CHUNK - shift), min=0)
    walked = torch.where(nact > 0, walked, torch.zeros_like(walked))
    walked_cells = int(walked.sum()) * p

    # cells passing the 1/255 gate among the walked ones
    dev = rec_t.device
    tile = torch.arange(s.shape[0], device=dev)
    lin = torch.arange(p, device=dev)
    px = ((tile % grid_w) * TILE)[:, None].float() + (lin % TILE).float()
    py = ((tile // grid_w) * TILE)[:, None].float() + (lin // TILE).float()
    live_cells = 0
    lane = torch.arange(CHUNK, device=dev)
    base = s - shift
    for k in range(int(nact.max())):
        idx = torch.clamp(base[:, None] + k * CHUNK + lane,
                          max=rec_t.shape[1] - 1)
        g = rec_t[:6, idx]
        ok = ((lane >= (shift - k * CHUNK)[:, None])
              & (lane < (shift + c - k * CHUNK)[:, None])
              & (k < nact)[:, None])
        dx = g[0][:, None, :] - px[:, :, None]
        dy = g[1][:, None, :] - py[:, :, None]
        power = torch.clamp(-0.5 * (g[2][:, None] * dx * dx
                                    + g[4][:, None] * dy * dy)
                            - g[3][:, None] * dx * dy, max=0.0)
        alpha = torch.clamp(g[5][:, None] * torch.exp2(power), max=ALPHA_MAX)
        live_cells += int(((alpha >= ALPHA_EPS) & ok[:, None, :]).sum())
    return dict(walked_cells=walked_cells, live_cells=live_cells,
                walked_records_max_tile=int(walked.max()),
                walked_records_mean_tile=float(walked.float().mean()))


def bound(flops, bytes_):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    return dict(flops=flops, bytes=bytes_, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def k1_work(cells, rec_t, n_tiles, n_val):
    """Operations and bytes K1 needs on these inputs (for the bound).

    Every record walked (in-segment, in a processed chunk) costs each of the
    tile's P pixels the alpha chain and its gate: 16 float32 operations
    (2 sub, 5 quad, 5 power incl. min, exp2, mul, min, compare). A cell that
    passes the gate adds 1-alpha, log2, add, exp2, mul, the running-sum add
    and CV multiply-adds: 6 + 2*CV. Transcendentals count as one operation,
    so this is a lower bound. Bytes: the table read once, the outputs
    written once.
    """
    p = TILE * TILE
    flops = cells["walked_cells"] * 16 + cells["live_cells"] * (6 + 2 * n_val)
    bytes_ = (rec_t.numel() * 4 + 2 * n_tiles * 4
              + n_tiles * p * (n_val + 1) * 4 + n_tiles * 4)
    return bound(flops, bytes_)


def k2_work(cells, rec_t, n_tiles, n_val):
    """Operations and bytes K2 needs on these inputs (for the bound).

    Every walked cell costs the alpha chain and gate, 16 operations, as in
    K1. A live cell adds: 1-alpha, log2, the log_t step, exp2, w (5); dw,
    CV multiply-adds (2 CV); d_alpha and the suffix update (5); the clamp
    and power masks (4); the six geometry terms (17); the CV value terms
    d_acc * w (CV); and one add per term into the sums over the tile's
    pixels (6 + CV): 37 + 4 CV in all. Bytes: the table, d_raw, log_t and
    the three per-tile ints read once, d_out written once.
    """
    p = TILE * TILE
    flops = (cells["walked_cells"] * 16
             + cells["live_cells"] * (37 + 4 * n_val))
    bytes_ = (rec_t.numel() * 4 + n_tiles * p * (n_val + 1) * 4
              + 3 * n_tiles * 4 + rec_t.numel() * 4)
    return bound(flops, bytes_)


def bench_records(scene, extra_key, device):
    """The bench view's record table (640x360, f = 500, z = 6) at
    CV = 3 + extra + 2, rounded up to 8."""
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
        rec_t, starts, counts, drops = sorted_records(H, W, proj, chans, op)
    if int(drops) != 0:
        raise AssertionError(f"n_dropped_rect = {int(drops)} on the bench "
                             f"view; the comparison needs a lossless table")
    kw = dict(num_tiles=starts.shape[0], grid_w=-(-W // TILE), tile_h=TILE,
              tile_w=TILE, chunk=CHUNK)
    return rec_t, starts, counts, chans.shape[1], kw


def phase_k1(scene, extra_key, device, smi):
    """K1 against its plain version at full width on the bench view."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        composite_tiles, composite_tiles_torch)

    rec_t, starts, counts, n_chan, kw = bench_records(scene, extra_key,
                                                      device)
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

    ms = cuda_ms(run_k, iters=50)
    plain_ms = cuda_ms(run_p, iters=3, warmup=1)
    cells = cell_counts(rec_t, starts, counts, nact_k)
    work = dict(cells, **k1_work(cells, rec_t, starts.shape[0], n_val))
    rec = dict(phase="k1_vs_plain", cv=n_val, extra=extra_key,
               n_pairs=int(counts.sum()), ne_pad=rec_t.shape[1],
               n_dropped_rect=0, err_chan=err_chan,
               err_depth=err_depth, err_logt=err_logt,
               n_active_equal=nact_equal, n_active_maxdiff=nact_maxdiff,
               tol=dict(chan=ATOL_CHAN, depth=ATOL_DEPTH, log_t=ATOL_LOGT,
                        n_active_equal=NACT_EQUAL_MIN),
               ms=ms, plain_ms=plain_ms, card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def phase_k2(scene, extra_key, device, smi):
    """K2 against its plain version at full width on the bench view, on
    K1's real outputs and a seeded cotangent."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_bwd import (
        composite_tiles_bwd, composite_tiles_bwd_torch)
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles

    rec_t, starts, counts, _, kw = bench_records(scene, extra_key, device)
    n_val = rec_t.shape[0] - 8
    raw, log_t, n_active = composite_tiles(rec_t, starts, counts, **kw)
    d_raw = torch.as_tensor(np.random.RandomState(3).normal(
        size=tuple(raw.shape)).astype(np.float32), device=device)
    args = (rec_t, starts, counts, n_active.reshape(-1), log_t, d_raw)
    out_k = composite_tiles_bwd(*args, **kw)
    torch.cuda.synchronize()
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
    ok = float(excess.max()) <= 0.0 and outside == 0.0

    def run_k():
        composite_tiles_bwd(*args, **kw)

    def run_p():
        composite_tiles_bwd_torch(*args, **kw)

    ms = cuda_ms(run_k, iters=20)
    plain_ms = cuda_ms(run_p, iters=2, warmup=1)
    cells = cell_counts(rec_t, starts, counts, n_active)
    work = dict(cells, **k2_work(cells, rec_t, starts.shape[0], n_val))
    rec = dict(phase="k2_vs_plain", cv=n_val, extra=extra_key,
               n_pairs=n_live, ne_pad=rec_t.shape[1], err_abs=err_abs,
               err_rel_to_row_max=err_row, outside_segments_max=outside,
               grad_row_max=[float(x) for x in scale.reshape(-1)[:6]],
               tol=dict(rtol=RTOL_BWD, row_atol=ROW_ATOL_BWD),
               ms=ms, plain_ms=plain_ms, card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {rec}")
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
        t_start = time.perf_counter()
        cli.main(["visualize", "--params", path, "--out", gif] + flags)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t_start
        launches = {"raster_fwd": composite_tiles.launches,
                    "raster_bwd": composite_tiles_bwd.launches}
        gif_bytes = os.path.getsize(gif)
        stacked = load_params(path)
    if launches["raster_fwd"] != n_frames or launches["raster_bwd"]:
        raise AssertionError(f"cli visualize launched K1 / K2 {launches} "
                             f"times for {n_frames} frames")

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
TRAIN_CAMS = 4
# the cameras orbit the bench cube [-2, 2]^3 at the bench view's distance
# (z = 6, as `main_path` orbits at radius 6)
TRAIN_RADIUS = 6.0
# emission slots of the PSNR renders over every view, 4x the trainer's
# largest K, so that no gaussian's tile rect is cut at orbit radius 6
EVAL_K = 256


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
    """Write the bench scene as a 1-timestep, 4-camera 640x360 reference
    layout on an orbit of `radius` and run `cli train --time_steps` on it:
    30 steps, densify passes at i = 10 and 20, reports every 10,
    `raster.method` = `method` when given. The kernels' launch counts are
    set to 0 just before the command and read just after. Returns what
    the run logged, with the PSNR of every view before and after."""
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
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import params_at_t

    seg = scene["seg_colors"][:, 0]
    gt = dict(means=scene["means"], colors=scene["colors"],
              opac=scene["opac"], scales=scene["scales"],
              quats=scene["quats"], seg=seg, n_fg=int(seg.sum()))
    over = {"densify_start": 10, "densify_every": 10, "report_every": 10}
    if method:
        over["raster"] = {"method": method}
    seq = f"bench_r{radius:g}_{method or 'default'}"
    t0 = time.perf_counter()
    write_reference_layout(tmp, seq, num_t=1, num_cams=TRAIN_CAMS, w=W, h=H,
                           f=F, scene=gt, radius=radius, device=device)
    layout_s = time.perf_counter() - t0
    cfg_path = os.path.join(tmp, f"{seq}.json")
    with open(cfg_path, "w") as fh:
        json.dump(over, fh)
    argv = ["train", "--data_root", tmp, "--seq", seq, "--exp", "smoke",
            "--output", os.path.join(tmp, "out"), "--timesteps", "1",
            "--iters_first", str(TRAIN_STEPS), "--time_steps",
            "--config_json", cfg_path]
    composite_tiles.launches = 0
    composite_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"raster_fwd": composite_tiles.launches,
                "raster_bwd": composite_tiles_bwd.launches}
    run = os.path.join(tmp, "out", "smoke", seq)
    path = os.path.join(run, "params.npz")
    if not os.path.exists(path):
        raise AssertionError("cli train wrote no params.npz")
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(x) for x in fh]

    # the PSNR of every view from the initial state and from params.npz
    md = D.load_meta(tmp, seq)
    frames = D.load_timestep(tmp, seq, md, 0, device=device)
    pt_cld = D.load_init_point_cloud(tmp, seq)
    p0, v0 = G.init_params(pt_cld, D.scene_w2c_stack(md), device=device)
    psnr_before, cut_before = views_psnr(p0, v0["alive"], frames, device)
    stacked = load_params(path)
    p1 = params_from_jax(params_at_t(stacked, 0), device)
    psnr_after, cut_after = views_psnr(p1, None, frames, device)

    step_ms = [(r["step"], int(r["t0/time/k"]), r["t0/time/step_ms"])
               for r in rows if "t0/time/step_ms" in r]
    by_k = {}
    for _, k, ms in step_ms:
        by_k.setdefault(k, []).append(ms)
    return dict(
        cmd="cli train " + " ".join(argv[argv.index("--timesteps"):-2]),
        radius=radius, method=method or "auto", config=over,
        n_gaussians=int(pt_cld.shape[0]), cameras=TRAIN_CAMS, w=W, h=H,
        steps=TRAIN_STEPS, launches=launches,
        reports=[dict(i=r["step"], loss=r["t0/loss"], psnr=r["t0/psnr"],
                      n_dropped_rect=r["t0/n_dropped_rect"])
                 for r in rows if "t0/loss" in r],
        densify=[dict(i=r["step"], n_alive=r["t0/densify/n_alive"],
                      n_cloned=r["t0/densify/n_cloned"],
                      n_split=r["t0/densify/n_split"],
                      n_pruned=r["t0/densify/n_pruned"])
                 for r in rows if "t0/densify/n_alive" in r],
        grow_tiles=[dict(i=r["step"],
                         k=r["t0/grow_tiles/max_tiles_per_gaussian"])
                    for r in rows
                    if "t0/grow_tiles/max_tiles_per_gaussian" in r],
        graph=[dict(knn_s=r["t0/graph/knn_s"], rcm_s=r["t0/graph/rcm_s"])
               for r in rows if "t0/graph/knn_s" in r],
        psnr_views_before=psnr_before, psnr_views_after=psnr_after,
        psnr_views_mean_before=float(np.mean(psnr_before)),
        psnr_views_mean_after=float(np.mean(psnr_after)),
        psnr_views_cut_rects=[cut_before, cut_after],
        n_out=int(stacked["means3D"].shape[1]), cli_s=cli_s,
        layout_s=layout_s, step_ms=step_ms,
        step_ms_median_by_k={str(k): float(np.median(v))
                             for k, v in sorted(by_k.items())},
        steps_by_k={str(k): len(v) for k, v in sorted(by_k.items())},
        final_k=step_ms[-1][1] if step_ms else None)


def phase_train_main_path(scene, device, smi):
    """`cli train` on the bench scene (see `train_bench`). Its step time is
    the median of the steps the run took at the K it ended with, from the
    run's own per-step log; K = 8 has only the untimed first step."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = train_bench(scene, device, tmp)
    final = rec["step_ms_median_by_k"].get(str(rec["final_k"]))
    rec = dict(phase="train_main_path", step_ms_median=final,
               step_ms_median_at_k=rec["final_k"], card=smi, **rec)
    emit(rec)
    launches, densify = rec["launches"], rec["densify"]
    losses = [r["loss"] for r in rec["reports"]]
    if not np.isfinite(losses).all() or len(losses) != TRAIN_STEPS // 10:
        raise AssertionError(f"losses per report: {losses}")
    if any(rec["psnr_views_cut_rects"]):
        raise AssertionError(f"the PSNR renders cut tile rects: "
                             f"{rec['psnr_views_cut_rects']}")
    if not (rec["psnr_views_mean_after"] > rec["psnr_views_mean_before"]):
        raise AssertionError(
            f"PSNR over every view did not rise: "
            f"{rec['psnr_views_before']} -> {rec['psnr_views_after']}")
    if launches["raster_bwd"] != TRAIN_STEPS:
        raise AssertionError(f"K2 launched {launches['raster_bwd']} times in "
                             f"{TRAIN_STEPS} steps")
    if launches["raster_fwd"] < TRAIN_STEPS:
        raise AssertionError(f"K1 launched {launches['raster_fwd']} times in "
                             f"{TRAIN_STEPS} steps")
    if len(rec["step_ms"]) != TRAIN_STEPS - 1 or final is None:
        raise AssertionError(f"step times: {rec['step_ms']}")
    if len(densify) != 2 or not rec["graph"] or \
            rec["n_out"] != densify[-1]["n_alive"]:
        raise AssertionError(f"densify / graph / output rows: {rec}")
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

    scene = bench_scene()
    k1, k2 = {}, {}
    for extra_key in ("seg_colors", "feats"):
        rec = phase_k1(scene, extra_key, device, smi)
        k1[rec["cv"]] = rec
    for extra_key in ("seg_colors", "feats"):
        rec = phase_k2(scene, extra_key, device, smi)
        k2[rec["cv"]] = rec
    phase_oracle(device)
    phase_grad_golden(device)
    view_rec = phase_main_path(scene, device, smi)
    train_rec = phase_train_main_path(scene, device, smi)

    # both main paths pass RGB + 3 seg channels: CV = 8
    by_path = {name: dict(visualize=view_rec["launches"][name],
                          train=train_rec["launches"][name])
               for name in ("raster_fwd", "raster_bwd")}
    emit({"kernels": [
        dict(name="raster_fwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_fwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py:419",
             launches=train_rec["launches"]["raster_fwd"],
             launches_by_path=by_path["raster_fwd"],
             max_abs_err=max(k1[8]["err_chan"], k1[8]["err_depth"]),
             ms=k1[8]["ms"], plain_ms=k1[8]["plain_ms"],
             bound_ms=k1[8]["bound_ms"], bound_by=k1[8]["bound_by"],
             library_ms=None),
        dict(name="raster_bwd", route="cuda",
             source="dynamic3dgaussians_tpu_torch/csrc/raster_bwd.cu",
             replaces="dynamic3dgaussians_tpu/ops/pallas/raster_bwd.py:271",
             launches=train_rec["launches"]["raster_bwd"],
             launches_by_path=by_path["raster_bwd"],
             max_abs_err=k2[8]["err_abs"], ms=k2[8]["ms"],
             plain_ms=k2[8]["plain_ms"], bound_ms=k2[8]["bound_ms"],
             bound_by=k2[8]["bound_by"], library_ms=None)]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
