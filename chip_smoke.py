#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `dynamic3dgaussians_tpu_torch/csrc/`,
holds each kernel against its plain PyTorch version at the shapes the main
path gives it, drives the main path (`cli visualize` on a 200k-gaussian,
3-timestep checkpoint at 640x360) and checks that it went through the
kernels. Prints one JSON object per phase; the last line is
`{"ok": true, "device": {...}}`. Any failure propagates and exits non-zero,
as does a machine without CUDA. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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


def k1_work(rec_t, starts, counts, n_active, n_val):
    """Operations and bytes K1 needs on these inputs (for the bound).

    Every record walked (in-segment, in a processed chunk) costs each of the
    tile's P pixels the alpha chain and its gate: 16 float32 operations
    (2 sub, 5 quad, 5 power incl. min, exp2, mul, min, compare). A cell that
    passes the gate adds 1-alpha, log2, add, exp2, mul, the running-sum add
    and CV multiply-adds: 6 + 2*CV. Transcendentals count as one operation,
    so this is a lower bound. Bytes: the table read once, the outputs
    written once.
    """
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
    flops = walked_cells * 16 + live_cells * (6 + 2 * n_val)
    n_tiles = s.shape[0]
    bytes_ = (rec_t.numel() * 4 + 2 * n_tiles * 4
              + n_tiles * p * (n_val + 1) * 4 + n_tiles * 4)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    return dict(walked_cells=walked_cells, live_cells=live_cells,
                walked_records_max_tile=int(walked.max()),
                walked_records_mean_tile=float(walked.float().mean()),
                flops=flops, bytes=bytes_,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_k1(scene, extra_key, device, smi):
    """K1 against its plain version at full width on the bench view."""
    import torch
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
        composite_tiles, composite_tiles_torch)
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
    n_chan = chans.shape[1]
    n_val = rec_t.shape[0] - 8
    kw = dict(num_tiles=starts.shape[0], grid_w=-(-W // TILE), tile_h=TILE,
              tile_w=TILE, chunk=CHUNK)
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
    work = k1_work(rec_t, starts, counts, nact_k, n_val)
    rec = dict(phase="k1_vs_plain", cv=n_val, extra=extra_key,
               n_pairs=int(counts.sum()), ne_pad=rec_t.shape[1],
               n_dropped_rect=int(drops), err_chan=err_chan,
               err_depth=err_depth, err_logt=err_logt,
               n_active_equal=nact_equal, n_active_maxdiff=nact_maxdiff,
               tol=dict(chan=ATOL_CHAN, depth=ATOL_DEPTH, log_t=ATOL_LOGT,
                        n_active_equal=NACT_EQUAL_MIN),
               ms=ms, plain_ms=plain_ms, card=smi, **work)
    emit(rec)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


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
        t_start = time.perf_counter()
        cli.main(["visualize", "--params", path, "--out", gif] + flags)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t_start
        launches = {"raster_fwd": composite_tiles.launches}
        gif_bytes = os.path.getsize(gif)
        stacked = load_params(path)
    if launches["raster_fwd"] != n_frames:
        raise AssertionError(f"cli visualize launched K1 "
                             f"{launches['raster_fwd']} times for "
                             f"{n_frames} frames")

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
    ptxas = [ln.strip() for ln in report.splitlines()
             if any(s in ln for s in ("registers", "spill", "Compiling",
                                      "smem", "Function properties"))]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=os.path.relpath(lib_path, REPO),
              fresh=bool(report), ptxas=ptxas))

    scene = bench_scene()
    k1 = {}
    for extra_key in ("seg_colors", "feats"):
        rec = phase_k1(scene, extra_key, device, smi)
        k1[rec["cv"]] = rec
    phase_oracle(device)
    main_rec = phase_main_path(scene, device, smi)

    main_cv = k1[8]   # render_frame passes RGB + 3 seg channels: CV = 8
    emit({"kernels": [dict(
        name="raster_fwd", route="cuda",
        source="dynamic3dgaussians_tpu_torch/csrc/raster_fwd.cu",
        replaces="dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py:419",
        launches=main_rec["launches"]["raster_fwd"],
        max_abs_err=max(main_cv["err_chan"], main_cv["err_depth"]),
        ms=main_cv["ms"], plain_ms=main_cv["plain_ms"],
        bound_ms=main_cv["bound_ms"], bound_by=main_cv["bound_by"],
        library_ms=None)]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
