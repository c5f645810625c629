#!/usr/bin/env python3
"""Where one frame of the port's main path spends its time, on one GPU.

    python3 profile_frame.py [--frames 3] [--reps 5]

Renders the bench view of `chip_smoke.py` (200k gaussians, 640x360, the
`render_frame` inputs: RGB + 3 seg channels) and prints JSON lines:

  * `stages`: host-clock milliseconds of each stage of `render_frame`,
    each ended by `torch.cuda.synchronize()` (median over --reps): upload
    (numpy params to the card and activation), project, emit (pair
    emission with the exact cull), records (emission + sort + merged
    record table), k1 (the forward tile kernel), frame (the whole
    `render_frame` plus the uint8 copy back to the host, as
    `orbit_render` does it);
  * `profile`: a `torch.profiler` trace of --frames such frames: the
    device's busy and idle share of the window, kernels and host
    synchronisations per frame, and the kernels that take most device
    time.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from dynamic3dgaussians_tpu_torch.convert import params_from_jax
from dynamic3dgaussians_tpu_torch.models.gaussians import activated
from dynamic3dgaussians_tpu_torch.ops.binning import emit_pairs
from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import composite_tiles
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.ops.sorted_raster import sorted_records
from dynamic3dgaussians_tpu_torch.viz.render import render_frame, to_uint8

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def frame_params(scene):
    """One checkpointed timestep in the params.npz layout."""
    o = scene["opac"]
    return {"means3D": scene["means"], "rgb_colors": scene["colors"],
            "seg_colors": scene["seg_colors"],
            "unnorm_rotations": scene["quats"],
            "logit_opacities": np.log(o / (1.0 - o))[:, None],
            "log_scales": np.log(scene["scales"])}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def upload(params, dev):
    p = params_from_jax(params, dev)
    return p, activated(p)


def stage_times(params, cam, dev):
    times = {}
    (p, act), times["upload"] = timed(lambda: upload(params, dev))
    proj, times["project"] = timed(lambda: project(
        act["means3d"], act["scales"], act["rotations"], cam))
    op = torch.where(proj.valid, act["opacity"],
                     torch.zeros_like(act["opacity"]))
    chans = torch.cat([act["colors"], p["seg_colors"]], dim=-1)
    grid_h, grid_w = -(-cs.H // cs.TILE), -(-cs.W // cs.TILE)
    _, times["emit"] = timed(lambda: emit_pairs(
        proj, cs.TILE, cs.TILE, grid_h, grid_w, 8, opacity=op, enum_cap=16))
    (rec_t, starts, counts, _), times["records"] = timed(
        lambda: sorted_records(cs.H, cs.W, proj, chans, op))
    _, times["k1"] = timed(lambda: composite_tiles(
        rec_t, starts, counts, num_tiles=grid_h * grid_w, grid_w=grid_w,
        tile_h=cs.TILE, tile_w=cs.TILE, chunk=cs.CHUNK))
    _, times["frame"] = timed(lambda: to_uint8(
        render_frame(params, cam, device=dev).rgb))
    return times


def profile_frames(params, cam, dev, n_frames):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            to_uint8(render_frame(params, cam, device=dev).rgb)
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
    return dict(
        frames=n_frames, wall_ms_per_frame=wall_ms / n_frames,
        device_events=len(kernels),
        device_busy_ms_per_frame=busy_us / 1e3 / n_frames,
        device_window_ms_per_frame=window_us / 1e3 / n_frames,
        device_idle_share=(1.0 - busy_us / window_us) if window_us else None,
        kernels_per_frame=sum(host.count(n) for n in LAUNCH_CALLS)
        / n_frames,
        syncs_per_frame=sum(host.count(n) for n in SYNC_CALLS) / n_frames,
        top_kernels_ms_per_frame=[
            [name[:90], t / 1e3 / n_frames] for name, t in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = cs.smi_line()
    params = frame_params(cs.bench_scene())
    w2c = np.eye(4)
    w2c[2, 3] = 6.0
    cam = make_camera(cs.W, cs.H, [[cs.F, 0, cs.W / 2], [0, cs.F, cs.H / 2],
                                   [0, 0, 1]], w2c, device=dev)
    stage_times(params, cam, dev)               # warm: build, allocator
    runs = [stage_times(params, cam, dev) for _ in range(args.reps)]
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    stages["sort_and_table"] = stages["records"] - stages["emit"]
    print(json.dumps(dict(phase="stages", ms=stages, reps=args.reps,
                          card=smi)), flush=True)
    print(json.dumps(dict(phase="profile", card=smi,
                          **profile_frames(params, cam, dev, args.frames))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
