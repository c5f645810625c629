#!/usr/bin/env python3
"""Where one frame and one train step of the port's main paths spend their
time, on one GPU.

    python3 profile_frame.py [--frames 3] [--steps 3] [--reps 5]
    python3 profile_frame.py --train-witness

Frame: renders the bench view of `chip_smoke.py` (200k gaussians, 640x360,
the `render_frame` inputs: RGB + 3 seg channels) and prints JSON lines:

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

Train step: the step of `cli train` on the bench scene as `chip_smoke.py`
trains it (200k gaussians initialised from a perturbed cloud, an
800k-row table, 640x360 cameras at orbit radius 6): the first-timestep
step at K = 8 emission slots and at K = 64, where the trainer's K
escalation ends, and a later-timestep step (t > 0: the kNN graph built
and the state extrapolated as `train` does it) at K = 64:

  * `train_stages`: loss (render forward and losses), backward (autograd
    through K2 and the projection), update (dead-row mask, Adam, the
    densification statistics) and step (`make_train_step`'s whole step),
    at t > 0 also physics (`physics_losses` forward and its gradient
    alone), host clock, synchronised, median over --reps;
  * `train_profile`: the `torch.profiler` summary of --steps steps.

With --train-witness it runs only `chip_smoke.py`'s `cli train` on the
bench layout, at orbit radius 4 (the synthetic layout's default) and 6
(the smoke's), each through the kernels (`raster.method` "pallas") and
through their plain versions ("torch"), and prints one `train_witness`
line per run: the loss per report and the PSNR of every view before and
after, so that the kernel path's training is held against the plain
path's at full width.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
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
from dynamic3dgaussians_tpu_torch.tools.bench_sol import smi_line
from dynamic3dgaussians_tpu_torch.viz.render import render_frame, to_uint8

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


def train_setup(dev):
    """Bench-scene training state and one ground-truth camera datapoint."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    scene = cs.bench_scene()
    seg = scene["seg_colors"][:, 0]
    gt = dict(means=scene["means"], colors=scene["colors"],
              opac=scene["opac"], scales=scene["scales"],
              quats=scene["quats"], seg=seg, n_fg=int(seg.sum()))
    data, w2c, _ = synthetic.make_dataset(
        gt, 1, num_cams=cs.TRAIN_CAMS, w=cs.W, h=cs.H, f=cs.F, radius=cs.TRAIN_RADIUS,
        device=dev)
    params, variables = G.init_params(synthetic.init_point_cloud(gt), w2c,
                                      device=dev)
    return params, variables, optim.init(params), data[0][0]


def later_state(state):
    """The t = 0 state carried into t = 1 as `train` carries it: the kNN
    graph and the foreground-first reorder, then the extrapolation."""
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    params, variables, opt_state = state
    params, variables, opt_state = T.initialize_post_first_timestep(
        params, variables, TrainConfig(), opt_state)
    return T.initialize_per_timestep(params, variables, opt_state)


def physics_ms(params, variables):
    """ms of `physics_losses` and its gradient alone."""
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import losses as L
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in ("means3D", "unnorm_rotations", "rgb_colors")}

    def run():
        act = G.activated(dict(params, **leaves), variables["alive"])
        out = L.physics_losses(act["means3d"], act["rotations"],
                               leaves["rgb_colors"], variables,
                               params["seg_colors"][:, 0] > 0.5,
                               variables["alive"])
        return torch.autograd.grad(sum(out.values()), list(leaves.values()))
    return timed(run)[1]


def train_stage_times(state, batch, k_slots, dev, is_initial=True):
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import densify, optim
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    params, variables, opt_state = state
    cfg = TrainConfig(num_timesteps=1 if is_initial else 2,
                      raster=RasterSettings(max_tiles_per_gaussian=k_slots))
    rcfg = T.raster_config(cfg)
    lrs = {k: torch.tensor(cfg.lrs.get(k, 0.0), device=dev) for k in params}
    keys = list(params)
    times = {}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    probe = torch.zeros((variables["alive"].shape[0], 2), device=dev,
                        requires_grad=True)
    (loss, aux), times["loss"] = timed(lambda: T.compute_loss(
        leaves, probe, batch, variables, is_initial=is_initial, cfg=cfg,
        rcfg=rcfg))
    grads, times["backward"] = timed(lambda: torch.autograd.grad(
        loss, [leaves[k] for k in keys] + [probe], allow_unused=True))

    def update():
        with torch.no_grad():
            alive = variables["alive"]
            gp = {k: torch.zeros_like(params[k]) if g is None else (
                g if k in G.CAMERA_KEYS else torch.where(
                    alive.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                    torch.zeros_like(g))) for k, g in zip(keys, grads[:-1])}
            optim.step(params, gp, opt_state, lrs)
            densify.accumulate_stats(variables, grads[-1], aux["radii"])
    _, times["update"] = timed(update)
    step = T.make_train_step(cfg, rcfg)
    _, times["step"] = timed(lambda: step(params, opt_state, variables,
                                          batch, lrs, is_initial))
    if not is_initial:
        times["physics"] = physics_ms(params, variables)
    times["n_dropped_rect"] = int(aux["n_dropped_rect"])
    return times, (lambda: step(params, opt_state, variables, batch, lrs,
                                is_initial))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train-witness", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = smi_line()
    if args.train_witness:
        scene = cs.bench_scene()
        for radius in (4.0, 6.0):
            for method in ("pallas", "torch"):
                with tempfile.TemporaryDirectory() as tmp:
                    rec = cs.train_bench(scene, dev, tmp, radius=radius,
                                         method=method)
                print(json.dumps(dict(phase="train_witness", card=smi,
                                      **rec)), flush=True)
        return 0
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
    print(json.dumps(dict(phase="profile", card=smi, **cs.profile_calls(
        lambda: to_uint8(render_frame(params, cam, device=dev).rgb),
        args.frames))), flush=True)

    params_t, variables, opt_state, batch = train_setup(dev)
    state = (params_t, variables, opt_state)
    later = later_state(state)
    for k_slots, st, is_initial in ((8, state, True), (64, state, True),
                                    (64, later, False)):
        train_stage_times(st, batch, k_slots, dev, is_initial)   # warm
        runs = [train_stage_times(st, batch, k_slots, dev, is_initial)[0]
                for _ in range(args.reps)]
        stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(json.dumps(dict(phase="train_stages", k_slots=k_slots,
                              t="0" if is_initial else ">0", ms=stages,
                              reps=args.reps, card=smi)), flush=True)
        _, step_fn = train_stage_times(st, batch, k_slots, dev, is_initial)
        print(json.dumps(dict(phase="train_profile", k_slots=k_slots,
                              t="0" if is_initial else ">0", card=smi,
                              **cs.profile_calls(step_fn, args.steps))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
