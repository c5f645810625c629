"""A scale run: 30k initial gaussians at 400x400 with densification.

    python -m dynamic3dgaussians_tpu_torch.tools.scale_run [--n 30000]
        [--gt_mult 1] [--hw 400] [--cams 6] [--iters 500] [--report 50]
        [--min_gain_db 2.0] [--densify_every 100] [--densify_end 0]
        [--k_cap 16] [--pairs_cap 0] [--max_per_tile 2048] [--out F.json]
        [--device cuda]

The port of `tools/scale_run.py`: a synthetic ground-truth scene of
n * gt_mult gaussians (seed 0) rendered by `--cams` cameras at `--hw` x
`--hw` (one timestep), then a noised initial cloud of n points optimised
by its own loop over `train/trainer.py::make_train_step`: densification
at the reference cadence (`train/densify.py`, its split noise from a
`torch.Generator` seeded with 0, as the trainer seeds one), the tables
grown (`models/gaussians.py::grow_capacity`) whenever a pass runs out of
free slots, and K escalation at report steps: K doubles (up to 64) when a
report shows rect drops since the last one, the pair budget tracking K
unless `--pairs_cap` pins it. The drop counts are summed on the device
and read only at reports: no host sync per step.

The log (`psnr` at each report, `densify` events, `grow_tiles` events,
`n_dropped`, `n_dropped_rect`, `psnr_gain_db`, `final_alive`,
`final_capacity`, and `rect_split`: at each report, the rect drops of
the report step's view rendered again from all rows and from the alive
rows alone, the dead rows' phantom drops apart) is written at every
report; the tool exits non-zero
when PSNR rises by less than `--min_gain_db`.

CPU smoke: `python -m dynamic3dgaussians_tpu_torch.tools.scale_run
--device cpu --n 2000 --hw 96 --iters 150 --report 25
--densify_every 50`.

`pack_records=True`, as in the reference's tool (the f16 record and
bf16 gradient transport of `ops/sorted_raster.py`); `--pairs_cap` and
`--max_per_tile` size only the tiled path and are kept in the config as
given; the XLA compilation cache is dropped. The default `--out` is
`artifacts/torch_scale_run_<device type>.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from dynamic3dgaussians_tpu_torch.tools.dynamic_run import (default_out,
                                                            rect_drop_split)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="scale_run")
    ap.add_argument("--n", type=int, default=30_000)
    # the ground truth holds n * gt_mult gaussians, the initial cloud n of
    # them, so densification must grow the model to fit
    ap.add_argument("--gt_mult", type=int, default=1)
    ap.add_argument("--hw", type=int, default=400)
    ap.add_argument("--cams", type=int, default=6)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--report", type=int, default=50)
    ap.add_argument("--min_gain_db", type=float, default=2.0)
    ap.add_argument("--densify_every", type=int, default=100)
    # 0: the reference window min(iters, 5000)
    ap.add_argument("--densify_end", type=int, default=0)
    ap.add_argument("--k_cap", type=int, default=16)
    # the tiled path's pair budget (0: track K as it escalates)
    ap.add_argument("--pairs_cap", type=int, default=0)
    ap.add_argument("--max_per_tile", type=int, default=2048)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def build_data(args, device):
    """(dataset, w2c, init cloud): the scene rendered at one timestep on
    `device` and the noised initial cloud, subsampled to n points when
    the ground truth holds more."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    n_gt = args.n * args.gt_mult
    scene = synthetic.make_gt_scene(n_fg=n_gt // 2, n_bg=n_gt // 2, seed=0)
    dataset, w2c, _ = synthetic.make_dataset(
        scene, num_t=1, num_cams=args.cams, w=args.hw, h=args.hw,
        f=float(args.hw) * 0.9, device=device)
    pt = synthetic.init_point_cloud(scene, noise=0.03)
    if args.gt_mult > 1:
        sel = np.random.RandomState(2).choice(len(pt), args.n,
                                              replace=False)
        pt = pt[np.sort(sel)]
    return dataset, w2c, pt


def build_config(args):
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    return TrainConfig(
        num_timesteps=1, iters_first_timestep=args.iters,
        capacity=G.round_capacity(args.n * 2),
        densify_start=100, densify_every=args.densify_every,
        densify_end=(args.densify_end or min(args.iters, 5000)),
        grow_capacity=True,
        raster=RasterSettings(tile_h=16, tile_w=16, chunk=128,
                              max_tiles_per_gaussian=args.k_cap,
                              pairs_per_gaussian=(args.pairs_cap
                                                  or args.k_cap),
                              max_per_tile=args.max_per_tile,
                              pack_records=True))


def run(args) -> dict:
    """Optimise and write the log; returns it, or raises SystemExit when
    the PSNR gain is below `--min_gain_db`."""
    import torch

    from dynamic3dgaussians_tpu_torch.device import resolve_device
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train.trainer import (
        MAX_TILES_PER_GAUSSIAN, densify_with_growth, make_train_step,
        raster_config)

    dev = resolve_device(args.device)
    t0 = time.time()
    dataset, w2c, pt = build_data(args, dev)
    t_data = time.time() - t0

    cfg = build_config(args)
    rcfg = raster_config(cfg)
    params, variables = G.init_params(pt, w2c, capacity=cfg.capacity,
                                      device=dev)
    opt_state = optim.init(params)
    step = make_train_step(cfg, rcfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    radius = float(variables["scene_radius"])
    lrs = {k: torch.tensor(cfg.lrs.get(k, 0.0)
                           * (radius if k == "means3D" else 1.0),
                           dtype=torch.float32, device=dev) for k in params}

    rng = np.random.RandomState(0)
    log = {"backend": dev.type, "n_init": args.n, "hw": args.hw,
           "cams": args.cams, "iters": args.iters, "t_data_s": t_data,
           "psnr": [], "densify": [], "grow_tiles": [], "n_dropped": 0,
           "n_dropped_rect": 0, "rect_split": []}
    t_train = time.time()
    out = args.out or default_out("scale_run", dev)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def flush():
        with open(out, "w") as f:
            json.dump(log, f, indent=1)

    todo = []
    # summed on the device, read at reports: drops on the steps between
    # reports still count
    rect_accum = torch.zeros((), dtype=torch.int32, device=dev)
    drop_accum = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(args.iters):
        if not todo:
            todo = list(rng.permutation(len(dataset[0])))
        batch = dataset[0][todo.pop()]
        params, opt_state, variables, metrics = step(
            params, opt_state, variables, batch, lrs, True)
        rect_accum = rect_accum + metrics["n_dropped_rect"]
        drop_accum = drop_accum + metrics["n_dropped"]
        if cfg.densify_start <= i <= cfg.densify_end and \
                i % cfg.densify_every == 0:
            params, variables, opt_state, ds = densify_with_growth(
                params, variables, opt_state, i, cfg, gen)
            log["densify"].append(
                {"i": i, "alive": int(ds.n_alive),
                 "cloned": int(ds.n_cloned), "split": int(ds.n_split),
                 "pruned": int(ds.n_pruned),
                 "dropped": int(ds.n_dropped_capacity),
                 "capacity": int(variables["alive"].shape[0])})
        if i % args.report == 0 or i == args.iters - 1:
            p = float(metrics["psnr"])
            log["psnr"].append({"i": i, "psnr": round(p, 3)})
            log["n_dropped"] += int(drop_accum)
            nd_rect = int(rect_accum)
            log["n_dropped_rect"] += nd_rect
            rect_accum = torch.zeros_like(rect_accum)
            drop_accum = torch.zeros_like(drop_accum)
            # the report step's view again, all rows and alive rows alone
            log["rect_split"].append(dict(
                i=i, **rect_drop_split(params, variables, batch, cfg)))
            # K escalation: the original never truncates a tile rect, so
            # double K and rebuild the step when a report shows truncation
            k = cfg.raster.max_tiles_per_gaussian
            if nd_rect > 0 and k < MAX_TILES_PER_GAUSSIAN:
                new_k = min(k * 2, MAX_TILES_PER_GAUSSIAN)
                new_pairs = (min(args.pairs_cap, new_k) if args.pairs_cap
                             else new_k)
                new_pairs = max(new_pairs, cfg.raster.pairs_per_gaussian)
                cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
                    cfg.raster, max_tiles_per_gaussian=new_k,
                    pairs_per_gaussian=new_pairs))
                rcfg = raster_config(cfg)
                step = make_train_step(cfg, rcfg)
                log["grow_tiles"].append({"i": i, "k": new_k,
                                          "dropped_rect": nd_rect})
                print(f"iter {i}: rect drops {nd_rect} -> K={new_k}",
                      flush=True)
            print(f"iter {i}: psnr {p:.2f} alive "
                  f"{int(variables['alive'].sum())}", flush=True)
            log["t_train_s"] = round(time.time() - t_train, 1)
            flush()
    log["t_train_s"] = round(time.time() - t_train, 1)
    log["it_per_s"] = round(args.iters / max(log["t_train_s"], 1e-9), 2)

    first, last = log["psnr"][0]["psnr"], log["psnr"][-1]["psnr"]
    log["psnr_gain_db"] = round(last - first, 3)
    log["final_alive"] = int(variables["alive"].sum())
    log["final_capacity"] = int(variables["alive"].shape[0])
    log["completed"] = True  # every configured iteration ran
    flush()
    print(f"wrote {out}: psnr {first:.2f} -> {last:.2f} "
          f"({log['it_per_s']} it/s, dropped={log['n_dropped']})")
    if last - first < args.min_gain_db:
        raise SystemExit(
            f"PSNR gain {last - first:.2f} dB < {args.min_gain_db}")
    return log


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
