"""A long dynamic sequence at realistic N, on one GPU.

    python -m dynamic3dgaussians_tpu_torch.tools.dynamic_run [--n 50000]
        [--timesteps 12] [--iters0 2000] [--iters 500] [--cams 8]
        [--hw 256] [--k_cap 8] [--no_densify] [--out F.json]
        [--save_params F.npz] [--device cuda]

The port of `tools/dynamic_run.py`: the synthetic ground-truth scene
(`data/synthetic.py`, n/2 foreground and n/2 background gaussians, seed 0)
rendered into `--timesteps` timesteps seen by `--cams` cameras at
`--hw` x `--hw`, then `train/trainer.py::train` over every timestep with
the full physics-loss set: per-timestep forward extrapolation, the frozen
post-t0 kNN graph and the per-timestep Adam reset at scale. The log
(`backend`, the run's settings, `steps` at each report and
`per_timestep`: `t`, `wall_s`, `n_alive`, `it_per_s`, `final_psnr`) is
written after every timestep, so a run that is cut keeps what it reached.
`--save_params` writes the stacked per-timestep params npz that
`tools/tracking_eval.py` reads.

CPU smoke: `python -m dynamic3dgaussians_tpu_torch.tools.dynamic_run
--device cpu --n 2000 --timesteps 3 --iters0 40 --iters 20 --hw 96`.

The reference's settings that exist for the TPU, and what they become:

  * `pack_records=True` (the bf16 record pack) becomes False: the port's
    records are float32 and its config raises on True.
  * `pairs_budget_cap` (16 on the reference's CPU) becomes 0: it sizes
    only the tiled path, which this tool does not take.
  * `--steps_per_call` W runs windows of W steps between host actions,
    as the reference's (`train/trainer.py`): on the card one captured CUDA
    graph of the step replayed W times, the same steps' result.
  * The XLA compilation cache (`compile_cache.enable()`) is dropped.

The default `--out` is `artifacts/torch_dynamic_run_<device type>.json`,
beside and never over the reference tool's `dynamic_run_<backend>.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="dynamic_run")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--timesteps", type=int, default=12)
    ap.add_argument("--iters0", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--k_cap", type=int, default=8)
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="steps per window between host actions (on the "
                    "card: replays of one captured CUDA graph)")
    ap.add_argument("--no_densify", action="store_true",
                    help="freeze capacity (the initial N is the target "
                    "scale)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--save_params", type=str, default=None,
                    help="write the stacked per-timestep params npz here "
                    "(the input of tools/tracking_eval.py)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def default_out(tool: str, device) -> str:
    """artifacts/torch_<tool>_<device type>.json under the repository."""
    return os.path.join(REPO, "artifacts",
                        f"torch_{tool}_{device.type}.json")


def rect_drop_split(params, variables, frame, cfg) -> dict:
    """The rect drops of one forward render of `frame`'s camera at `cfg`'s
    K, of all the table's rows and of its alive rows alone. Dead rows pass
    no alpha gate, yet the emission counts their rects: `all_rows -
    live_rows` are those phantom drops. Two K1 launches on the card."""
    import torch

    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train.trainer import raster_config
    alive = variables["alive"]
    act = G.activated(params, alive)
    args = [act[k] for k in ("means3d", "colors", "opacity", "scales",
                             "rotations")]
    kw = dict(config=raster_config(cfg),
              method=cfg.raster.render_method(), device=alive.device)
    with torch.no_grad():
        every = render(frame["camera"], *args, **kw)
        live = render(frame["camera"], *[a[alive] for a in args], **kw)
    return {"k": cfg.raster.max_tiles_per_gaussian,
            "rows": int(alive.shape[0]), "alive": int(alive.sum()),
            "all_rows": int(every.n_dropped_rect),
            "live_rows": int(live.n_dropped_rect)}


def build_data(args, device):
    """(dataset, w2c, init cloud) of the run: the scene, its renders per
    timestep and camera on `device`, and the noised initial cloud."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    scene = synthetic.make_gt_scene(n_fg=args.n // 2, n_bg=args.n // 2,
                                    seed=0)
    dataset, w2c, _ = synthetic.make_dataset(
        scene, num_t=args.timesteps, num_cams=args.cams, w=args.hw,
        h=args.hw, f=float(args.hw) * 0.9, device=device)
    pt = synthetic.init_point_cloud(scene, noise=0.02)
    return dataset, w2c, pt


def build_config(args):
    """The run's TrainConfig: the reference tool's, with the mappings of
    the module docstring."""
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)
    return TrainConfig(
        num_timesteps=args.timesteps,
        iters_first_timestep=args.iters0,
        iters_per_timestep=args.iters,
        capacity=G.round_capacity(int(args.n * 1.3)),
        densify_start=(10**9 if args.no_densify else 100),
        densify_every=100,
        densify_end=(0 if args.no_densify else min(args.iters0, 5000)),
        grow_capacity=True, report_every=100,
        steps_per_call=args.steps_per_call,
        pairs_budget_cap=0,
        raster=RasterSettings(tile_h=16, tile_w=16, chunk=128,
                              max_tiles_per_gaussian=args.k_cap,
                              pack_records=False))


def run(args, callbacks: Optional[Dict] = None) -> dict:
    """Train the sequence and write the log; returns the log. `callbacks`
    (the trainer's) are called after the tool's own."""
    from dynamic3dgaussians_tpu_torch.device import resolve_device
    from dynamic3dgaussians_tpu_torch.train.trainer import train

    dev = resolve_device(args.device)
    extra = callbacks or {}
    hw = args.hw
    t0 = time.time()
    dataset, w2c, pt = build_data(args, dev)
    t_data = time.time() - t0
    cfg = build_config(args)

    log = {"backend": dev.type, "n_init": args.n, "hw": hw,
           "cams": args.cams, "timesteps": args.timesteps,
           "iters0": args.iters0, "iters": args.iters,
           "steps_per_call": args.steps_per_call,
           "t_data_s": round(t_data, 1), "steps": [], "per_timestep": []}
    t_state = {"start": time.time()}
    out = args.out or default_out("dynamic_run", dev)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def flush():
        # after every timestep: a run that is cut keeps what it reached
        with open(out, "w") as f:
            json.dump(log, f, indent=1)

    def on_step(t, i, metrics):
        psnr, loss = float(metrics["psnr"]), float(metrics["loss"])
        log["steps"].append({"t": t, "i": i, "psnr": round(psnr, 3),
                             "loss": round(loss, 5)})
        print(f"t={t} i={i} psnr={psnr:.2f}", flush=True)

    def on_timestep(t, params, variables):
        now = time.time()
        iters = args.iters0 if t == 0 else args.iters
        dt = now - t_state["start"]
        t_state["start"] = now
        n_alive = int(variables["alive"].sum())
        last = [s["psnr"] for s in log["steps"] if s["t"] == t]
        log["per_timestep"].append({
            "t": t, "wall_s": round(dt, 1), "n_alive": n_alive,
            "it_per_s": round(iters / dt, 2),
            "final_psnr": last[-1] if last else None})
        print(f"== timestep {t}: {dt:.1f}s ({iters / dt:.1f} it/s), "
              f"alive={n_alive}", flush=True)
        flush()

    own = {"on_step": on_step, "on_timestep": on_timestep}
    names = set(own) | set(extra)

    def chain(name):
        fns = [f for f in (own.get(name), extra.get(name)) if f]

        def call(*a):
            for f in fns:
                f(*a)
        return call

    out_params = train(dataset, cfg, pt, w2c,
                       callbacks={n: chain(n) for n in names},
                       device=dev)[0]
    if args.save_params:
        from dynamic3dgaussians_tpu_torch.viz.export import save_params
        d, fn = os.path.split(args.save_params)
        p = save_params(out_params, d or ".",
                        fn[:-4] if fn.endswith(".npz") else fn)
        log["params_npz"] = p
        print(f"saved stacked params -> {p}", flush=True)
    log["t_total_s"] = round(time.time() - t0, 1)
    log["final_alive"] = log["per_timestep"][-1]["n_alive"]
    log["completed"] = True  # every configured timestep ran
    flush()
    tail = [p["final_psnr"] for p in log["per_timestep"]]
    print(f"wrote {out}; per-timestep psnr {tail}")
    return log


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
