"""Command-line entry points of the port.

  python -m dynamic3dgaussians_tpu_torch.cli train --data_root data \
      --seq cmu_bike --exp exp1 [--timesteps 3] [--checkpoint_every N] \
      [--resume] [--device cuda]
  python -m dynamic3dgaussians_tpu_torch.cli visualize \
      --params output/exp1/seq/params.npz [--out orbit.gif] \
      [--resort-every N] [--device cuda]
  python -m dynamic3dgaussians_tpu_torch.cli view \
      --params output/exp1/seq/params.npz [--port 8000] [--device cuda]
  python -m dynamic3dgaussians_tpu_torch.cli view --gui_host 127.0.0.1 \
      [--gui_port 6009]
  python -m dynamic3dgaussians_tpu_torch.cli evaluate \
      --params output/exp1/seq/params.npz --data_root data --seq cmu_bike
  python -m dynamic3dgaussians_tpu_torch.cli evaluate-suite \
      --pairs seqA=a/params.npz,seqB=b/params.npz --data_root data

`train` fits every timestep of a sequence in the reference data layout
(or the built-in synthetic scene), the first from the initial point cloud
and each later one from its predecessor under the physics losses, and
writes the reference's stacked `<output>/<exp>/<seq>/params.npz`, with
`cfg_args.json` and `metrics.jsonl` beside it; its flags are the
reference's `train` flags, plus `--time_steps`, which logs each step's
wall time. `--checkpoint_every N` saves the full training state every N
steps under `<output>/<exp>/<seq>/ckpt`, and `--resume` restarts from the
latest one there. On a data root the images stream through the native
prefetching loader when its library builds (`native.py`).
`visualize` orbit-renders a stacked params.npz to a GIF, with
`--resort-every N > 1` through the cached-order playback path (a sort
every N frames, and on every timestep change). `view` serves a params.npz
to a browser (orbit, zoom, render modes, timestep playback), or with
`--gui_host` bridges a browser to a training loop's network GUI.
`evaluate` renders every (timestep, camera) view of a trained sequence and
prints its mean
PSNR and SSIM as JSON; `evaluate-suite` does so for many (seq, params.npz)
pairs. All run on `cuda` unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_train_cfg_args(p: argparse.ArgumentParser):
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--iters_first", type=int, default=None)
    p.add_argument("--iters_per_t", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--config_json", type=str, default=None,
                   help="TrainConfig overrides as a JSON file")


def load_run_config(model_dir):
    """The TrainConfig saved beside a previous run's outputs."""
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    with open(os.path.join(model_dir, "cfg_args.json")) as f:
        return TrainConfig.from_json(f.read())


def _build_cfg(args):
    from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
    cfg = TrainConfig()
    if getattr(args, "model_dir", None):
        cfg = load_run_config(args.model_dir)
    if args.config_json:
        # overlay: only the keys present in the JSON override the base
        with open(args.config_json) as f:
            over = json.load(f)
        for k, v in over.items():
            if not hasattr(cfg, k):
                raise SystemExit(f"unknown config field {k!r} in "
                                 f"{args.config_json}")
            if k == "raster":
                fields = {f.name for f in dataclasses.fields(cfg.raster)}
                for rk in v:
                    if rk not in fields:
                        raise SystemExit(f"unknown config field "
                                         f"'raster.{rk}' in "
                                         f"{args.config_json}")
                cfg.raster = dataclasses.replace(cfg.raster, **v)
            elif k in ("lrs", "loss_weights"):
                # per-key override: a partial dict must not drop defaults
                merged = dict(getattr(cfg, k))
                merged.update(v)
                setattr(cfg, k, merged)
            elif k == "freeze_after_t0":
                cfg.freeze_after_t0 = tuple(v)
            else:
                setattr(cfg, k, v)
    if args.timesteps is not None:
        cfg.num_timesteps = args.timesteps
    if args.iters_first is not None:
        cfg.iters_first_timestep = args.iters_first
    if args.iters_per_t is not None:
        cfg.iters_per_timestep = args.iters_per_t
    if args.capacity is not None:
        cfg.capacity = args.capacity
    return cfg


def cmd_train(args):
    import time

    import numpy as np
    import torch

    from dynamic3dgaussians_tpu_torch.device import resolve_device
    from dynamic3dgaussians_tpu_torch.models.gaussians import activated
    from dynamic3dgaussians_tpu_torch.ops.rasterize import render
    from dynamic3dgaussians_tpu_torch.train.trainer import train
    from dynamic3dgaussians_tpu_torch.utils.logging import (RunLogger,
                                                            safe_state)
    from dynamic3dgaussians_tpu_torch.viz.export import save_params
    from dynamic3dgaussians_tpu_torch.viz.render import to_uint8

    dev = resolve_device(args.device)
    cfg = _build_cfg(args)
    safe_state(cfg.seed)
    out_dir = os.path.join(args.output, args.exp, args.seq)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cfg_args.json"), "w") as f:
        f.write(cfg.to_json())

    loader = None
    if args.synthetic:
        from dynamic3dgaussians_tpu_torch.data import synthetic
        scene = synthetic.make_gt_scene()
        dataset, w2c, _ = synthetic.make_dataset(
            scene, cfg.num_timesteps, num_cams=args.num_cams, device=dev)
        pt_cld = synthetic.init_point_cloud(scene)
    else:
        from dynamic3dgaussians_tpu_torch import native
        from dynamic3dgaussians_tpu_torch.data import dataset as D
        md = D.load_meta(args.data_root, args.seq)
        cfg.num_timesteps = min(cfg.num_timesteps, len(md["fn"]))
        loader = native.FileLoader() if native.available() else None

        def dataset(t, _md=md):     # per-timestep stream, t + 1 prefetched
            return D.load_timestep(args.data_root, args.seq, _md, t,
                                   load_depth=args.load_depth, loader=loader,
                                   prefetch_next=True, device=dev)

        pt_cld = D.load_init_point_cloud(args.data_root, args.seq)
        w2c = D.scene_w2c_stack(md)

    logger = RunLogger(out_dir, use_wandb=args.wandb)

    def on_step(t, i, metrics):
        logger.log(i, {k: float(v) for k, v in metrics.items()},
                   prefix=f"t{t}/")
        if i % (cfg.report_every * 5) == 0:
            print(f"t={t} i={i} loss={float(metrics['loss']):.4f} "
                  f"psnr={float(metrics['psnr']):.2f}", flush=True)

    def on_densify(t, i, stats):
        logger.log(i, {k: int(v) for k, v in stats._asdict().items()},
                   prefix=f"t{t}/densify/")

    def on_grow_tiles(t, i, new_k):
        logger.log(i, {"max_tiles_per_gaussian": new_k},
                   prefix=f"t{t}/grow_tiles/")

    def on_graph(t, timings):
        logger.log(0, timings, prefix=f"t{t}/graph/")

    last_step_end = [None, None]        # (host clock, step index)

    def on_iter(t, i, k):
        # the wall time of one iteration of the loop (step, densify, report),
        # from the end of the previous one, per step (a window of
        # steps_per_call steps calls this once, after its last): the first
        # call of each timestep is not timed
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if last_step_end[0] is not None:
            n = i - last_step_end[1]
            logger.log(i, {"step_ms": (now - last_step_end[0]) * 1e3 / n,
                           "k": k}, prefix=f"t{t}/time/")
        last_step_end[:] = [now, i]

    get_frames = dataset if callable(dataset) else dataset.__getitem__

    def on_timestep(t, params, variables):
        last_step_end[0] = None
        # render-vs-GT panel of the finished timestep
        frame = get_frames(t)[0]
        with torch.no_grad():
            act = activated(params, variables["alive"])
            out = render(frame["camera"], act["means3d"], act["colors"],
                         act["opacity"], act["scales"], act["rotations"],
                         device=dev)
        panel = np.concatenate([to_uint8(out.rgb), to_uint8(frame["im"])],
                               axis=1)
        logger.log_image(t, f"panel_t{t}", panel)

    callbacks = {"on_step": on_step, "on_densify": on_densify,
                 "on_grow_tiles": on_grow_tiles, "on_graph": on_graph,
                 "on_timestep": on_timestep}
    if args.time_steps:
        callbacks["on_iter"] = on_iter
    output_params, _, _ = train(
        dataset, cfg, pt_cld, w2c, callbacks=callbacks,
        checkpoint_dir=os.path.join(out_dir, "ckpt")
        if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        device=dev)
    path = save_params(output_params, out_dir)
    print(f"saved {path}")
    logger.close()
    if loader is not None:
        loader.close()
    return path


def cmd_visualize(args):
    from dynamic3dgaussians_tpu_torch.viz.export import load_params
    from dynamic3dgaussians_tpu_torch.viz.render import orbit_render, save_gif

    stacked = load_params(args.params)
    frames = orbit_render(
        stacked, n_frames=args.frames, w=args.width, h=args.height,
        f=args.focal, radius=args.radius, method="auto",
        resort_every=args.resort_every, device=args.device)
    out = args.out or (os.path.splitext(args.params)[0] + "_orbit.gif")
    save_gif(frames, out, fps=args.fps)
    print(f"saved {out}")
    return frames


def cmd_view(args):
    from dynamic3dgaussians_tpu_torch.device import resolve_device
    from dynamic3dgaussians_tpu_torch.viz import live_viewer

    if not args.gui_host and not args.params:
        raise SystemExit("view: need --params or --gui_host")
    dev = resolve_device(args.device)
    if args.gui_host:
        live_viewer.serve_live(args.gui_host, args.gui_port, args.host,
                               args.port, w=args.width, h=args.height,
                               f=args.focal, device=dev)
    else:
        from dynamic3dgaussians_tpu_torch.viz.export import load_params
        live_viewer.serve(load_params(args.params), args.host, args.port,
                          w=args.width, h=args.height, f=args.focal,
                          device=dev)


def cmd_evaluate(args):
    from dynamic3dgaussians_tpu_torch.eval.suite import evaluate_sequence
    from dynamic3dgaussians_tpu_torch.viz.export import load_params

    stacked = load_params(args.params)
    summary, rows = evaluate_sequence(stacked, args.data_root, args.seq,
                                      max_timesteps=args.max_timesteps,
                                      max_cams=args.max_cams,
                                      device=args.device)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mean_psnr": summary["psnr"],
                       "mean_ssim": summary["ssim"], "rows": rows}, f,
                      indent=2)
    return summary


def cmd_evaluate_suite(args):
    from dynamic3dgaussians_tpu_torch.eval.suite import evaluate_suite

    pairs = []
    for item in args.pairs.split(","):
        seq, _, path = item.partition("=")
        if not path:
            raise SystemExit(f"--pairs item '{item}' must be seq=params.npz")
        pairs.append((seq, path))
    result = evaluate_suite(pairs, args.data_root,
                            max_timesteps=args.max_timesteps,
                            max_cams=args.max_cams, out_path=args.out,
                            device=args.device)
    for seq, sm in result["scenes"].items():
        print(f"{seq}: psnr {sm['psnr']:.2f} ssim {sm['ssim']:.4f}"
              + (f" absrel {sm['depth_abs_rel']:.4f}"
                 if "depth_abs_rel" in sm else ""))
    print(json.dumps({"mean": result["mean"],
                      "n_scenes": len(result["scenes"])}))
    return result


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dynamic3dgaussians_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="per-timestep optimisation of a "
                                     "sequence")
    p.add_argument("--model_dir", type=str, default=None,
                   help="load the TrainConfig of a previous run "
                        "(cfg_args.json) as the base")
    p.add_argument("--data_root", type=str, default="./data_ego")
    p.add_argument("--seq", type=str, default="synthetic")
    p.add_argument("--exp", type=str, default="exp")
    p.add_argument("--output", type=str, default="./output")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the built-in synthetic scene")
    p.add_argument("--num_cams", type=int, default=6)
    p.add_argument("--load_depth", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--time_steps", action="store_true",
                   help="wait for the device after every step and log the "
                        "step's wall time and emission slots K to "
                        "metrics.jsonl (t<t>/time/step_ms, t<t>/time/k)")
    _add_train_cfg_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("visualize", help="orbit-render a params.npz to GIF")
    p.add_argument("--params", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--focal", type=float, default=500.0)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--fps", type=int, default=20)
    p.add_argument("--resort-every", type=int, default=1,
                   help="cached-order playback interval: >1 sorts every N "
                        "frames and renders the frames between through the "
                        "frozen order (ops/playback.py)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("view", help="interactive browser viewer (orbit, "
                                    "zoom, render modes, playback)")
    p.add_argument("--params", type=str, default=None,
                   help="stacked params.npz to serve")
    p.add_argument("--gui_host", type=str, default=None,
                   help="bridge to a live training loop's network GUI "
                        "instead")
    p.add_argument("--gui_port", type=int, default=6009)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--focal", type=float, default=500.0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("evaluate", help="PSNR/SSIM vs dataset images")
    p.add_argument("--params", type=str, required=True)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--seq", type=str, required=True)
    p.add_argument("--max_timesteps", type=int, default=10)
    p.add_argument("--max_cams", type=int, default=4)
    p.add_argument("--out", type=str, default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("evaluate-suite",
                       help="PSNR/SSIM table over many sequences")
    p.add_argument("--pairs", type=str, required=True,
                   help="comma list of seq=params.npz")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--max_timesteps", type=int, default=10)
    p.add_argument("--max_cams", type=int, default=4)
    p.add_argument("--out", type=str, default=None)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_evaluate_suite)

    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
