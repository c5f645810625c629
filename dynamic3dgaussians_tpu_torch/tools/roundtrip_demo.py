"""The reference-format file round trip, end to end on one GPU.

    python -m dynamic3dgaussians_tpu_torch.tools.roundtrip_demo
        [--out <TMPDIR>/rt_demo] [--iters 400] [--iters_later 120]
        [--timesteps 3] [--cams 6] [--size 128 96] [--artifact F.json]
        [--device cuda]

The port of `tools/roundtrip_demo.py`, each stage through the port's
`cli.main`:

  1. `data/synthetic.py::write_reference_layout` writes the synthetic
     scene in the reference's data layout (train_meta.json, ims/, seg/,
     init_pt_cld.npz) under <out>/data/demo;
  2. `cli train` trains every timestep from those files (the reader path
     of a captured sequence);
  3. the stacked params.npz must hold a 3-dimensional (T, N, 3)
     `means3D`; its key and shape layout is recorded;
  4. `cli visualize` renders a 24-frame orbit of it into <out>/orbit.gif;
  5. `cli evaluate` gives its PSNR and SSIM against the training views.

The summary (the files, the params layout, the evaluation and the
config) goes to `--artifact`, by default
`artifacts/torch_roundtrip_demo_<device type>.json`.

CPU smoke: `python -m dynamic3dgaussians_tpu_torch.tools.roundtrip_demo
--device cpu --iters 20 --iters_later 10 --size 64 48 --cams 4`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from dynamic3dgaussians_tpu_torch.tools.dynamic_run import default_out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="roundtrip_demo")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "rt_demo"))
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--iters_later", type=int, default=120)
    ap.add_argument("--timesteps", type=int, default=3)
    ap.add_argument("--cams", type=int, default=6)
    ap.add_argument("--size", type=int, nargs=2, default=(128, 96))
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    import numpy as np

    from dynamic3dgaussians_tpu_torch import cli
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    dev_flag = ["--device", str(dev)]
    t0 = time.time()
    w, h = args.size
    data_root = os.path.join(args.out, "data")
    base = synthetic.write_reference_layout(
        data_root, "demo", num_t=args.timesteps, num_cams=args.cams,
        w=w, h=h, device=dev)
    n_files = sum(len(fs) for _, _, fs in os.walk(base))
    print(f"[1/4] wrote reference-layout scene at {base} ({n_files} files)")

    cfg = {"iters_first_timestep": args.iters,
           "iters_per_timestep": args.iters_later,
           "num_timesteps": args.timesteps,
           "report_every": 50}
    os.makedirs(args.out, exist_ok=True)
    cfg_path = os.path.join(args.out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = os.path.join(args.out, "output")
    cli.main(["train", "--data_root", data_root, "--seq", "demo",
              "--exp", "rt", "--output", out_dir,
              "--config_json", cfg_path] + dev_flag)
    params_path = os.path.join(out_dir, "rt", "demo", "params.npz")
    print(f"[2/4] trained -> {params_path}")

    with np.load(params_path) as data:
        layout = {k: list(data[k].shape) for k in data.files}
    if len(layout["means3D"]) != 3:
        raise AssertionError(f"params.npz: a stacked (T, N, 3) means3D "
                             f"expected, got {layout['means3D']}")
    print(f"[3/4] params.npz layout: {layout}")

    vis_path = os.path.join(args.out, "orbit.gif")
    cli.main(["visualize", "--params", params_path, "--out", vis_path,
              "--frames", "24", "--width", str(w), "--height", str(h),
              "--radius", "4.0", "--focal", "110"] + dev_flag)
    print(f"[4/4] visualized -> {vis_path}")

    # quality: PSNR of the trained model against its own training views
    eval_out = os.path.join(args.out, "eval.json")
    cli.main(["evaluate", "--params", params_path, "--data_root", data_root,
              "--seq", "demo", "--out", eval_out] + dev_flag)
    with open(eval_out) as f:
        ev = json.load(f)

    summary = {
        "scene_dir": base, "n_scene_files": n_files,
        "params_npz": params_path, "params_layout": layout,
        "visualization": vis_path,
        "eval": {"mean_psnr": ev["mean_psnr"], "mean_ssim": ev["mean_ssim"]},
        "wall_s": round(time.time() - t0, 1),
        "config": cfg,
    }
    artifact = args.artifact or default_out("roundtrip_demo", dev)
    os.makedirs(os.path.dirname(os.path.abspath(artifact)), exist_ok=True)
    with open(artifact, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
