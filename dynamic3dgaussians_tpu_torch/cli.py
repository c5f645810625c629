"""Command-line entry points of the port.

  python -m dynamic3dgaussians_tpu_torch.cli visualize \
      --params output/exp1/seq/params.npz [--out orbit.gif] [--device cuda]

`visualize` orbit-renders a stacked params.npz to a GIF, with the flags of
the reference's `visualize` subcommand. It runs on `cuda` unless
`--device` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys


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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dynamic3dgaussians_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

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
                   help="cached-order playback interval (only 1, the exact "
                        "per-frame sort, is ported)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.set_defaults(fn=cmd_visualize)

    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
