"""Readings for the limits of `correct`, at a cell's own size, on the card.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 \
        [--modes control,half_batch,unchanged]

For each seed it makes the cell's inputs and follows the cell's first
steps (the steps the program's set-up would run) with the plain
reference of the cell's program (`manifest.program`) in float32, TF32
off, and then once more per mode, put in the program's place:

  control     the reference with TF32 on (the precision below the
              configuration's float32);
  half_batch  a planted fault: each step's image and segmentation losses
              over half of the rows;
  unchanged   a planted fault: every step leaves the state as it was.

and prints one JSON line per seed and mode with the comparison's numbers
(`check.numbers`) of that run against the float32 one. The program's own
readings come from `portbench.run`, whose standard error shows them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, manifest
from portbench.harness import precision


def readings(workload: str, seed: int, modes, device="cuda"):
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, workload)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    program = manifest.program(cfg)
    dev = torch.device(device)
    with precision(False):
        inputs = program.make(cfg, seed, dev)
        cams = program.first_cams(cfg, traffic, seed)
        truth = program.follow(inputs, cfg, cams)
    for mode in modes:
        t0 = time.perf_counter()
        with precision(mode == "control"):
            other = program.follow(inputs, cfg, cams, fault=(
                None if mode == "control" else mode))
        yield dict(workload=workload, seed=seed, mode=mode,
                   seconds=time.perf_counter() - t0,
                   numbers=check.numbers(other, truth),
                   losses=[other["losses"][:4], truth["losses"][:4]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="control,half_batch,unchanged")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for rec in readings(args.workload, seed, args.modes.split(",")):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
