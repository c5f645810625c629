#!/usr/bin/env python3
"""An earlier commit against this checkout, in turns, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/parent
    python3 compare_turns.py build/parent [--out build/turns]

Runs, in the order parent, change, change, parent, in each checkout (its
own `chip_smoke.py`, kernels and package):

  * `chip_smoke.py`'s `phase_emit` (E1 against its plain version on its
    four tables) and `phase_window_main_path` (10 steps of the bench
    training eagerly and as one window, at t = 0 and t > 0);
  * `e1_alone`: E1's kernel alone on the bench view (K = 8) and the
    K = 64 training table, timed the same way on both sides, both as a
    host-issued loop and as calls replayed from one CUDA graph;
  * this checkout's `profile_frame.py --reps 5` (the frame's and the
    train steps' stages). Where the checkout's E1 writes K slots per
    gaussian, its emission stages are `kslot_emission_stages`: the
    compaction that ran after that E1 is timed apart under the same names.

Each turn's output goes to `<out>/turn_<i>_<side>.log` and
`<out>/pf_<i>_<side>.log`; the card's nvidia-smi line is printed before
and after. Step medians vary 14-23 % between calls, so two versions are
compared only within one run of this script. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TURNS = ("parent", "change", "change", "parent")
TURN_S = 600
E1_TABLES = ("bench", "train_k64")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout


def graph_ms(fn, reps):
    """Device ms per call of `fn`, `reps` calls captured in one CUDA graph
    and replayed (no host issue time between the calls). `chip_smoke.py`'s
    `graph_ms`, kept here because an earlier checkout's may lack it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / reps


def kslot_form() -> bool:
    """Whether the checkout's E1 writes K slots per gaussian (the form
    before the live pairs were emitted compacted)."""
    from dynamic3dgaussians_tpu_torch.ops import binning
    return not hasattr(binning, "compact_pairs")


def e1_alone(scene, dev, card):
    """E1's kernel alone on its prepared inputs, the K-slot form writing
    its K*N keys, the compacted form its live pairs, on E1_TABLES: ms per
    call of a host-issued loop (`host_ms`) and of calls replayed from one
    CUDA graph (`graph_ms`)."""
    import torch

    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch.ops.cuda import emit as e1
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import cuda_ms
    tables = cs.emit_tables(scene, dev)
    kslot = kslot_form()
    for name in E1_TABLES:
        t = tables[name]
        cam, proj, op, k = t["cam"], t["proj"], t["op"], t["k"]
        grid_h, grid_w = -(-cam.height // cs.TILE), -(-cam.width // cs.TILE)
        enum_cap = max(16, 2 * k)
        kin = e1.kernel_inputs(proj, cs.TILE, cs.TILE, grid_h, grid_w, k, op,
                               enum_cap)
        with torch.no_grad():
            if kslot:
                out = torch.empty((k * kin["n"],), dtype=torch.int32,
                                  device=dev)
                drops = torch.zeros((), dtype=torch.int32, device=dev)

                def call():
                    e1.launch(kin, out, drops)
            else:
                n_live = e1.launch(kin).tile.shape[0]

                def call():
                    e1.launch(kin, n_live)
            host_ms, _ = cuda_ms(call, cs.EMIT_REPS, warmup=2)
            replay_ms = graph_ms(call, cs.EMIT_REPS)
        print(json.dumps(dict(phase="e1_alone", table=name, k_slots=k,
                              enum_cap=enum_cap, n=kin["n"],
                              form="kslot" if kslot else "compacted",
                              host_ms=host_ms, graph_ms=replay_ms,
                              reps=cs.EMIT_REPS, card=card)), flush=True)
        del kin, t
    del tables
    torch.cuda.empty_cache()


def kslot_emission_stages(proj, op, h, w, k_slots, enum_cap):
    """`profile_frame.emission_stages` for a K-slot E1: emit is E1 and its
    wrapper; compact the `nonzero` and gathers of the live slots that the
    eager record table ran before its sort; emit_static E1 and the
    cumulative sum and scatter of the window's static table; emit_plain
    the plain K-slot emission."""
    import torch

    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch.ops import binning
    from dynamic3dgaussians_tpu_torch.ops.cuda.emit import emit_pairs_cuda
    from dynamic3dgaussians_tpu_torch.train.step_graph import pair_capacity
    timed = sys.modules["profile_frame"].timed
    grid_h, grid_w = -(-h // cs.TILE), -(-w // cs.TILE)
    num_tiles = grid_h * grid_w
    args = (proj, cs.TILE, cs.TILE, grid_h, grid_w, k_slots)
    kw = dict(opacity=op, enum_cap=enum_cap)
    n_slots = k_slots * proj.depth.shape[0]
    out = {}
    (key, gid, _), out["emit"] = timed(lambda: emit_pairs_cuda(*args, **kw))

    def compact():
        live = torch.nonzero(key < num_tiles).squeeze(1)
        return key[live], gid[live]

    (lt, _), out["compact"] = timed(compact)
    n_live = lt.shape[0]
    cap = pair_capacity(n_live, n_slots)

    def static():
        i64 = torch.int64
        live = key < num_tiles
        pos = torch.cumsum(live, 0, dtype=i64) - 1
        n = pos[-1] + 1
        col = torch.where(live, pos, n + torch.arange(
            n_slots, dtype=i64, device=key.device) - pos - 1)
        col = torch.where(col < cap, col, torch.full_like(col, cap))
        src = torch.empty((cap + 1,), dtype=i64, device=key.device)
        src[col] = torch.arange(n_slots, dtype=i64, device=key.device)
        src = src[:cap]
        return key[src], gid[src]

    _, static_ms = timed(static)
    out["emit_static"] = out["emit"] + static_ms
    _, out["emit_plain"] = timed(lambda: binning.emit_pairs(*args, **kw))
    out["emit_compact"] = out["emit"] + out["compact"]
    out["live_pairs"] = n_live
    return out


def turn() -> int:
    """One turn in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch import _build
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import smi_line
    _build.build()
    _build.load_library()
    card = smi_line()
    dev = torch.device("cuda")
    scene = cs.bench_scene()
    t0 = time.perf_counter()
    cs.phase_emit(scene, dev, card)
    print(json.dumps(dict(turn=os.getcwd(),
                          phase_emit_s=time.perf_counter() - t0)),
          flush=True)
    e1_alone(scene, dev, card)
    cs.phase_window_main_path(scene, dev, card)
    return 0


def profile() -> int:
    """This checkout's `profile_frame.py --reps 5` on the checkout that is
    the working directory."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("profile_frame",
                                                  REPO / "profile_frame.py")
    pf = importlib.util.module_from_spec(spec)
    sys.modules["profile_frame"] = pf
    spec.loader.exec_module(pf)
    if kslot_form():
        pf.emission_stages = kslot_emission_stages
    return pf.main(["--reps", "5"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?", help="the earlier checkout")
    ap.add_argument("--out", default="build/turns")
    ap.add_argument("--turn", action="store_true",
                    help="run one turn in the working directory")
    ap.add_argument("--profile", action="store_true",
                    help="run profile_frame.py on the working directory")
    args = ap.parse_args(argv)
    if args.turn:
        return turn()
    if args.profile:
        return profile()
    if not args.parent:
        ap.error("the parent checkout is required")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    dirs = {"parent": Path(args.parent).resolve(), "change": REPO}
    print(smi(), end="", flush=True)
    rc = 0
    for i, side in enumerate(TURNS, 1):
        for name, flag in (("turn", "--turn"), ("pf", "--profile")):
            with open(out / f"{name}_{i}_{side}.log", "w") as log, \
                    open(out / f"{name}_{i}_{side}.err", "w") as err:
                r = subprocess.run(
                    [sys.executable, str(REPO / "compare_turns.py"), flag],
                    cwd=dirs[side], stdout=log, stderr=err,
                    timeout=TURN_S).returncode
            print(f"{name} {i} {side} rc={r}", flush=True)
            rc = rc or r
    print(smi(), end="", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
