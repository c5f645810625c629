"""Everything the harness knows of a cell, found by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations
and metrics; each name leads to files of its own under `portbench/`:

  configs/<config>.json     the configuration's sizes, as run
  traffic/<traffic>.json    the traffic mix's parameters
  limits/<workload>.json    the limits of the comparison that decides
                            `correct`, with the readings they were set from
  e2e/<metric>.py           an end-to-end metric's reader
  metrics/<metric>.py       a per-layer metric's reader
  programs/<program>.py     the program a configuration names (its key
                            "program", default `panoptic_dynamic`)

A reader is a module with `read(run) -> float or None` (None: nothing to
read in this run, and the metric is left out of the line) and, where it
measures something itself after the traced window, `probe(run)`.

A program module binds one trainer of the port, and its plain reference,
to what the harness, `calibrate.py` and the readers call:

  make(cfg, seed, device) -> inputs       the seeded inputs of both sides
  ProgramRun(inputs, cfg, traffic, seed, device, graph_factory=None)
                                          the program, driven as the
      traffic says: `call()` -> {"steps", "metrics", "cams"}, where
      "cams" are the keys of the steps run; `first_steps(n)` -> {"losses",
      "grad_norms", "change_norms", "cams"}; `window_stats()`; `reports`
      (dicts with "loss"); `timings`; `free()`; `scan` (None where the
      program runs no window)
  first_cams(cfg, traffic, seed)          the keys of the steps that
                                          `first_steps` runs
  follow(inputs, cfg, cams, fault=None)   the plain reference over those
      steps (float32, TF32 off, importing nothing of the port): {"losses",
      "grad_norms", "change_norms"}; `fault` "unchanged" or "half_batch"
      plants a fault, for `calibrate.py`
  walk_stats(inputs, cfg, cams)           per step, the record of its work
      at the seeded start (its renders' pairs and tiles, its rows and
      edges), which only the program's `step_counts` reads
  step_counts(walk, cfg)                  the step's counted {"bytes",
      "flops"}: under a kernel's name ("k1", "k2", "e1", "p1") that
      kernel's over all its launches in the step, under "step" the whole
      step's; the program alone knows which work a step does once and
      which once a render. The rooflines and `step_mfu` divide these by
      device time; a kernel it does not count reads nothing.

So a cell is added by files alone: a configuration (naming its program),
a traffic mix, its limits, and for another trainer its program module
with that program's plain reference beside it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List

PKG = os.path.dirname(os.path.abspath(__file__))
PROGRAMS = os.path.join(PKG, "programs")
DEFAULT_PROGRAM = "panoptic_dynamic"


def root() -> str:
    return os.path.dirname(PKG)


def load_benchmark(base: str = None) -> Dict:
    with open(os.path.join(base or root(), "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts) -> Dict:
    with open(os.path.join(PKG, *parts)) as fh:
        return json.load(fh)


def config(name: str) -> Dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> Dict:
    return _json("traffic", f"{name}.json")


def limits(workload: str) -> Dict:
    return _json("limits", f"{workload}.json")


def _module(path: str, name: str):
    """The module at `path`, run anew and registered under `name`, so that
    what looks itself up by module (a dataclass, a pickle) finds it."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    """The reader module of metric `name` (kind "e2e" or "metrics")."""
    return _module(os.path.join(PKG, kind, f"{name}.py"),
                   f"portbench_{kind}_{name.replace('.', '_')}")


def program(cfg: Dict):
    """The program module that configuration `cfg` names
    (`programs/<program>.py`)."""
    name = cfg.get("program", DEFAULT_PROGRAM)
    path = os.path.join(PROGRAMS, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {cfg.get('name')!r} names program {name!r}: "
            f"no file {path}")
    return _module(path, f"portbench_program_{name}")


def cell(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's metrics: its end-to-end ones, or with `trace` its
    per-layer ones (those listing the cell, or with no list, those whose
    end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]
