"""Everything the harness knows of a cell, found by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations
and metrics; each name leads to files of its own under `portbench/`:

  configs/<config>.json     the configuration's sizes, as run
  traffic/<traffic>.json    the traffic mix's parameters
  limits/<workload>.json    the limits of the comparison that decides
                            `correct`, with the readings they were set from
  e2e/<metric>.py           an end-to-end metric's reader
  metrics/<metric>.py       a per-layer metric's reader

A reader is a module with `read(run) -> float or None` (None: nothing to
read in this run, and the metric is left out of the line) and, where it
measures something itself after the traced window, `probe(run)`.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

PKG = os.path.dirname(os.path.abspath(__file__))


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


def reader(kind: str, name: str):
    """The reader module of metric `name` (kind "e2e" or "metrics")."""
    path = os.path.join(PKG, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
