"""One run of one cell: set-up, the measured or traced window, the
comparison with the plain reference, and the result.

The configuration names the program that runs it (`manifest.program`:
`programs/<program>.py`, by default `panoptic_dynamic`); the harness
reaches the trainer, its seeded inputs and its reference only through
that module, so another trainer comes in as a new program file with no
edit here.

  1. set-up (timed from the process's start): the seeded inputs
     (`program.make`), the program's state and loop
     (`program.ProgramRun`), and the loop's first calls until the
     traffic's `check_min_steps` steps are done, read for the comparison
     (this also warms every shape the window uses: the eager step, and a
     window's capture);
  2. the window: the loop's calls for `--seconds`, ended by a
     synchronise, its time over the steps completed; or, with --trace 1,
     the traffic's `trace_steps` steps timed, as many again under
     `torch.profiler`, and the per-layer readers' probes on the
     program's state;
  3. the device's memory peak is read, the program's state dropped, and
     the plain reference follows the first steps from the same inputs
     (`program.follow`, float32 with TF32 off); the numbers of
     `check.py` against `limits/<workload>.json` decide `correct`.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import time
from typing import Dict, List, Optional

import torch

from portbench import check, manifest
from portbench.loop import SPANS, _sync
from portbench.trace import Trace, run_traced


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions with TF32 on or off; the
    caller's settings put back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Run:
    """What the metric readers see of a run."""

    def __init__(self, cfg: Dict, traffic: Dict, device: torch.device,
                 inputs: Dict, program_module):
        self.cfg, self.traffic = cfg, traffic
        self.device, self.inputs = device, inputs
        self.program_module = program_module
        self.program = None         # the module's ProgramRun, until freed
        self.setup_s = math.nan
        self.window_s = math.nan
        self.untraced_step_s = math.nan
        self.steps = 0
        self.trace: Optional[Trace] = None
        self.trace_cams: List[int] = []
        self.window_stats: Optional[Dict] = None
        self.probes: Dict = {}
        self._counts: Dict[int, Dict] = {}

    def counts(self, cams) -> List[Dict]:
        """Per step, the program's `step_counts` of its work at the seeded
        start (`walk_stats`): each kernel's {"bytes", "flops"} over its
        launches in the step, and the whole step's under "step"; cached by
        the step's key."""
        todo = sorted(set(cams) - set(self._counts))
        if todo:
            mod = self.program_module
            with precision(False):
                walks = mod.walk_stats(self.inputs, self.cfg, todo)
            for c, walk in zip(todo, walks):
                self._counts[c] = mod.step_counts(walk, self.cfg)
        return [self._counts[c] for c in cams]

    def busy_share(self) -> float:
        """The device's busy seconds per traced step over the seconds per
        step of the untraced stretch before the trace."""
        return self.trace.busy_s / self.steps / self.untraced_step_s

    def kernel_time(self, parts, main: str):
        """Device seconds per traced step of the kernels named by `parts`,
        or None where the trace did not see `main` run once a step."""
        s, _ = self.trace.kernels_matching(parts)
        _, n = self.trace.kernels_matching((main,))
        return s / self.steps if n >= self.steps else None


def power_limit() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, graph_factory=None,
             cfg_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None):
    """Run a cell once. Returns (result dict, check lines)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, workload)
    cfg = dict(manifest.config(cell["config"]), **(cfg_override or {}))
    traffic = dict(manifest.traffic(cell["traffic"]),
                   **(traffic_override or {}))
    limits = manifest.limits(workload)["limits"]
    program = manifest.program(cfg)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)

    phases = {"imports_s": time.perf_counter() - t0}
    with precision(False):
        inputs = program.make(cfg, seed, dev)
    _sync(dev)
    phases["inputs_s"] = time.perf_counter() - t0
    run = Run(cfg, traffic, dev, inputs, program)
    prog = run.program = program.ProgramRun(inputs, cfg, traffic, seed, dev,
                                            graph_factory=graph_factory)
    _sync(dev)
    phases["program_s"] = time.perf_counter() - t0
    phases.update(prog.timings)
    first = prog.first_steps(traffic["check_min_steps"])
    _sync(dev)
    run.setup_s = time.perf_counter() - t0

    readers = [(m, manifest.reader("metrics" if trace else "e2e", m["name"]))
               for m in manifest.metrics_of(bench, workload, trace)]
    if trace:
        # the same number of steps untimed by the profiler first: the
        # profiler's own cost per launch stretches a host-paced window
        _sync(dev)
        start, n = time.perf_counter(), 0
        while n < traffic["trace_steps"]:
            n += prog.call()["steps"]
        _sync(dev)
        run.untraced_step_s = (time.perf_counter() - start) / n

        def body():
            while run.steps < traffic["trace_steps"]:
                out = prog.call()
                run.steps += out["steps"]
                run.trace_cams += out["cams"]
        t1 = time.perf_counter()
        run.trace = run_traced(body, dev, SPANS)
        phases["trace_s"] = time.perf_counter() - t1
    else:
        _sync(dev)
        start = mark = time.perf_counter()
        marks, at = [], 0
        while time.perf_counter() - start < seconds:
            run.steps += prog.call()["steps"]
            if time.perf_counter() - mark >= 1.0:
                now = time.perf_counter()
                marks.append((now - mark) / (run.steps - at) * 1e3)
                mark, at = now, run.steps
        _sync(dev)
        run.window_s = time.perf_counter() - start
        phases["ms_per_step_each_second"] = [round(x, 2) for x in marks]
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    run.window_stats = prog.window_stats()
    for _, mod in readers:
        if hasattr(mod, "probe"):
            mod.probe(run)
    failed = sum(1 for r in prog.reports if not math.isfinite(r["loss"]))
    prog.free()
    run.program = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    with precision(False):
        reference = program.follow(inputs, cfg, first["cams"])
    phases["reference_s"] = time.perf_counter() - t1
    correct, shown = check.judge(check.numbers(first, reference), limits)
    metrics = {}
    for m, mod in readers:
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else dev.type),
               "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        devinfo["power"] = power_limit()
    result = {"correct": bool(correct), "attempted": run.steps,
              "failed": failed, "metrics": metrics, "device": devinfo}
    if trace:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": run.trace.top_ops(),
            "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
    result["check"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                           else None, "limit": v["limit"]}
                       for k, v in shown.items()}
    phases["readers_s"] = time.perf_counter() - t1 - phases["reference_s"]
    phases["setup_s"] = run.setup_s
    phases["window_stats"] = run.window_stats
    phases["steps_compared"] = len(reference["losses"])
    lines = ["portbench: " + json.dumps(phases),
             "portbench: program " + json.dumps(first),
             "portbench: reference " + json.dumps(reference)]
    lines += [f"{k} {v['value']:.6g} limit {v['limit']:.6g}"
              for k, v in shown.items()]
    return result, lines
