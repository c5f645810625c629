"""The program's own phase marks and host spans in a profile of replayed
training windows, reduced to the time of each phase of a step, the idle
time inside the steps and at the windows' edges.

With its tracing on (`utils/logging.py::set_tracing`) the port launches an
empty marker kernel where each phase of a train step begins (`PHASES`,
`csrc/mark.cu`, named `d3g_mark<d3g_phase::<phase>>`); a CUDA graph
captures the marks and replays them with the step. Its host spans
(`PROGRAM_SPANS`) say what the host did: `window.load`, `window.replay`,
`window.read`, `window.result`, ...

`probe(run)`, shared by the readers of `metrics/render_ms.py`,
`image_loss_ms.py`, `physics_step_ms.py`, `update_ms.py`,
`graph_idle_ms.py` and `window_gap_ms.py`, runs once a run: it turns the
tracing on, runs one untraced window (which captures the marked step),
profiles the traffic's `trace_steps` steps of the loop's calls with CPU and
CUDA activities, turns the tracing off and reduces (`reduce`). It prints
one `portbench: spans {...}` line to standard error. On a CPU run, or on a
program without tracing, it does nothing, and the readers read None.

`reduce` places each step by its seven marks; a step ends at the next
step's `render` mark or, where the window's host read (its device-to-host
copy) comes first, at the end of its last device op before that copy. Per
step (means over the traced replayed steps, so that they add up):

  render_ms        render -> image_loss, plus render_bwd -> update
  image_loss_ms    image_loss -> physics, plus image_loss_bwd -> render_bwd
  physics_step_ms  physics -> image_loss_bwd (forward, weighted sum, backward)
  update_ms        update -> the step's end
  graph_idle_ms    the device's idle time inside the step: its length less
                   the union of the device's kernels, copies and fills

and per window `window_gap_ms`, the idle time of the traced stretch outside
its steps: the window's edge. The four phases sum to the step's device
time, and graph_idle_ms x steps + window_gap_ms x windows is the stretch's
idle time. Where a step's marks are incomplete or out of order, or the
steps or windows found are not those run, `reduce` returns None.
"""

from __future__ import annotations

import bisect
import json
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.trace import _union

PHASES = ("render", "image_loss", "physics", "physics_bwd", "image_loss_bwd",
          "render_bwd", "update")
METRICS = {"render_ms": ("render", "render_bwd"),
           "image_loss_ms": ("image_loss", "image_loss_bwd"),
           "physics_step_ms": ("physics", "physics_bwd"),
           "update_ms": ("update",)}
PROGRAM_SPANS = PHASES + ("window.load", "window.eager", "window.capture",
                          "window.replay", "window.read", "window.result",
                          "emit.count_read")
MARK = re.compile(r"d3g_mark<d3g_phase::(\w+)>")
READ = "DtoH"              # the window's one host read, a device-to-host copy
WINDOW = "spans_window"
KEY = "spans"
# a stretch is traced anew where it recaptured or its profile lost the
# records of its last steps (about one stretch in seven on the card)
ATTEMPTS = 4
TOP_OPS, TOP_GAPS = 5, 10

Interval = Tuple[float, float, str]       # (start us, end us, name)


class Busy:
    """The union of the device's ops, and its covered length in a range."""

    def __init__(self, ops: Sequence[Interval]):
        self.merged = _union((s, e) for s, e, _ in ops)
        self.starts = [s for s, _ in self.merged]
        self.before = [0.0]                 # covered length before each run
        for s, e in self.merged:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.merged[i - 1]
        return self.before[i - 1] + min(e, t) - s

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a) if b > a else 0.0

    def gaps(self, a: float, b: float) -> List[Tuple[float, float]]:
        edges = [a] + [min(max(x, a), b) for iv in self.merged
                       for x in iv] + [b]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]


def _steps(ops: Sequence[Interval], n_steps: int, n_windows: int):
    """[(the seven mark starts, step end, ends a window?)] or None."""
    marks = [(s, m.group(1)) for s, _, n in ops
             for m in [MARK.search(n)] if m]
    if len(marks) != 7 * n_steps:
        return None
    starts = []
    for i in range(0, len(marks), 7):
        if tuple(p for _, p in marks[i:i + 7]) != PHASES:
            return None
        starts.append([s for s, _ in marks[i:i + 7]])
    reads = sorted(s for s, _, n in ops if READ in n)
    op_starts = [s for s, _, _ in ops]
    steps = []
    for k, b in enumerate(starts):
        nxt = starts[k + 1][0] if k + 1 < len(starts) else float("inf")
        r = bisect.bisect_right(reads, b[6])
        read = reads[r] if r < len(reads) else float("inf")
        if read < nxt or k + 1 == len(starts):
            hi = bisect.bisect_left(op_starts, read)
            lo = bisect.bisect_left(op_starts, b[6])
            steps.append((b, max(e for _, e, _ in ops[lo:hi]), True))
        else:
            steps.append((b, nxt, False))
    if sum(w for _, _, w in steps) != n_windows:
        return None
    return steps


def _label(gap, spans, names) -> Optional[str]:
    """The span of `names` that overlaps the gap most; on a tie the shorter
    (the innermost where spans nest)."""
    best = None
    for s, e, n in spans:
        if n in names:
            ov = min(gap[1], e) - max(gap[0], s)
            if ov > 0:
                key = (ov, -(e - s))
                if best is None or key > best[0]:
                    best = (key, n)
    return best and best[1]


def reduce(ops: Sequence[Interval], spans: Sequence[Interval],
           window: Tuple[float, float], n_steps: int, n_windows: int,
           bench_spans: Sequence[str] = ()) -> Optional[Dict]:
    """The phases of `n_steps` replayed steps in `n_windows` windows from
    the device's ops and the host's spans of a traced stretch `window`
    (times in us). Returns {"metrics": the six metrics in ms, "line": the
    breakdown}, or None (see the module's note)."""
    w0, w1 = window
    # the profile begins and ends with the device synchronised, so every
    # device op in it is the stretch's; but the device's clock, converted
    # to the host's, can read some ms past the host's end of the stretch
    # (cutting the last step's marks): the stretch ends at its last op
    w1 = max([w1] + [e for _, e, _ in ops])
    ops = sorted((max(s, w0), min(e, w1), n) for s, e, n in ops
                 if e > w0 and s < w1)
    steps = _steps(ops, n_steps, n_windows) if n_steps and n_windows \
        else None
    if steps is None:
        return None
    busy = Busy(ops)
    # phase boundaries in time order: (start, phase), a step's end as None
    bounds: List[Tuple[float, Optional[str]]] = []
    length = dict.fromkeys(PHASES, 0.0)
    idle = dict.fromkeys(PHASES, 0.0)
    step_us = step_idle = 0.0
    for b, end, _ in steps:
        edges = b + [end]
        for i, p in enumerate(PHASES):
            length[p] += edges[i + 1] - edges[i]
            idle[p] += edges[i + 1] - edges[i] - busy.within(edges[i],
                                                             edges[i + 1])
            bounds.append((edges[i], p))
        bounds.append((end, None))
        step_us += end - b[0]
        step_idle += end - b[0] - busy.within(b[0], end)
    at = [t for t, _ in bounds]

    def phase_at(t):
        i = bisect.bisect_right(at, t) - 1
        return bounds[i][1] if i >= 0 else None

    by_phase: Dict[str, Dict[str, float]] = {p: {} for p in PHASES}
    for s, e, n in ops:
        p = phase_at(s)
        if p is not None and not MARK.search(n):
            by_phase[p][n] = by_phase[p].get(n, 0.0) + e - s
    total_idle = (w1 - w0) - busy.within(w0, w1)
    ms = 1e-3 / n_steps
    metrics = {name: sum(length[p] for p in parts) * ms
               for name, parts in METRICS.items()}
    metrics["graph_idle_ms"] = step_idle * ms
    metrics["window_gap_ms"] = (total_idle - step_idle) * 1e-3 / n_windows
    gaps = sorted(busy.gaps(w0, w1), key=lambda g: g[0] - g[1])[:TOP_GAPS]
    line = {
        "steps": n_steps, "windows": n_windows,
        "step_ms": step_us * ms,
        "stretch_ms_per_step": (w1 - w0) * ms,
        "idle_share": 100.0 * total_idle / (w1 - w0),
        "phases": {p: {"busy_ms": (length[p] - idle[p]) * ms,
                       "idle_ms": idle[p] * ms} for p in PHASES},
        "top_ops": {p: [[n[:72], t * ms] for n, t in sorted(
            by_phase[p].items(), key=lambda kv: -kv[1])[:TOP_OPS]]
            for p in PHASES},
        "gaps": [[_label(g, spans, PROGRAM_SPANS)
                  or _label(g, spans, bench_spans) or "no_span",
                  phase_at(g[0]) or "edge", (g[1] - g[0]) * 1e-3]
                 for g in gaps],
    }
    return {"metrics": metrics, "line": line}


def _events(prof):
    """(name, on the device?, start us, end us, a record_function range?)
    of each event of a profile, from the profiler's raw Kineto events
    (building `prof.events()` would take ~30 s for 100 steps), times
    relative to the trace's start so that float64 keeps the ns."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    for e in raw.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3,
               e.is_user_annotation())


def from_profile(events, bench_spans: Sequence[str]):
    """(device ops, host spans, the stretch) of `_events`."""
    named = set(PROGRAM_SPANS) | set(bench_spans) | {WINDOW}
    ops, spans, window = [], [], None
    for name, on_device, s, t, annotation in events:
        if on_device:
            # the host's record_function ranges mirrored on the device
            if annotation or name in named:
                continue
            ops.append((s, t, name))
        elif name == WINDOW:
            window = (s, t)
        elif name in named:
            spans.append((s, t, name))
    return ops, spans, window


def _stretch(run, LG):
    """One marked stretch: tracing on, one untraced window (it captures the
    marks), then `trace_steps` steps profiled. Returns (the calls' step
    counts, the captures made inside the profile, the profile)."""
    prog = run.program
    calls: List[int] = []
    LG.set_tracing(True)
    try:
        while prog.call()["steps"] == 1:
            pass
        captures = prog.window_stats()["captures"]
        torch.cuda.synchronize(run.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                while sum(calls) < run.traffic["trace_steps"]:
                    calls.append(prog.call()["steps"])
                torch.cuda.synchronize(run.device)
    finally:
        LG.set_tracing(False)
    return calls, prog.window_stats()["captures"] - captures, prof


def probe(run) -> None:
    """Once a run: the traced stretch of marked windows, reduced, in
    `run.probes["spans"]` (None where there is nothing to read). A stretch
    in which a window was captured again (a redo at a larger pair
    capacity), or whose marks are not whole, is traced anew, up to
    ATTEMPTS stretches."""
    if KEY in run.probes or run.device.type != "cuda":
        return
    run.probes[KEY] = None
    from dynamic3dgaussians_tpu_torch.utils import logging as LG
    if not hasattr(LG, "set_tracing") or run.program.scan is None:
        return
    from portbench.loop import SPANS
    t0 = time.perf_counter()
    for attempt in range(1, ATTEMPTS + 1):
        calls, recaptured, prof = _stretch(run, LG)
        t1 = time.perf_counter()
        ops, spans, window = from_profile(_events(prof), SPANS)
        out = None
        if not recaptured and min(calls) > 1:
            out = reduce(ops, spans, window, sum(calls), len(calls), SPANS)
        if out:
            break
    line = out["line"] if out else {
        "error": "no complete marked steps", "calls": calls,
        "recaptured": recaptured, "device_ops": len(ops),
        "marks": sum(1 for _, _, n in ops if MARK.search(n)),
        "reads": sum(1 for _, _, n in ops if READ in n)}
    line.update(attempts=attempt, untraced_step_ms=run.untraced_step_s * 1e3,
                run_s=t1 - t0, reduce_s=time.perf_counter() - t1)
    print("portbench: spans " + json.dumps(line), file=sys.stderr,
          flush=True)
    run.probes[KEY] = out and out["metrics"]


def read(run, name: str) -> Optional[float]:
    got = run.probes.get(KEY)
    return None if got is None else got[name]
