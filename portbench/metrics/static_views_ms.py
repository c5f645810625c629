"""static_views_ms: the device time a replayed step spends on its static
views' own renders, in ms: each static view's emission, sort and composite
and their backward, which run a view at a time (the projection and the
image losses, which the step takes for all its views at once, are not in
it). A mean over a marked stretch of its own (`probe`).

The ego + static step (`train/ego_trainer.py::make_ego_step`), with its
tracing on, launches view marks (`csrc/mark.cu`: `d3g_view_mark<d3g_view::
<view>>`, a kernel the phase marks' reader does not see) inside its phases:
`static_rig` where the first static view's own render begins, after the
ego view's, and `ego` where the backward reaches the ego render's outputs,
after the static views' own backward. So per step, with the phase marks
placed as `spans.py` places them,

  static_rig (render)  -> image_loss       the static views' own renders
  render_bwd           -> ego              their backward

`probe` runs one marked stretch as `spans.probe` does (`spans._stretch`,
its own), reduces it and prints one `portbench: static_views {...}` line
to standard error. Where the step has no view marks (another program, or
a port without them), where a step's view marks are not these two in
this order inside these phases, or on a CPU run, it reads None.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Optional, Sequence, Tuple

from portbench import spans

VIEW = re.compile(r"d3g_view_mark<d3g_view::(\w+)>")
ORDER = ("static_rig", "ego")
KEY = "static_views"


def reduce(ops: Sequence[spans.Interval], window: Tuple[float, float],
           n_steps: int, n_windows: int) -> Optional[float]:
    """ms per step of the static views in `n_steps` replayed steps of
    `n_windows` windows, from the device's ops of a traced stretch (times
    in us); None where a step's phase or view marks are not whole."""
    w0, w1 = window
    w1 = max([w1] + [e for _, e, _ in ops])
    ops = sorted((max(s, w0), min(e, w1), n) for s, e, n in ops
                 if e > w0 and s < w1)
    steps = spans._steps(ops, n_steps, n_windows) if n_steps and n_windows \
        else None
    views = [(s, m.group(1)) for s, _, n in ops
             for m in [VIEW.search(n)] if m]
    if steps is None or len(views) != len(ORDER) * n_steps:
        return None
    total = 0.0
    for b, end, _ in steps:
        mine = [(s, v) for s, v in views if b[0] <= s < end]
        if tuple(v for _, v in mine) != ORDER:
            return None
        rig, ego = (s for s, _ in mine)
        render, image_loss, _, _, _, render_bwd, update = b
        if not (render <= rig < image_loss and render_bwd <= ego < update):
            return None
        total += (image_loss - rig) + (ego - render_bwd)
    return total * 1e-3 / n_steps


def probe(run) -> None:
    """Once a run: a marked stretch reduced into `run.probes`, traced anew
    where it recaptured or its marks are not whole, up to
    `spans.ATTEMPTS` stretches."""
    if KEY in run.probes or run.device.type != "cuda":
        return
    run.probes[KEY] = None
    from dynamic3dgaussians_tpu_torch.utils import logging as LG
    if not hasattr(LG, "view_mark") or run.program.scan is None:
        return
    from portbench.loop import SPANS
    value = None
    for attempt in range(1, spans.ATTEMPTS + 1):
        calls, recaptured, prof = spans._stretch(run, LG)
        ops, _, window = spans.from_profile(spans._events(prof), SPANS)
        if not recaptured and min(calls) > 1:
            value = reduce(ops, window, sum(calls), len(calls))
        if value is not None:
            break
    print("portbench: static_views " + json.dumps(dict(
        static_views_ms=value, attempts=attempt, steps=sum(calls),
        view_marks=sum(1 for _, _, n in ops if VIEW.search(n)))),
        file=sys.stderr, flush=True)
    run.probes[KEY] = value


def read(run) -> Optional[float]:
    return run.probes.get(KEY)
