"""How `correct` is decided: the program's first steps against the plain
reference's, from the same seeded inputs.

Three numbers, each with its limit (`limits/<cell>.json`):

  * loss_gap: the largest |loss_program - loss_reference| / |loss_ref|
    over the steps compared;
  * grad_gap: by the worst table, | |g_program| - |g_reference| |
    over max(|g_reference| of that table, the median table's), g the
    first step's gradient as Adam receives it;
  * change_gap: the same for each table's change over the steps
    compared, over the tables whose reference gradient is at least a
    thousandth of the median table's (the others move by round-off
    alone); a table the reference leaves unmoved is measured against
    the median moved table's change.

A number that is not finite reads as infinite: it fails any limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

NOUGHT = 1e-3          # a table's gradient under this share of the median's


def _gap(a: float, b: float, scale: float) -> float:
    if not all(math.isfinite(x) for x in (a, b, scale)) or scale <= 0:
        return math.inf
    return abs(a - b) / scale


def numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    lp, lr = program["losses"], reference["losses"]
    if len(lp) < len(lr):
        return dict(loss_gap=math.inf, grad_gap=math.inf,
                    change_gap=math.inf)
    loss_gap = max(_gap(p, r, abs(r)) for p, r in zip(lp, lr))
    gp, gr = program["grad_norms"], reference["grad_norms"]
    g_med = statistics.median(gr.values())
    grad_gap = max(_gap(gp.get(k, math.nan), gr[k], max(gr[k], g_med))
                   for k in gr)
    cp, cr = program["change_norms"], reference["change_norms"]
    counted = [k for k in cr if gr[k] >= NOUGHT * g_med]
    moved = [cr[k] for k in counted if cr[k] > 0]
    c_med = statistics.median(moved) if moved else 0.0
    change_gap = max(_gap(cp.get(k, math.nan), cr[k], max(cr[k], c_med))
                     for k in counted)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) in the order of `limits`."""
    shown = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(nums[k]) and nums[k] <= limits[k]
             for k in limits)
    return ok, shown
