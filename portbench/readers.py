"""What several metric readers share: a kernel's roofline share and the
device's idle share of a trace."""

from __future__ import annotations

import torch

from portbench import counts


def card_peaks(run):
    if run.device.type != "cuda":
        return None
    return counts.peaks(torch.cuda.get_device_name(run.device))


def roofline(run, parts, main: str, kernel: str):
    """100 x the kernel's least time a step (`counts.least_seconds` of the
    program's count of `kernel` a step, averaged over the traced steps) over
    its device time per step; None where the card has no peaks, the
    program counts no such kernel or the trace did not see it run once a
    step."""
    peak = card_peaks(run)
    per_step = run.kernel_time(parts, main)
    if peak is None or not per_step:
        return None
    steps = run.counts(run.trace_cams)
    if not all(kernel in c for c in steps):
        return None
    least = [counts.least_seconds(c[kernel], peak) for c in steps]
    return 100.0 * (sum(least) / len(least)) / per_step


def trace_idle_share(run):
    """100 x (1 - busy / window) of the traced window; None where the trace
    holds no device activity."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def idle_share(run):
    """100 x (1 - the device's busy time per traced step over the step time
    of the untraced stretch before the trace); None where
    the trace holds no device activity. (The traced window's own length
    holds the profiler's cost per launch, which more than doubles a
    host-paced step.)"""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_share())
