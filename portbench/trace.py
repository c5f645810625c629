"""A `torch.profiler` trace of part of a run, reduced to what the
per-layer metrics read: the traced window's length, the device's busy
time (the union of its kernels, copies and fills), device time and runs
by kernel name, the host's kernel launches and synchronising calls, and
the device's longest idle gaps, each labelled with the benchmark's span
the host spent most of it in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
WINDOW_SPAN = "traced_window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    kernel_runs: Dict[str, int]
    launches: int
    syncs: int
    gaps: List[Tuple[str, float]]      # the longest idle gaps, labelled

    def kernels_matching(self, parts) -> Tuple[float, int]:
        """(device seconds, runs) of the kernels whose name holds one of
        `parts`."""
        s = n = 0
        for name, t in self.kernel_s.items():
            if any(p in name for p in parts):
                s += t
                n += self.kernel_runs[name]
        return s, n

    def top_ops(self) -> List[List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:96], t] for name, t in top]


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def run_traced(fn: Callable[[], None], device: torch.device,
               span_names) -> Trace:
    """Trace `fn` (which runs the window's calls) and reduce the trace."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return reduce(prof.events(), span_names)


def reduce(events, span_names) -> Trace:
    from torch.autograd import DeviceType
    window = None
    dev, host_spans = [], []
    kernel_s: Dict[str, float] = {}
    kernel_runs: Dict[str, int] = {}
    launches = syncs = 0
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the host's record_function spans mirrored on the device
            if getattr(e, "is_user_annotation", False) or \
                    e.name in span_names or e.name == WINDOW_SPAN:
                continue
            dev.append((s, t))
            kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (t - s) * 1e-6
            kernel_runs[e.name] = kernel_runs.get(e.name, 0) + 1
        elif e.name == WINDOW_SPAN:
            window = (s, t)
        elif e.name in span_names:
            host_spans.append((s, t, e.name))
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif e.name in SYNC_CALLS:
            syncs += 1
    if window is None:
        raise RuntimeError("the trace lost its window span")
    w0, w1 = window
    busy = [(max(s, w0), min(t, w1)) for s, t in dev if t > w0 and s < w1]
    merged = _union(busy)
    busy_us = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in gaps[:TOP]:
        best, name = 0.0, "no_span"
        for hs, he, hn in host_spans:
            ov = min(e, he) - max(s, hs)
            if ov > best:
                best, name = ov, hn
        labelled.append((name, (e - s) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 kernel_s=kernel_s, kernel_runs=kernel_runs,
                 launches=launches, syncs=syncs,
                 gaps=labelled)
