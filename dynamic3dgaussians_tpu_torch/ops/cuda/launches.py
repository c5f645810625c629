"""Run counts of the tile kernels K1 and K2, measured on the device.

Each wrapper (`raster_fwd.composite_tiles`, `raster_bwd.composite_tiles_bwd`)
adds one to its host count `fn.launches` where it launches its kernel, and
nowhere else. A CUDA graph replay runs the captured kernels without the
host, so a launch captured in a graph is on the host count once, at its
capture, however often the graph is replayed. What ran is counted by the
kernel itself: the wrapper passes it a device counter (`counter`, one int64
per wrapper and device), to which the kernel's first thread adds one with an
atomic each time the kernel runs, eagerly or in a replay. `runs` reads the
counters (a device sync), `zero` sets them to 0 in place: a captured graph
keeps their address.
"""

from __future__ import annotations

from typing import Callable

import torch


def counter(fn: Callable, device: torch.device) -> torch.Tensor:
    """`fn`'s device counter on `device`, made at its first use. It must be
    made before a graph captures the kernel: made inside the capture, its
    zero fill would be a node of the graph, run at every replay."""
    counters = fn.__dict__.setdefault("run_counters", {})
    c = counters.get(device)
    if c is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{fn.__name__}'s run counter on {device} does not exist yet; "
                f"launch the kernel once before capturing it in a graph")
        c = counters[device] = torch.zeros((), dtype=torch.int64,
                                           device=device)
    return c


def runs(fn: Callable) -> int:
    """The runs of `fn`'s kernel counted on every device since `zero`."""
    return sum(int(c) for c in fn.__dict__.get("run_counters", {}).values())


def zero(fn: Callable) -> None:
    """Set `fn`'s host launch count and its device counters to 0."""
    fn.launches = 0
    for c in fn.__dict__.get("run_counters", {}).values():
        c.zero_()
