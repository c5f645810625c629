"""device_idle.window: the device's idle share of the traced window, in %:
1 - busy / window of the trace (`readers.trace_idle_share`). A window
replays a CUDA graph, so the profiler adds nothing to its length (30.5
ms a traced step against 30.7 untraced, NVIDIA H100 80GB HBM3)."""

from portbench import readers


def read(run):
    return readers.trace_idle_share(run)
