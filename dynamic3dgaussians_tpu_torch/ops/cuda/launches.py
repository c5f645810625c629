"""Run counts of the tile kernels K1 and K2, measured on the device, per
variant.

Each wrapper (`raster_fwd.composite_tiles`, `raster_bwd.composite_tiles_bwd`)
adds one to its host count `fn.launches` where it launches its kernel, and
nowhere else (`count_launch`), and one to `fn.launches_by_variant` under the
variant it passes to the C entry point. A CUDA graph replay runs the
captured kernels without the host, so a launch captured in a graph is on
the host counts once, at its capture, however often the graph is replayed.
What ran is counted by the kernel itself: the wrapper passes it device
counters (`counter`, 4 int64 per wrapper and device, one per variant), and
the kernel's first thread adds one with an atomic, each time the kernel
runs, eagerly or in a replay, to the counter of the instantiation that
runs: index FUSED + 2 BF16 of its own template switches. `runs` and
`runs_by_variant` read the counters (a device sync), `zero` sets them to 0
in place: a captured graph keeps their address.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

# the variants by counter index: bit 0 FUSED (power_impl="mxu_fused"),
# bit 1 BF16 (kernel_precision="default")
VARIANTS = ("default", "fused", "bf16", "fused_bf16")


def variant_index(fused: bool, bf16: bool) -> int:
    return int(fused) | int(bf16) << 1


def counter(fn: Callable, device: torch.device) -> torch.Tensor:
    """`fn`'s device counters on `device` (one per variant), made at their
    first use. They must be made before a graph captures the kernel: made
    inside the capture, their zero fill would be a node of the graph, run
    at every replay."""
    counters = fn.__dict__.setdefault("run_counters", {})
    c = counters.get(device)
    if c is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{fn.__name__}'s run counter on {device} does not exist yet; "
                f"launch the kernel once before capturing it in a graph")
        c = counters[device] = torch.zeros((len(VARIANTS),),
                                           dtype=torch.int64, device=device)
    return c


def count_launch(fn: Callable, variant: int) -> None:
    """One host launch of `fn`'s kernel of counter index `variant`."""
    fn.launches += 1
    by = fn.__dict__.setdefault("launches_by_variant", {})
    by[VARIANTS[variant]] = by.get(VARIANTS[variant], 0) + 1


def runs_by_variant(fn: Callable) -> Dict[str, int]:
    """The runs of each instantiation of `fn`'s kernel counted on every
    device since `zero`, by variant name."""
    total = [0] * len(VARIANTS)
    for c in fn.__dict__.get("run_counters", {}).values():
        for i, n in enumerate(c.tolist()):
            total[i] += n
    return dict(zip(VARIANTS, total))


def runs(fn: Callable) -> int:
    """The runs of `fn`'s kernel counted on every device since `zero`."""
    return sum(runs_by_variant(fn).values())


def zero(fn: Callable) -> None:
    """Set `fn`'s host launch counts and its device counters to 0."""
    fn.launches = 0
    fn.launches_by_variant = {}
    for c in fn.__dict__.get("run_counters", {}).values():
        c.zero_()
