"""graph_idle_ms: the device's idle time inside a replayed step (from its
`render` mark to its end), less the union of its kernels, copies and fills,
in ms; a mean over the marked stretch of `spans.probe`
(`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "graph_idle_ms")
