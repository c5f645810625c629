"""window_gap_ms: the device's idle time per window outside its replayed
steps: the window's edge (its host read and clones, the next window's
copy-in and the loop's own host work), in ms; a mean over the marked
stretch of `spans.probe` (`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "window_gap_ms")
