"""update_ms: the device time of the update of a replayed step: from the
`update` mark (dead-row mask, Adam, densification statistics, metrics, the
window's write-back, history row and next batch gather) to the next step's
`render` mark, or for a window's last step to its last device op, in ms; a
mean over the marked stretch of `spans.probe` (`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "update_ms")
