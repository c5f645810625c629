"""step_mfu: the whole step's share of the card's peak: the larger of the
step's counted float32 operations over the float32 peak and its counted
bytes over the memory peak (the program's `step_counts`, "step", averaged
over the traced steps), over the time per step of the untraced stretch
before the trace, in %."""

from portbench import counts, readers


def read(run):
    peak = readers.card_peaks(run)
    if peak is None or not run.steps:
        return None
    least = [counts.least_seconds(c["step"], peak)
             for c in run.counts(run.trace_cams)]
    return 100.0 * (sum(least) / len(least)) / run.untraced_step_s
