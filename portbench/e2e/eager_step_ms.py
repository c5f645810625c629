"""eager_step_ms: the measured window's wall time, ended by a synchronise,
over the training steps it completed (one host call per step)."""


def read(run):
    return run.window_s / run.steps * 1e3 if run.steps else None
